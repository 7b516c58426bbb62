"""Mean host-clock milliseconds of one layer's span (``ctx.spans(name)`` in
the mix) over the traced run's window, where the device is synchronized
at each boundary of a span."""


def read(ctx, state, tr, name):
    times = tr["spans"].get(name)
    return 1e3 * sum(times) / len(times) if times else None
