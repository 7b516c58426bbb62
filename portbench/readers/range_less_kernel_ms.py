"""Device milliseconds per call of one layer's range (``pb.<name>``) less
the device time of the operations whose name holds ``part``: the work the
layer launches around that kernel. The kernel is taken by its name over
the profiled window, so a metric reads it in a cell that launches it only
inside the range. None where either has no device time."""


def read(ctx, state, tr, name, part):
    calls = tr["range_calls"].get(name, 0)
    dev = tr["range_dev_s"].get(name, 0.0)
    kernel = sum(v for k, v in tr["kernel_s"].items() if part in k)
    if not calls or dev <= 0 or kernel <= 0:
        return None
    return 1e3 * (dev - kernel) / calls
