"""Device milliseconds per profiled unit of the operations whose name holds
``part``."""


def read(ctx, state, tr, part):
    s = sum(v for k, v in tr["kernel_s"].items() if part in k)
    return 1e3 * s / tr["units"] if s > 0 and tr["units"] else None
