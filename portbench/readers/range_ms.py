"""Device milliseconds per call of every operation launched inside one
layer's profiler range (``pb.<name>``)."""


def read(ctx, state, tr, name):
    calls = tr["range_calls"].get(name, 0)
    dev = tr["range_dev_s"].get(name, 0.0)
    return 1e3 * dev / calls if calls and dev > 0 else None
