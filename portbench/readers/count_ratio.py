"""The ratio of two of the program's counters
(``opticommpy_torch.utils.profiling.counts``), which count only while a
profiler records: over the traced run's profiled units. None where the
program has no such counters or the denominator is 0."""


def read(ctx, state, tr, num, den):
    try:
        from opticommpy_torch.utils.profiling import counts
    except ImportError:
        return None
    c = counts()
    if num not in c or not c.get(den):
        return None
    return c[num] / c[den]
