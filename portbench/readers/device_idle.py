"""Share of a unit's time in which no device operation ran (%): the device
busy time per profiled unit (the union of the operations' intervals) against
the host-clock time per unit of the traced run's window, which runs without
the profiler, so that the profiler's own host cost is not counted as idle."""


def read(ctx, state, tr):
    if tr["busy_s"] <= 0 or not tr["units"] or tr["unit_wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["units"] / tr["unit_wall_s"])
