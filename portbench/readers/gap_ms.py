"""Device-idle milliseconds per unit while the host was inside one of the
program's ranges ``pb.<name>`` (or their children ``pb.<name>.…``), for
each of ``names``.

The profiled units' gaps (``idle_gaps``, by the innermost range the host
was in) are stretched by the profiler's own host cost, so each stage is
given its share of the profiled idle time (``window_s - busy_s``) of the
true idle time per unit (``unit_wall_s - busy_s / units``, as
``device_idle`` reads it): the stages add up to no more than that. None
where the program has none of the ranges, where there is no device trace,
or where the gap list was cut at its 10 largest (a stage may be missing)."""


def read(ctx, state, tr, *names):
    prefixes = tuple("pb." + n for n in names)

    def mine(label):
        return any(label == p or label.startswith(p + ".") for p in prefixes)

    gaps = tr["idle_gaps"]
    if (tr["busy_s"] <= 0 or not tr["units"] or len(gaps) >= 10
            or not any(mine("pb." + r) for r in tr["range_calls"])):
        return None
    idle = tr["window_s"] - tr["busy_s"]
    true_idle = max(0.0, tr["unit_wall_s"] - tr["busy_s"] / tr["units"])
    if idle <= 0:
        return 0.0
    return 1e3 * sum(v for label, v in gaps if mine(label)) / idle * true_idle
