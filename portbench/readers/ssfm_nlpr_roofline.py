"""The adaptive-step SSFM's least time (``counts/ssfm_nlpr.py``, with the
steps and trapezoidal passes a call ran, from the program's counters
``ssfm.calls``, ``ssfm.steps`` and ``ssfm.trap_iters``) as a share of the
device time of every operation launched inside the ``pb.ssfm`` range (%).
None where the program has no such counters or there is no device trace."""

from harness import core


def read(ctx, state, tr):
    calls = tr["range_calls"].get("ssfm", 0)
    device_s = tr["range_dev_s"].get("ssfm", 0.0)
    try:
        from opticommpy_torch.utils.profiling import counts
    except ImportError:
        return None
    c = counts()
    n_calls = c.get("ssfm.calls")
    if not calls or device_s <= 0 or not n_calls or not {"ssfm.steps", "ssfm.trap_iters"} <= set(c):
        return None
    t = ctx.cfg["tx"]
    flops, nbytes = core.counts("ssfm_nlpr").manakov_nlpr(
        t["nSymbols"] * t["SpS"], c["ssfm.steps"] / n_calls, c["ssfm.trap_iters"] / n_calls)
    bound, _ = core.counts("peaks").bound_s(flops, nbytes)
    return 100.0 * bound * calls / device_s
