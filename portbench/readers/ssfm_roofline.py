"""The SSFM's least time (``counts/ssfm.py``: its FFTs against the chip's
float32 peak, or its field once in and out against HBM) as a share of the
device time of every operation launched inside the ``pb.ssfm`` range (%)."""

from harness import core


def read(ctx, state, tr):
    calls = tr["range_calls"].get("ssfm", 0)
    device_s = tr["range_dev_s"].get("ssfm", 0.0)
    if not calls or device_s <= 0:
        return None
    ssfm = core.counts("ssfm")
    fib, t = ctx.cfg["fiber"], ctx.cfg["tx"]
    flops, nbytes = ssfm.manakov(t["nSymbols"] * t["SpS"], ssfm.link_steps(fib))
    bound, _ = core.counts("peaks").bound_s(flops, nbytes)
    return 100.0 * bound * calls / device_s
