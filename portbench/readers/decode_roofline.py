"""The decode's least time (``counts/ldpc.py``, with the iterations that the
reference decoder runs on each profiled batch's LLRs) as a share of the
device time of every operation launched inside the ``pb.decode`` range (%)."""

from harness import core


def read(ctx, state, tr):
    device_s = tr["range_dev_s"].get("decode", 0.0)
    iters = getattr(state, "ref_iters", None)
    if device_s <= 0 or not iters:
        return None
    order = state.order[-tr["units"]:]
    if any(p not in iters for p in order):
        return None
    per = [int(i) for p in order for i in iters[p].tolist()]
    ops, nbytes = core.counts("ldpc").decode(len(state.code["rows"]), state.code["n"], per)
    bound, _ = core.counts("peaks").bound_s(ops, nbytes)
    return 100.0 * bound / device_s
