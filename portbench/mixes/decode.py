"""Closed-loop LDPC decoding of a pool of LLR batches.

Set-up draws ``pool`` batches of ``batch`` codewords of the configuration's
code: random information bits from the run's seed, encoded by the
reference encoder, BPSK over AWGN at ``esn0_db``, channel LLRs ``2 y /
sigma^2``. One unit is one call of the program's ``decode_ldpc`` on a
batch, the batches taken in turn.

Correctness, once the window has closed: every pool batch's output of its
last call against the reference decoder on the same LLRs:

- ``cw_mismatch``: codewords whose hard decisions differ from the
  reference's, among those the reference decodes to a valid codeword;
- ``llr_gap_med``, ``llr_gap_max``: the median and the largest, over those
  codewords, of ``||L - L_ref|| / ||L_ref||`` of the output LLRs.
"""

import numpy as np
import torch


class State:
    pass


def _ref(ctx):
    from harness import core

    return core.reference(ctx.cfg["name"])


def setup(ctx):
    from opticommpy_torch.comm.fec import LDPCConfig, standard_ldpc

    ref = _ref(ctx)
    code, trf = ctx.cfg["code"], ctx.traffic
    st = State()
    st.code = ref.code()
    st.graph, _ = standard_ldpc("DVBS2", code["n"], code["rate"])
    dec = ctx.cfg["decoder"]
    st.ldpc = LDPCConfig(maxIter=dec["maxIter"], alg=dec["alg"], msgDtype=dec["msgDtype"],
                         earlyExit=dec["earlyExit"], clipLLR=dec["clipLLR"])
    st.llrs = []
    sigma = float(np.sqrt(0.5 * 10 ** (-trf["esn0_db"] / 10)))
    for p in range(trf["pool"]):
        g = torch.Generator(device=ctx.device).manual_seed(ctx.seed_for("pool", p))
        info = torch.randint(0, 2, (st.code["k"], trf["batch"]), generator=g, device=ctx.device)
        cw = ref.encode(info, st.code)
        y = (1 - 2 * cw.float()) + sigma * torch.randn(cw.shape, generator=g, device=ctx.device)
        st.llrs.append(2 * y / sigma ** 2)
    st.out = [None] * trf["pool"]
    st.order = []  # the pool batch of every unit
    st.i = 0
    return st


def decode(ctx, st, p):
    from opticommpy_torch.comm.fec import decode_ldpc

    with ctx.spans("decode"):
        bits, llr, fail = decode_ldpc(st.llrs[p], config=st.ldpc, graph=st.graph)
    return bits, llr, fail


def step(ctx, st):
    p = st.i % len(st.llrs)
    st.out[p] = decode(ctx, st, p)
    if st.llrs[p].is_cuda:
        torch.cuda.synchronize()
    st.order.append(p)
    st.i += 1


def warmup(ctx, st):
    for p in range(min(2, len(st.llrs))):
        decode(ctx, st, p)


def results(ctx, st, n_units, elapsed):
    k = ctx.cfg["code"]["k"]
    return {"info_mbit_s": n_units * ctx.traffic["batch"] * k / elapsed / 1e6}


def work(ctx, st):
    return st.i * ctx.traffic["batch"], 0


def release(ctx, st):
    pass


def reference_outputs(ctx, st, msg=None):
    """The reference decoder on every pool batch that the window decoded."""
    ref = _ref(ctx)
    dec = ctx.cfg["decoder"]
    out = {}
    for p in range(len(st.llrs)):
        if st.out[p] is None:
            continue
        out[p] = ref.decode(st.llrs[p], st.code, dec["maxIter"], dec["alpha"],
                            msg or ctx.cfg["precision"], dec["clipLLR"])
    return out


def compare(ctx, st):
    refs = reference_outputs(ctx, st)
    st.ref_iters = {p: r[1] for p, r in refs.items()}
    mismatch, gaps = 0, []
    for p, (l_ref, _, done) in refs.items():
        bits, llr, _ = st.out[p]
        same = torch.all(bits == (l_ref < 0).to(bits.dtype), dim=0)
        mismatch += int((~same & done).sum())
        g = torch.linalg.vector_norm(llr - l_ref, dim=0) / torch.linalg.vector_norm(l_ref, dim=0)
        gaps.append(g[done])
    g = torch.cat(gaps)
    return [("cw_mismatch", mismatch), ("llr_gap_med", float(torch.median(g))),
            ("llr_gap_max", float(torch.max(g)))]


def control(ctx, st):
    """Put the reference decoder with fp8 messages (the next precision below
    the bf16 messages the configuration states) in the program's place."""
    for p, (l8, _, done) in reference_outputs(ctx, st, msg="fp8").items():
        st.out[p] = ((l8 < 0).to(torch.int8), l8, (~done).to(torch.int8))
