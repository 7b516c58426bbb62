"""Closed-loop receiver DSP over stored captures.

Set-up makes ``captures`` captures with the reference link (plain
PyTorch, from the run's seed): every channel received through its own LO
and front end, with its symbols aligned. One unit is one call of the
program's ``coherent_dsp_chain_batch`` on all channels of a capture, the
captures taken in turn.

Correctness, once the window has closed: for one capture drawn from the
seed, the program's output of its last call against the reference
receiver on the same capture, per polarization, as the RMS difference
relative to the reference's RMS (``harness/compare.receiver_gaps``):

- ``train_gap``: the largest, over the data-aided training symbols, of the
  equalizer's output (the chain's output with its returned carrier phases
  taken off), whose trajectory the reference symbols fix;
- ``y_gap_med``: the median over polarizations, over all symbols, each
  block of ``block`` symbols given the quarter turn that matches it best
  (a slip of carrier recovery is a quarter turn). (After
  training the equalizer is decision-directed: a decision that rounding
  flips can send one polarization's trajectory elsewhere, a different
  result as valid as the reference's, so the largest gap is no measure.)
"""

import numpy as np
import torch

from harness.compare import receiver_gaps


def _ref(cfg):
    from harness import core

    return core.reference(cfg.get("reference", cfg["name"]))


class State:
    pass


def setup(ctx):
    from harness import core

    link = core.mix("link")
    ref = _ref(ctx.cfg)
    st = State()
    _, _, st.dsp, _ = link._cfgs(ctx.cfg)
    st.caps = []
    for c in range(ctx.traffic["captures"]):
        symbols, pn = link.draw(ctx.cfg, ctx.seed_for("capture", c), ctx.device)
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed_for("capture noise", c))
        sig_b, ref_b = ref.link(symbols, pn, ctx.cfg, gen)
        st.caps.append((sig_b, ref_b))
    st.last = [None] * len(st.caps)
    st.i = 0
    return st


def chain(ctx, st, c):
    from opticommpy_torch.pipelines import coherent_dsp_chain_batch

    sig_b, ref_b = st.caps[c]
    with ctx.spans("dsp"):
        return coherent_dsp_chain_batch(sig_b, ref_b, st.dsp)


def step(ctx, st):
    c = st.i % len(st.caps)
    st.last[c] = chain(ctx, st, c)  # (symbols, carrier phases)
    if st.last[c][0].is_cuda:
        torch.cuda.synchronize()
    st.i += 1


def warmup(ctx, st):
    chain(ctx, st, 0)


def results(ctx, st, n_units, elapsed):
    t = ctx.cfg["tx"]
    return {"rx_msym_s": n_units * t["nChannels"] * 2 * t["nSymbols"] / elapsed / 1e6}


def work(ctx, st):
    return st.i, 0


def release(ctx, st):
    pass


def sampled(ctx, st):
    done = [c for c in range(len(st.caps)) if st.last[c] is not None]
    return done[int(np.random.default_rng(ctx.seed_for("sample")).integers(len(done)))]


def compare(ctx, st):
    ref = _ref(ctx.cfg)
    c = sampled(ctx, st)
    sig_b, ref_b = st.caps[c]
    y_ref, y_eq_ref = ref.dsp(sig_b, ref_b, ctx.cfg)
    train, whole = receiver_gaps(*st.last[c], y_ref, y_eq_ref, ctx.traffic["block"],
                                 ctx.cfg["rx"]["nTrain"])
    ctx.notes["y_gap"] = whole.cpu().numpy().round(6).tolist()
    return [("train_gap", float(train.max())), ("y_gap_med", float(torch.median(whole)))]


def control(ctx, st):
    """Put the reference receiver computed in bfloat16 in the program's place
    on the sampled capture."""
    ref = _ref(ctx.cfg)
    c = sampled(ctx, st)
    sig_b, ref_b = st.caps[c]
    st.last[c] = as_program_output(*ref.dsp(sig_b, ref_b, ctx.cfg, ref.bf16, ref.bf16_np))


def as_program_output(y, y_eq):
    """A reference's (symbols, equalizer output) as the chain returns them:
    (symbols, carrier phases (N, B * modes))."""
    from harness.compare import columns

    return y, torch.angle(columns(y) / columns(y_eq))
