"""Closed-loop Monte-Carlo of the whole coherent WDM link, with the Manakov
solver that the configuration states.

The link mix (``mixes/link.py``) with three differences:

- ``manakov_ssf`` runs with the configuration's ``fiber`` settings:
  ``nlprMethod``, ``maxNlinPhaseRot``, ``tol``, ``maxIter``, ``trapIters``,
  ``fusedLinear`` and ``precision`` (float32: complex64);
- the window reports ``rx_msym_s``: every channel's two polarizations of
  ``nSymbols`` symbols a realization, recovered by the receivers, over the
  window;
- the reference receiver is trained on the program's own synchronized
  references (:func:`compare`).

One unit is one realization: fresh symbols and Tx laser phase noise from
the run's seed, ASE and LO noise from the program's generator, the Tx,
the fibre, every channel's LO and coherent receiver,
``coherent_dsp_chain_batch`` over all channels, and scoring. The
comparison is against the configuration's reference, so ``snr_gap_med``
and ``snr_gap_max`` hold the program's received signals to the
reference's link with the same solver; the reference's steps and
trapezoidal passes of the sampled realization go to the notes.
"""

from dataclasses import replace

import torch
from harness import core

link = core.mix("link")
State, draw = link.State, link.draw
warmup, step, work, release, control = (link.warmup, link.step, link.work, link.release,
                                         link.control)
PRECISION = {"float32": "c64", "float64": "c128"}


def solver(cfg, ch):
    """The SSFM configuration ``ch`` with the solver settings of ``cfg``."""
    f = cfg["fiber"]
    return replace(ch, nlprMethod=bool(f["nlprMethod"]),
                   maxNlinPhaseRot=float(f["maxNlinPhaseRot"]), tol=float(f["tol"]),
                   maxIter=int(f["maxIter"]), trapIters=int(f["trapIters"]),
                   fusedLinear=bool(f["fusedLinear"]), prec=PRECISION[f["precision"]])


def setup(ctx):
    st = link.setup(ctx)
    st.ch = solver(ctx.cfg, st.ch)
    return st


def results(ctx, st, n_units, elapsed):
    t = ctx.cfg["tx"]
    return {"rx_msym_s": n_units * t["nChannels"] * 2 * t["nSymbols"] / elapsed / 1e6}


def _lag(x, s):
    """The circular lag of ``x`` against ``s`` (both (nSym,)) at which they
    are equal up to scale: the peak of their cross-correlation."""
    return int(torch.argmax(torch.abs(torch.fft.ifft(torch.fft.fft(x) * torch.fft.fft(s).conj()))))


def compare(ctx, st):
    """The link mix's comparison (``ber_gap``, ``gmi_gap``, ``train_gap``,
    ``y_gap_med``, ``snr_gap_med``, ``snr_gap_max``) with one change: the
    reference receiver is trained on the program's own synchronized
    references, as ``wdm11.rx_sweep`` trains both receivers on the same
    ones. The program's ``symbol_sync`` and the reference's
    ``align_symbols`` choose lags a symbol apart where a channel's
    delay falls near the middle of a symbol (channels 3 and 8 of this
    grid, on every seed), and two receivers trained a symbol apart give
    outputs a symbol apart (a gap of sqrt(2)). The lags of every
    polarization, the program's less the reference's, go to the notes."""
    from harness.compare import receiver_gaps

    ref = link._ref(ctx.cfg)
    cfg, trf = ctx.cfg, ctx.traffic
    t = cfg["tx"]
    a, b = cfg["rx"]["nTrain"] + trf["discard_after_train"], -trf["tail"]
    ber_gap = gmi_gap = 0.0
    y_r = None
    for i, y, sc in st.kept:
        symbols, _ = draw(cfg, ctx.seed_for("realization", i), ctx.device)
        d = link._aligned(ref, y, symbols)
        yc = y[:, a:b].transpose(0, 1).reshape(-1, 2 * t["nChannels"])
        dc = d[:, a:b].transpose(0, 1).reshape(-1, 2 * t["nChannels"])
        ber, gmi, _ = ref.scores(yc, dc)
        ber_gap = link._worst(ber_gap, float(torch.max(torch.abs(ber.cpu() - sc[0]))))
        gmi_gap = link._worst(gmi_gap, float(torch.max(torch.abs(gmi.cpu() - sc[1]))))
        if i == st.r_done:
            y_r = y
    sig_b, ref_b, ph = st.rx_r
    train, whole = receiver_gaps(y_r, ph, *ref.dsp(sig_b, ref_b, cfg), trf["block"],
                                 cfg["rx"]["nTrain"])
    symbols, pn = draw(cfg, ctx.seed_for("realization", st.r_done), ctx.device)
    n = symbols.shape[-1]
    lags = []
    for k, s in enumerate(sig_b):
        own = ref.align_symbols(s, symbols[k].T, cfg)
        lags += [(_lag(ref_b[k][:, p], symbols[k, p]) - _lag(own[:, p], symbols[k, p]) + n // 2)
                 % n - n // 2 for p in range(2)]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed_for("reference noise"))
    sig_ref, _ = ref.link(symbols, pn, cfg, gen)
    snr_p, snr_r = link._snr(ref, cfg, sig_b, symbols), link._snr(ref, cfg, sig_ref, symbols)
    ctx.notes["sync_lag_less_reference"] = lags
    ctx.notes["da_snr_program"] = snr_p.cpu().numpy().round(3).tolist()
    ctx.notes["da_snr_reference"] = snr_r.cpu().numpy().round(3).tolist()
    ctx.notes["y_gap"] = whole.cpu().numpy().round(6).tolist()
    ctx.notes["reference_ssfm"] = dict(ref.last_counts)
    diff = torch.abs(snr_p - snr_r)
    return [("ber_gap", ber_gap), ("gmi_gap", gmi_gap), ("train_gap", float(train.max())),
            ("y_gap_med", float(torch.median(whole))),
            ("snr_gap_med", float(torch.median(diff))), ("snr_gap_max", float(torch.max(diff)))]
