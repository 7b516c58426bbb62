"""Closed-loop Monte-Carlo of the whole coherent WDM link.

One unit is one realization: fresh symbols and Tx laser phase noise, drawn
by the benchmark from the run's seed, through the program's Tx build,
``manakov_ssf`` (ASE from the program's generator, seeded from the run's
seed), every channel's LO and ``pdm_coherent_receiver`` with its
reference synchronization, ``coherent_dsp_chain_batch`` over all
channels, and BER / GMI / SNR of every polarization.

Correctness, once the window has closed (the cell's ``limits/<cell>.json``
says which of these numbers are held; the others are printed):

- scoring: ``ber_gap``, ``gmi_gap``, the largest difference, over every
  polarization of every realization of the window, between the program's
  BER (GMI) and the reference's scoring of the program's own output
  against the benchmark's symbols;
- receiver: for one realization drawn from the seed (one of the first
  ``sample_from``), the reference receiver on the program's own received
  signals, trained on the benchmark's symbols as the reference aligns them
  itself, against the program's output and carrier phases, as
  ``wdm11.rx_sweep`` compares them (``train_gap``, ``y_gap_med``,
  ``mixes/rx_sweep.py``);
- channel: for the same realization, the reference link on the same
  symbols and Tx phase noise, with its own ASE and LO noise, against the
  program's received signals, by the data-aided SNR of every polarization
  (``reference da_snr``): ``snr_gap_med`` and ``snr_gap_max``, the median
  and the largest difference. The noise differs, so these are limits on
  a statistic: the channel's physics, not its samples.
"""

import math

import numpy as np
import torch


def _cfgs(cfg):
    from opticommpy_torch.models import PDMFrontendConfig, SSFMConfig
    from opticommpy_torch.models.tx import WDMTxConfig
    from opticommpy_torch.pipelines import CoherentDSPConfig

    t, f, r = cfg["tx"], cfg["fiber"], cfg["rx"]
    tx = WDMTxConfig(M=16, Rs=t["Rs"], SpS=t["SpS"], nBits=t["nSymbols"] * 4,
                     nChannels=t["nChannels"], nPolModes=2, nFilterTaps=t["nFilterTaps"],
                     pulseRollOff=t["pulseRollOff"], powerPerChannel=(t["powerPerChannel_dBm"],),
                     wdmGridSpacing=t["wdmGridSpacing"], laserLinewidth=t["laserLinewidth"])
    fs = t["Rs"] * t["SpS"]
    ch = SSFMConfig(Ltotal=f["Ltotal"], Lspan=f["Lspan"], hz=f["hz"], alpha=f["alpha"], D=f["D"],
                    gamma=f["gamma"], Fc=f["Fc"], Fs=fs, amp=f["amp"], NF=f["NF"],
                    nlprMethod=False, trapIters=1, fusedLinear=True)
    dsp = CoherentDSPConfig(Rs=t["Rs"], SpS_in=r["SpS_in"], L=r["L"], D=r["D"], Fc=f["Fc"],
                            nTaps=r["nTaps"], mu=tuple(r["mu"]), alg=tuple(r["alg"]),
                            nTrain=r["nTrain"], M=16, cpr_window=r["cpr_window"],
                            cpr_phases=r["cpr_phases"], eqBackend=r["eqBackend"],
                            cprBackend=r["cprBackend"], nFilterTaps=t["nFilterTaps"],
                            rollOff=t["pulseRollOff"])
    return tx, ch, dsp, PDMFrontendConfig(Fs=fs)


def draw(cfg, seed, device):
    """The benchmark's inputs of one realization: symbols (nCh, 2, nSym)
    complex64 (uniform 16-QAM) and the Tx lasers' phase noise (nCh, N)."""
    ref = _ref(cfg)
    t = cfg["tx"]
    g = torch.Generator(device=device).manual_seed(seed)
    n_ch, n_sym = t["nChannels"], t["nSymbols"]
    idx = torch.randint(0, 16, (n_ch, 2, n_sym), generator=g, device=device)
    symbols = torch.as_tensor(ref.qam16_gray(), device=device)[idx]
    n = n_sym * t["SpS"]
    std = math.sqrt(2 * math.pi * t["laserLinewidth"] / (t["Rs"] * t["SpS"]))
    steps = std * torch.randn((n_ch, n - 1), generator=g, device=device, dtype=torch.float64)
    pn = torch.cat([torch.zeros((n_ch, 1), device=device, dtype=torch.float64),
                    torch.cumsum(steps, dim=1)], dim=1).float()
    return symbols, pn


def _ref(cfg):
    from harness import core

    return core.reference(cfg.get("reference", cfg["name"]))


class State:
    pass


def setup(ctx):
    st = State()
    st.tx, st.ch, st.dsp, st.fe = _cfgs(ctx.cfg)
    st.gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed_for("program noise"))
    st.i = 0
    st.kept = []  # (realization, y, scores) of every realization of the window
    st.keep = True
    st.r = int(np.random.default_rng(ctx.seed_for("sample")).integers(ctx.traffic["sample_from"]))
    st.rx_r = st.r_done = None  # realization r's received signals and references
    return st


def realization(ctx, st, symbols, pn):
    """The program's link for one realization: (y (B, nSym, 2), scores (3,
    2B), (received signals (B, N, 2), synchronized references (B, nSym, 2),
    carrier phases (nSym, 2B)))."""
    from opticommpy_torch.comm.metrics import fast_ber_calc, monte_carlo_gmi
    from opticommpy_torch.dsp import EDCConfig, edc
    from opticommpy_torch.models import LaserConfig, basic_laser_model, manakov_ssf
    from opticommpy_torch.models import pdm_coherent_receiver
    from opticommpy_torch.models.tx import wdm_freq_grid, wdm_tx_build
    from opticommpy_torch.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync
    from opticommpy_torch.pipelines import coherent_dsp_chain_batch

    sp, cfg = ctx.spans, ctx.cfg
    t, r = cfg["tx"], cfg["rx"]
    fs = t["Rs"] * t["SpS"]
    with sp("tx"):
        sig_tx, symb_tx, _ = wdm_tx_build(symbols, pn, st.tx)
    with sp("ssfm"):
        sig_ch = manakov_ssf(sig_tx, st.ch, st.gen)
    with sp("rx_front"):
        pulse = pulse_shape("rrc", t["SpS"], t["nFilterTaps"], t["pulseRollOff"])
        edc_cfg = EDCConfig(L=r["L"], D=r["D"], Fc=cfg["fiber"]["Fc"], Fs=2 * t["Rs"], Rs=t["Rs"])
        sigs, refs = [], []
        for k, f_k in enumerate(wdm_freq_grid(t["nChannels"], t["wdmGridSpacing"])):
            lo = basic_laser_model(LaserConfig(P=cfg["lo"]["P_dBm"], lw=cfg["lo"]["lw"],
                                               Ns=sig_ch.shape[0], Fs=fs, RIN_var=0.0,
                                               freqShift=float(f_k) + cfg["lo"]["freqOffset"]),
                                   st.gen)
            rx = pdm_coherent_receiver(sig_ch, lo, st.fe, generator=st.gen)
            pre = edc(decimate(fir_filter(pulse, rx), t["SpS"], 2), edc_cfg)
            refs.append(pnorm(symbol_sync(pre, symb_tx[:, :, k], 2)))
            sigs.append(rx)
        sig_b, ref_b = torch.stack(sigs), torch.stack(refs)
    with sp("dsp"):
        y, ph = coherent_dsp_chain_batch(sig_b, ref_b, st.dsp)
    with sp("score"):
        a, b = r["nTrain"] + ctx.traffic["discard_after_train"], -ctx.traffic["tail"]
        yc = y[:, a:b].transpose(0, 1).reshape(-1, 2 * t["nChannels"])
        dc = ref_b[:, a:b].transpose(0, 1).reshape(-1, 2 * t["nChannels"])
        ber, _, snr = fast_ber_calc(yc, dc, 16, "qam")
        gmi, _ = monte_carlo_gmi(yc, dc, 16, "qam")
        scores = torch.stack([ber, gmi, snr]).cpu()
    return y, scores, (sig_b, ref_b, ph)


def step(ctx, st):
    symbols, pn = draw(ctx.cfg, ctx.seed_for("realization", st.i), ctx.device)
    y, scores, rx = realization(ctx, st, symbols, pn)
    if st.keep:
        st.kept.append((st.i, y, scores))
        if st.i <= st.r:  # realization r, or the last one where the window ends first
            st.rx_r, st.r_done = rx, st.i
    st.i += 1


def warmup(ctx, st):
    """One realization on other inputs: cuFFT plans, the kernels' tables."""
    st.keep = False
    symbols, pn = draw(ctx.cfg, ctx.seed_for("warm-up"), ctx.device)
    realization(ctx, st, symbols, pn)
    st.keep = True


def results(ctx, st, n_units, elapsed):
    t = ctx.cfg["tx"]
    return {"link_msym_s": n_units * t["nChannels"] * 2 * t["nSymbols"] / elapsed / 1e6}


def work(ctx, st):
    return st.i, 0


def release(ctx, st):
    st.gen = None


def _aligned(ref, y, symbols):
    """The benchmark's symbols (B, nSym, 2), each polarization rolled to the
    lag at which it correlates best with the program's output."""
    out = torch.empty_like(y)
    for k in range(y.shape[0]):
        for p in range(2):
            out[k, :, p] = torch.roll(symbols[k, p], ref.best_lag(y[k, :, p], symbols[k, p]))
    return out


def _worst(a, b):
    """The larger of two gaps; a NaN is the worst."""
    return b if math.isnan(b) or b > a else a


def _snr(ref, cfg, sig_b, symbols):
    """Data-aided SNR of every polarization (2B,) of received signals."""
    return torch.cat([ref.da_snr(s, ref.align_symbols(s, symbols[k].T, cfg), cfg)
                      for k, s in enumerate(sig_b)])


def compare(ctx, st):
    from harness.compare import receiver_gaps

    ref = _ref(ctx.cfg)
    cfg, trf = ctx.cfg, ctx.traffic
    t = cfg["tx"]
    a, b = cfg["rx"]["nTrain"] + trf["discard_after_train"], -trf["tail"]
    ber_gap = gmi_gap = 0.0
    y_r = None
    for i, y, sc in st.kept:
        symbols, _ = draw(cfg, ctx.seed_for("realization", i), ctx.device)
        d = _aligned(ref, y, symbols)
        yc = y[:, a:b].transpose(0, 1).reshape(-1, 2 * t["nChannels"])
        dc = d[:, a:b].transpose(0, 1).reshape(-1, 2 * t["nChannels"])
        ber, gmi, _ = ref.scores(yc, dc)
        ber_gap = _worst(ber_gap, float(torch.max(torch.abs(ber.cpu() - sc[0]))))
        gmi_gap = _worst(gmi_gap, float(torch.max(torch.abs(gmi.cpu() - sc[1]))))
        if i == st.r_done:
            y_r = y
    sig_b, _, ph = st.rx_r
    symbols, pn = draw(cfg, ctx.seed_for("realization", st.r_done), ctx.device)
    ref_own = torch.stack([ref.align_symbols(s, symbols[k].T, cfg) for k, s in enumerate(sig_b)])
    train, whole = receiver_gaps(y_r, ph, *ref.dsp(sig_b, ref_own, cfg), trf["block"],
                                 cfg["rx"]["nTrain"])
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed_for("reference noise"))
    sig_ref, _ = ref.link(symbols, pn, cfg, gen)
    snr_p, snr_r = _snr(ref, cfg, sig_b, symbols), _snr(ref, cfg, sig_ref, symbols)
    ctx.notes["da_snr_program"] = snr_p.cpu().numpy().round(3).tolist()
    ctx.notes["da_snr_reference"] = snr_r.cpu().numpy().round(3).tolist()
    ctx.notes["y_gap"] = whole.cpu().numpy().round(6).tolist()
    diff = torch.abs(snr_p - snr_r)
    return [("ber_gap", ber_gap), ("gmi_gap", gmi_gap), ("train_gap", float(train.max())),
            ("y_gap_med", float(torch.median(whole))),
            ("snr_gap_med", float(torch.median(diff))), ("snr_gap_max", float(torch.max(diff)))]


def control(ctx, st):
    """Put the reference computed in bfloat16 in the program's place for the
    sampled realization: the bf16 reference link on the same symbols and Tx
    phase noise (its own ASE and LO noise), the bf16 reference receiver on
    its signals, scored in bf16."""
    from harness import core

    ref = _ref(ctx.cfg)
    cfg, trf = ctx.cfg, ctx.traffic
    t = cfg["tx"]
    a, b = cfg["rx"]["nTrain"] + trf["discard_after_train"], -trf["tail"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed_for("control noise"))
    symbols, pn = draw(cfg, ctx.seed_for("realization", st.r_done), ctx.device)
    sig_b, ref_b = ref.link(symbols, pn, cfg, gen, ref.bf16)
    y, ph = core.mix("rx_sweep").as_program_output(
        *ref.dsp(sig_b, ref_b, cfg, ref.bf16, ref.bf16_np))
    d = _aligned(ref, y, symbols)
    yc = y[:, a:b].transpose(0, 1).reshape(-1, 2 * t["nChannels"])
    dc = d[:, a:b].transpose(0, 1).reshape(-1, 2 * t["nChannels"])
    ber, gmi, snr = ref.scores(yc, dc, ref.bf16)
    st.kept = [(st.r_done, y, torch.stack([ber, gmi, snr]).cpu())]
    st.rx_r = (sig_b, ref_b, ph)
