"""The coherent receiver DSP chain (port of ``opticommpy_tpu/pipelines.py``).

:func:`coherent_dsp_chain` runs matched filter -> decimation -> EDC ->
MIMO adaptive equalization -> 4th-power FOE -> BPS carrier recovery on the
input's device. With ``eqBackend="pallas"`` and ``cprBackend="pallas"`` the
equalizer's training passes and the BPS run on the Hopper kernels
(``kernels/mimo_eq.py``, ``kernels/rls.py``, ``kernels/bps.py``); CPU tensors
run the kernels' plain versions.

:func:`coherent_dsp_chain_batch` receives B signals at once (for example
the channels of a WDM field): a front end per signal, then every
equalizer pass of all B signals in one kernel launch (K3 for the gradient
rules, K5 for rls / dd-rls) and one BPS launch over all B * modes columns.

With ``runCR=True`` a clock-recovery stage runs between EDC and the
equalizer: the Gardner loop (``crMethod="gardner"``; on the Hopper kernel K6
with ``crBackend="pallas"``) or feedforward retiming (``crMethod="ffw"``,
the only method the batch chain takes, as in the JAX package).

:func:`coherent_dsp_serve` is the converged receiver: frozen taps applied
by one decimating frequency-domain filter per signal
(``mimo_apply_fused``), then one BPS launch over all signals' columns.
:func:`coherent_coded_serve` adds bit LLRs and LDPC decoding to it (the
fused QC kernels K9 and K10 for DVB-S2 codes on CUDA).

:func:`imdd_dsp_chain_batch` is the IM-DD (direct-detection PAM) receiver
for a batch of photodiode currents: DC removal, symbol-rate sampling and
one DFE (or FFE) launch for all signals (K13, ``kernels/dfe.py``).
"""

from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.comm.modulation import norm_const
from opticommpy_torch.dsp.carrier_recovery import bps, fourth_power_foe, unwrap_derotate
from opticommpy_torch.dsp.clock_recovery import (
    ClockRecoveryConfig,
    FFWClockRecoveryConfig,
    ffw_clock_recovery,
    gardner_clock_recovery,
)
from opticommpy_torch.dsp.equalization import (
    EDCConfig,
    MIMOEqualizerConfig,
    _fused_apply,
    _fused_response,
    edc,
    mimo_adapt_equalizer,
    mimo_adapt_equalizer_batch,
)
from opticommpy_torch.ops.filtering import fir_filter, pulse_shape
from opticommpy_torch.ops.signal import decimate, pnorm, row_mean
from opticommpy_torch.utils.profiling import span
from opticommpy_torch.utils.rng import as_device_tensor

__all__ = ["CoherentDSPConfig", "coherent_dsp_chain", "coherent_dsp_chain_batch",
           "coherent_dsp_serve", "coherent_coded_serve", "IMDDConfig", "imdd_dsp_chain_batch"]


@dataclass(frozen=True)
class CoherentDSPConfig:
    """Coherent receiver chain configuration (same fields and defaults as
    the JAX package's)."""

    Rs: float = 32e9
    SpS_in: int = 16  # samples/symbol at the receiver input
    SpS_dsp: int = 2  # samples/symbol for equalization
    # matched filter
    pulseType: str = "rrc"
    nFilterTaps: int = 1024
    rollOff: float = 0.01
    # CD compensation
    L: float = 400.0  # [km]
    D: float = 16.0
    Fc: float = 193.1e12
    # equalizer
    nTaps: int = 15
    mu: tuple = (5e-3, 2e-3)
    alg: tuple = ("da-rde", "dd-lms")
    nTrain: int = 10000
    M: int = 16
    blockUpdate: int = 1
    # 'scan': the per-symbol reference rules; 'pallas': every training pass
    # on the Hopper kernel; 'pallas-lms': one kernel pass of LMS
    # (data-aided for nTrain symbols, then decision-directed, FOE before it)
    eqBackend: str = "scan"
    # carrier recovery: 'xla' = the broadcast BPS, 'pallas' = the Hopper kernel
    cpr_window: int = 75
    cpr_phases: int = 64
    cprBackend: str = "xla"
    runFOE: bool = True
    # clock recovery between EDC and the equalizer: 'gardner' (crBackend
    # 'pallas' = the Hopper kernel, 'scan' = the per-sample loop) or 'ffw'
    runCR: bool = False
    crMethod: str = "gardner"
    crBackend: str = "pallas"
    crKp: float = 2e-3
    crKi: float = 1e-5
    crMaxPPM: float = 500.0
    crNyquist: bool = False
    crBlockLen: int = 4096
    crFit: str = "linear"


def _stage_lengths(cfg: CoherentDSPConfig, n_sym: int):
    """Per-stage symbol counts: 1 stage (all symbols) or 2 (nTrain, rest)."""
    n_stages = len(cfg.alg)
    if n_stages == 1:
        return (n_sym,)
    if n_stages == 2:
        return (cfg.nTrain, n_sym - cfg.nTrain)
    raise ValueError(
        f"CoherentDSPConfig.alg has {n_stages} stages; the chain's "
        "nTrain split only defines schedules for 1 or 2 stages — build a "
        "MIMOEqualizerConfig with an explicit L tuple and call "
        "mimo_adapt_equalizer directly for longer schedules")


def _ffw_config(cfg):
    return FFWClockRecoveryConfig(blockLen=cfg.crBlockLen, maxPPM=cfg.crMaxPPM,
                                  rollOff=cfg.rollOff, fit=cfg.crFit, sps=cfg.SpS_dsp)


def _clock_recovery(x, cfg):
    """The chain's retiming stage, with the static output length."""
    if cfg.crMethod == "ffw":
        return ffw_clock_recovery(x, _ffw_config(cfg))
    cr_cfg = ClockRecoveryConfig(kp=cfg.crKp, ki=cfg.crKi, isNyquist=cfg.crNyquist,
                                 maxPPM=cfg.crMaxPPM)
    return gardner_clock_recovery(x, cr_cfg, backend=cfg.crBackend, static_out=True)


def coherent_dsp_chain(sig, symb_ref, config: CoherentDSPConfig = CoherentDSPConfig()):
    """Full coherent DSP chain on the device of ``sig``.

    Parameters
    ----------
    sig : (N, modes) complex received signal at ``SpS_in`` samples/symbol.
    symb_ref : (nSym, modes) transmitted symbols, already synchronized.

    Returns
    -------
    (y, phases): equalized + carrier-recovered symbols and the CPR phases.
    """
    cfg = config
    if cfg.eqBackend not in ("scan", "pallas", "pallas-lms"):
        raise ValueError(f"unknown eqBackend {cfg.eqBackend!r}")
    sig = as_device_tensor(sig)
    symb_ref = torch.as_tensor(symb_ref).to(sig.device)
    fs_dsp = cfg.Rs * cfg.SpS_dsp

    pulse = pulse_shape(cfg.pulseType, cfg.SpS_in, cfg.nFilterTaps, cfg.rollOff)
    x = fir_filter(pulse.astype(np.float32), sig)
    x = decimate(x, cfg.SpS_in, cfg.SpS_dsp)
    x = edc(x, EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs_dsp, Rs=cfg.Rs))
    x = pnorm(x)

    n_sym = symb_ref.shape[0]
    if cfg.runCR:
        x = pnorm(_clock_recovery(x, cfg))
        n_sym_cr = x.shape[0] // cfg.SpS_dsp
        if n_sym > n_sym_cr:
            raise ValueError(
                f"symb_ref has {n_sym} symbols but clock recovery retains "
                f"only {n_sym_cr} ((1 - crMaxPPM/1e6) * n_samples / SpS_dsp)"
                " — trim the reference")
    if cfg.eqBackend == "pallas-lms":
        from opticommpy_torch.kernels.mimo_eq import mimo_eq_kernel

        # LMS is phase-sensitive: remove the carrier frequency offset first
        if cfg.runFOE:
            x, _ = fourth_power_foe(x, fs_dsp, 4)
            x = pnorm(x)
        y, _ = mimo_eq_kernel(x, pnorm(symb_ref), norm_const(cfg.M, "qam"), alg="lms",
                              n_taps=cfg.nTaps, sps=cfg.SpS_dsp,
                              mu=float(cfg.mu[0]), n_train=cfg.nTrain)
    else:
        eq_cfg = MIMOEqualizerConfig(
            nTaps=cfg.nTaps, SpS=cfg.SpS_dsp, mu=cfg.mu, alg=cfg.alg,
            L=_stage_lengths(cfg, n_sym), M=cfg.M, numIter=2,
            blockUpdate=cfg.blockUpdate,
            backend="pallas" if cfg.eqBackend == "pallas" else "scan")
        y = mimo_adapt_equalizer(x, eq_cfg, symb_ref=pnorm(symb_ref))

    if cfg.runFOE and cfg.eqBackend != "pallas-lms":
        y, _ = fourth_power_foe(y, cfg.Rs, 4)
        y = pnorm(y)
    const = norm_const(cfg.M, "qam")
    if cfg.cprBackend == "pallas":
        from opticommpy_torch.kernels.bps import bps_kernel

        phases = bps_kernel(y, cfg.cpr_window // 2, const, cfg.cpr_phases)
    else:
        phases = bps(y, cfg.cpr_window // 2, torch.as_tensor(const), cfg.cpr_phases)
    y, phases = unwrap_derotate(phases, y, 4)
    return pnorm(y), phases


def coherent_dsp_chain_batch(sig_batch, symb_ref_batch,
                             config: CoherentDSPConfig = CoherentDSPConfig()):
    """Adaptive coherent chain for a batch of signals (port of the JAX
    ``coherent_dsp_chain_batch``).

    Each signal gets its own front end (matched filter, decimation with its
    own max-variance phase, CD compensation, normalization, 4th-power FOE
    before the equalizer). With ``eqBackend="pallas"`` the full multi-stage
    schedule (``config.alg``/``config.mu``, numIter=2) runs through
    :func:`mimo_adapt_equalizer_batch`; otherwise one pass of LMS for all
    signals (data-aided for nTrain symbols, step ``mu[-1]``, as the JAX
    chain does). BPS always runs on its kernel, whatever ``cprBackend`` says,
    with the batch folded into the mode axis.

    Under a ``torch.profiler`` the stages are the spans ``rx.front_end``
    (per signal ``.filter``, ``.edc``, ``.foe``, on the host only),
    ``rx.equalizer`` (with the reference symbols' normalization),
    ``rx.bps`` and ``rx.unwrap`` (with the derotation; one call of K15
    for CUDA tensors): :func:`~opticommpy_torch.utils.profiling.span`.

    Parameters
    ----------
    sig_batch : (B, N, modes) received signals at ``SpS_in`` samples/symbol.
    symb_ref_batch : (B, nSym, modes) synchronized reference symbols.

    Returns
    -------
    (y (B, nSym, modes), phases (nSym, B*modes)).
    """
    from opticommpy_torch.kernels.bps import bps_kernel
    from opticommpy_torch.kernels.mimo_eq import mimo_eq_kernel_batch

    cfg = config
    if cfg.runCR and cfg.crMethod != "ffw":
        raise NotImplementedError(
            "coherent_dsp_chain_batch supports clock recovery only with "
            "crMethod='ffw' (the feedforward stage runs per signal; the "
            "Gardner NCO recurrence has no batched kernel — run "
            "coherent_dsp_chain per signal for that)")
    sig_batch = as_device_tensor(sig_batch)
    symb_ref_batch = torch.as_tensor(symb_ref_batch).to(sig_batch.device)
    fs_dsp = cfg.Rs * cfg.SpS_dsp
    pulse = pulse_shape(cfg.pulseType, cfg.SpS_in, cfg.nFilterTaps,
                        cfg.rollOff).astype(np.float32)
    edc_cfg = EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs_dsp, Rs=cfg.Rs)

    def front(sig):
        with span("rx.front_end.filter", device=False):
            x = fir_filter(pulse, sig)
            x = decimate(x, cfg.SpS_in, cfg.SpS_dsp)
        with span("rx.front_end.edc", device=False):
            x = pnorm(edc(x, edc_cfg))
        if cfg.runCR or cfg.runFOE:
            with span("rx.front_end.foe", device=False):
                if cfg.runCR:
                    # each signal has its own ADC clock: its own retiming
                    x = pnorm(ffw_clock_recovery(x, _ffw_config(cfg)))
                if cfg.runFOE:
                    x, _ = fourth_power_foe(x, fs_dsp, 4)
                    x = pnorm(x)
        return x

    with span("rx.front_end"):
        x = torch.stack([front(s) for s in sig_batch])  # (B, n_dsp, modes)
    if cfg.runCR and symb_ref_batch.shape[1] > x.shape[1] // cfg.SpS_dsp:
        raise ValueError(
            f"symb_ref_batch has {symb_ref_batch.shape[1]} symbols but "
            f"clock recovery retains only {x.shape[1] // cfg.SpS_dsp} "
            "((1 - crMaxPPM/1e6) * n_samples / SpS_dsp) — trim the "
            "reference")
    const = norm_const(cfg.M, "qam")
    with span("rx.equalizer"):
        ref = torch.stack([pnorm(r) for r in symb_ref_batch])
        if cfg.eqBackend == "pallas":
            eq_cfg = MIMOEqualizerConfig(
                nTaps=cfg.nTaps, SpS=cfg.SpS_dsp, mu=cfg.mu, alg=cfg.alg,
                L=_stage_lengths(cfg, ref.shape[1]), M=cfg.M, numIter=2,
                blockUpdate=cfg.blockUpdate, backend="pallas")
            y = mimo_adapt_equalizer_batch(x, eq_cfg, symb_ref=ref)
        else:
            y, _ = mimo_eq_kernel_batch(x, ref, const, alg="lms", n_taps=cfg.nTaps,
                                        sps=cfg.SpS_dsp, mu=float(cfg.mu[-1]),
                                        n_train=cfg.nTrain)
    b, n_sym, m = y.shape
    with span("rx.bps"):
        y_cols = y.transpose(0, 1).reshape(n_sym, b * m)
        phases = bps_kernel(y_cols, cfg.cpr_window // 2, const, cfg.cpr_phases)
    with span("rx.unwrap"):
        out, phases = unwrap_derotate(phases, y_cols, 4)
    return out.reshape(n_sym, b, m).transpose(0, 1), phases


def coherent_dsp_serve(sig_batch, H_batch, config: CoherentDSPConfig = CoherentDSPConfig(),
                       scale=None):
    """Converged-receiver serving path for a batch of signals (port of the
    JAX ``coherent_dsp_serve``).

    After training, the receiver is LTI up to carrier phase: matched filter,
    CD compensation, power normalization and the frozen MIMO taps collapse
    into one decimating frequency-domain filter per signal
    (:func:`~opticommpy_torch.dsp.equalization.mimo_apply_fused`, one
    combined response for the whole batch), and BPS runs as one kernel
    launch with the batch folded into the columns.

    Parameters
    ----------
    sig_batch : (B, N, modes) received signals at ``SpS_dsp`` samples/symbol
        (a single (N, modes) signal is also accepted).
    H_batch : (B, modes, modes, nTaps) converged tap tensors.
    scale : optional (B,) training-time pnorm scalars (else Parseval).

    Returns
    -------
    (out (B, nSym, modes), phases (nSym, B * modes)); for a single signal
    (out (nSym, modes), phases (nSym, modes)).
    """
    from opticommpy_torch.kernels.bps import bps_kernel

    cfg = config
    sig_batch = as_device_tensor(sig_batch).to(torch.complex64)
    H_batch = torch.as_tensor(H_batch).to(sig_batch.device, torch.complex64)
    squeeze = sig_batch.ndim == 2
    if squeeze:
        sig_batch, H_batch = sig_batch[None], H_batch[None]
    if scale is not None:
        scale = torch.as_tensor(scale, dtype=torch.float32).to(sig_batch.device)
        scale = scale.reshape(-1)
    fs_dsp = cfg.Rs * cfg.SpS_dsp
    pulse = pulse_shape(cfg.pulseType, cfg.SpS_dsp, cfg.nFilterTaps,
                        cfg.rollOff).astype(np.float32)
    edc_cfg = EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs_dsp, Rs=cfg.Rs)
    P, nfft = _fused_response(pulse, edc_cfg, sig_batch.shape[1], H_batch.shape[-1],
                              cfg.SpS_dsp, sig_batch.device)
    y = _fused_apply(H_batch, sig_batch, cfg.SpS_dsp, P, nfft, scale)
    b, n_sym, m = y.shape
    y_cols = y.transpose(0, 1).reshape(n_sym, b * m)
    phases = bps_kernel(y_cols, cfg.cpr_window // 2, norm_const(cfg.M, "qam"), cfg.cpr_phases)
    out, phases = unwrap_derotate(phases, y_cols, 4)
    out = out.reshape(n_sym, b, m).transpose(0, 1)
    return (out[0], phases[:, :m]) if squeeze else (out, phases)


def coherent_coded_serve(sig_batch, H_batch, config: CoherentDSPConfig = CoherentDSPConfig(),
                         noise_var=0.05, fec_graph=None, fec_config=None, scale=None,
                         pilot_grid=None):
    """Complete coded coherent receiver (port of the JAX
    ``coherent_coded_serve``): :func:`coherent_dsp_serve` -> bit LLRs
    (:func:`~opticommpy_torch.comm.metrics.calc_llr`) -> LDPC belief
    propagation (:func:`~opticommpy_torch.comm.fec.decode_ldpc`; for DVB-S2
    graphs on CUDA the whole-decode kernel K11 at the default bfloat16
    messages, the fused kernels K9 + K10 for float32 at rates 3/5 and
    above).

    Framing: per signal, the recovered (nSym, modes) symbol grid is read
    mode-major (all of mode 0's symbols, then mode 1's, ...), each symbol
    giving log2(M) interleaved bits; the bit-LLR stream is cut into
    consecutive length-n codewords and the tail beyond the last whole
    codeword is discarded.

    Parameters
    ----------
    sig_batch : (B, N, modes) received signals at ``SpS_dsp`` (or one
        (N, modes) signal); a NumPy array goes to the default device.
    H_batch : (B, modes, modes, nTaps) converged equalizer taps.
    noise_var : per-symbol noise variance of the LLR model (scalar).
    fec_graph : decoding graph (default: DVB-S2 64800b R4/5).
    fec_config : :class:`~opticommpy_torch.comm.fec.LDPCConfig` (default:
        20-iteration bf16 NMSA with early exit, which decodes on K11 on
        CUDA, each codeword's CTA stopping at its own convergence).
    pilot_grid : optional (B, P, modes) known leading Tx symbols (any
        scale). Blind BPS leaves a k*pi/2 ambiguity per column; the
        correlation of the first P recovered symbols with the pilots sets
        k per (signal, mode) before demapping.

    Returns
    -------
    (decoded_bits (n, n_codewords), frame_fail (n_codewords,),
     symbols (B, nSym, modes)); codeword c of signal b is column
    ``b * (n_codewords // B) + c``.
    """
    from opticommpy_torch.comm.fec import LDPCConfig, decode_ldpc, standard_ldpc
    from opticommpy_torch.comm.metrics import calc_llr
    from opticommpy_torch.comm.modulation import bit_map

    if fec_graph is None:
        fec_graph, _ = standard_ldpc("DVBS2", 64800, "4/5")
    if fec_config is None:
        fec_config = LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16", earlyExit=True)
    sig_batch = as_device_tensor(sig_batch)
    out, _ = coherent_dsp_serve(sig_batch, H_batch, config, scale)
    out3 = out if out.ndim == 3 else out[None]
    B, n_sym, modes = out3.shape
    if pilot_grid is not None:
        pg = torch.as_tensor(pilot_grid).to(out3.device, torch.complex64)
        pg = pg if pg.ndim == 3 else pg[None]
        c = torch.sum(out3[:, :pg.shape[1]] * pg.conj(), dim=1)  # (B, modes)
        k = torch.round(torch.angle(c) / (np.pi / 2)) % 4
        out3 = out3 * torch.exp(-1j * (np.pi / 2) * k)[:, None, :]
    const = norm_const(config.M, "qam")
    px = np.full(config.M, 1.0 / config.M)
    ys = out3.transpose(1, 2).reshape(B, modes * n_sym)  # mode-major
    llr = calc_llr(ys, noise_var, const, bit_map(config.M, "qam"), px).reshape(B, -1)
    n_code = fec_graph["n"]
    ncw = llr.shape[1] // n_code
    if ncw == 0:
        raise ValueError(f"{llr.shape[1]} bits/signal < one length-{n_code} codeword")
    llr_cols = llr[:, :ncw * n_code].reshape(B * ncw, n_code).T
    bits, _, fail = decode_ldpc(llr_cols, graph=fec_graph, config=fec_config)
    return bits, fail, (out3[0] if out.ndim == 2 else out3)


@dataclass(frozen=True)
class IMDDConfig:
    """IM-DD (direct-detection PAM) receiver chain configuration (same
    fields and defaults as the JAX package's)."""

    SpS_in: int = 8  # photodiode-current oversampling
    M: int = 4
    eq: str = "dfe"  # 'dfe' | 'ffe'
    nTapsFF: int = 15
    nTapsFB: int = 5
    mu: float = 2e-3
    nTrain: int = 8000
    trainingMode: str = "fulltime"


def imdd_dsp_chain_batch(i_rx_batch, symb_ref_batch, config: IMDDConfig = IMDDConfig()):
    """IM-DD PAM receiver for a batch of signals (port of the JAX
    ``imdd_dsp_chain_batch``).

    Per signal: DC removal (photodiode currents are unipolar; the slicer
    expects zero-mean PAM), symbol-rate sampling ``x[::SpS_in][:nSym]``, then
    the equalizer: :func:`~opticommpy_torch.kernels.dfe.dfe_kernel` with
    ``eq="dfe"``, else :func:`~opticommpy_torch.kernels.dfe.ffe_kernel`,
    every signal's recurrence in one K13 launch on CUDA (its plain version
    for CPU tensors). Each signal is normalized on its own, so one signal's
    output does not depend on the batch it rides in.

    Parameters
    ----------
    i_rx_batch : (B, N) real photodiode currents at ``SpS_in``
        samples/symbol (a single (N,) stream is also accepted); a NumPy
        array goes to the CUDA device, a tensor stays on its own.
    symb_ref_batch : (B, nSym) reference PAM symbols (any scale).

    Returns
    -------
    (y (B, nSym) equalized symbols: complex64 from the DFE, real from the
    FFE; mse (B, nSym) per-symbol squared error).
    """
    from opticommpy_torch.dsp.equalization import DFEConfig, FFEConfig
    from opticommpy_torch.kernels.dfe import dfe_kernel, ffe_kernel

    cfg = config
    x = as_device_tensor(i_rx_batch)
    symb_ref_batch = torch.as_tensor(symb_ref_batch).to(x.device)
    squeeze = x.ndim == 1
    if squeeze:
        x, symb_ref_batch = x[None], symb_ref_batch[None]
    x = x - row_mean(x)[:, None]
    n_sym = symb_ref_batch.shape[1]
    samples = x[:, ::cfg.SpS_in][:, :n_sym]
    if cfg.eq == "dfe":
        eq_cfg = DFEConfig(nTapsFF=cfg.nTapsFF, nTapsFB=cfg.nTapsFB, mu=cfg.mu,
                           nTrain=cfg.nTrain, M=cfg.M, constType="pam",
                           trainingMode=cfg.trainingMode)
        y, _, _, mse = dfe_kernel(samples, symb_ref_batch, eq_cfg)
    else:
        eq_cfg = FFEConfig(nTaps=cfg.nTapsFF, mu=cfg.mu, nTrain=cfg.nTrain, M=cfg.M,
                           constType="pam", trainingMode=cfg.trainingMode)
        y, _, mse = ffe_kernel(samples, symb_ref_batch, eq_cfg)
    if squeeze:
        return y[0], mse[0]
    return y, mse
