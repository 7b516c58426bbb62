"""Reference-compatible API surface (OptiCommPy names) over the PyTorch port
(port of ``opticommpy_tpu/compat.py``).

Every public function of the reference ``optic`` package is exposed here under
its original camelCase name, delegating to the port's implementations, so
a reference user can port scripts with an import change::

    from opticommpy_torch import compat as optic
    const = optic.grayMapping(16, 'qam')
    Eo = optic.manakovSSF(Ei, param)

Functions that take the reference's mutable ``parameters`` bag accept either
the frozen config dataclasses or any object with the reference's attribute
names (converted via :func:`params_to_config`). Stochastic functions accept a
``seed`` keyword, converted to a ``torch.Generator`` seeded so (0 when none,
the JAX package's ``PRNGKey(0)``) on the main input's device, or on the
default device (the CUDA device) for a function without a tensor input.
The NumPy shims of the reference's internal kernels are host code, as in
the JAX package; plot aliases import matplotlib only when called.
"""

import dataclasses

import numpy as np
import torch

from opticommpy_torch.comm import fec as _fec
from opticommpy_torch.comm import metrics as _metrics
from opticommpy_torch.comm import modulation as _mod
from opticommpy_torch.comm import ofdm as _ofdm
from opticommpy_torch.comm import sources as _sources
from opticommpy_torch.comm.modulation import _host
from opticommpy_torch.dsp import carrier_recovery as _cpr
from opticommpy_torch.dsp import clock_recovery as _clk
from opticommpy_torch.dsp import equalization as _eq
from opticommpy_torch.dsp import synchronization as _sync
from opticommpy_torch.models import amplification as _amp
from opticommpy_torch.models import channels as _ch
from opticommpy_torch.models import config as _cfg
from opticommpy_torch.models import devices as _dev
from opticommpy_torch.models import perturbation as _pert
from opticommpy_torch.models import tx as _tx
from opticommpy_torch.ops import filtering as _filt
from opticommpy_torch.ops import modulator as _opmod
from opticommpy_torch.ops import noise as _noise
from opticommpy_torch.ops import signal as _sig
from opticommpy_torch.ops import whitening as _whit
from opticommpy_torch.utils import bits as _bits
from opticommpy_torch.utils import units as _units
from opticommpy_torch.utils.rng import as_device_tensor, ensure_generator


class parameters:
    """Attribute-bag parameter struct (reference optic/utils.py:29).

    Provided for drop-in ergonomics; internally converted to the frozen
    config dataclasses.
    """

    def view(self):
        for attr, value in self.__dict__.items():
            print(f"{attr}: {value}")

    @staticmethod
    def _eng(value):
        # engineering notation (powers of 1000) for readable tables
        import numbers

        if isinstance(value, numbers.Real) and not isinstance(value, bool):
            v = float(value)
            if v != 0 and (abs(v) >= 1e4 or abs(v) < 1e-4):
                import math

                e = int(math.floor(math.log10(abs(v)) / 3) * 3)
                pre = {-15: "f", -12: "p", -9: "n", -6: "u", -3: "m", 0: "",
                       3: "k", 6: "M", 9: "G", 12: "T", 15: "P"}.get(e)
                if pre is not None:
                    return f"{v / 10**e:.1f} {pre}"
        return value

    def _rows(self):
        for name, value in vars(self).items():
            if isinstance(value, (list, tuple, np.ndarray)):
                yield name, "Array"
            else:
                yield name, self._eng(value)

    def table(self):
        """Print a Markdown table of the parameters (reference utils.py:86)."""
        out = "| Parameter Name | Value |\n|---|---|\n"
        out += "".join(f"| {n} | {v} |\n" for n, v in self._rows())
        print(out)

    def latex_table(self):
        """Print a LaTeX tabular of the parameters (reference utils.py:109)."""
        out = "\\begin{tabular}{|c|c|}\n\\hline\n"
        out += "Parameter Name & Value \\\\\n\\hline\n"
        out += "".join(f"{n} & {v} \\\\\n\\hline\n" for n, v in self._rows())
        out += "\\end{tabular}"
        print(out)

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)


def params_to_config(param, config_cls, **overrides):
    """Build a frozen config from any object with reference attribute names."""
    fields = {f.name: f for f in dataclasses.fields(config_cls)}
    kwargs = {}
    for name in fields:
        if name in overrides:
            kwargs[name] = overrides[name]
        elif param is not None and hasattr(param, name):
            kwargs[name] = getattr(param, name)
    return config_cls(**kwargs)


def _key(seed, like=None):
    """A ``torch.Generator`` seeded ``seed`` (0 when None) on the device of
    ``like`` when it is a tensor, else on the default device."""
    dev = like.device if isinstance(like, torch.Tensor) else None
    return ensure_generator(0 if seed is None else seed, dev)


# --- utils -----------------------------------------------------------------
lin2dB = _units.lin2db
dB2lin = _units.db2lin
dBm2W = _units.dbm2w
ber2Qfactor = _units.ber2qfactor
llr2bitProb = _units.llr2bit_prob
dec2bitarray = _bits.dec2bitarray
bitarray2dec = _bits.bitarray2dec


# --- dsp.core --------------------------------------------------------------
sigPow = _sig.sig_pow
signalPower = _sig.signal_power
pnorm = _sig.pnorm
anorm = _sig.anorm
upsample = _sig.upsample
decimate = lambda Ei, param: _sig.decimate(Ei, param.SpSin, getattr(param, "SpSout", 1))
finddelay = _sig.finddelay
symbolSync = _sig.symbol_sync
movingAverage = _sig.moving_average
delaySignal = _sig.delay_signal
freqShift = _sig.freq_shift
firFilter = _filt.fir_filter
blockwiseFFTConv = lambda x, h, NFFT=None, freqDomainFilter=False: _filt.overlap_save(
    x, h, nfft=NFFT, freq_domain_filter=freqDomainFilter
)
rrcFilterTaps = _filt.rrc_taps
rcFilterTaps = _filt.rc_taps
lowPassFIR = lambda fc, fs, N, typeF="rect": _filt.lowpass_fir(fc, fs, N, typeF)
calcMZM = _opmod.calc_mzm
calcPM = _opmod.calc_pm
levinson = _whit.levinson
autocorr = _whit.autocorr
estimateWhiteningFilter = _whit.estimate_whitening_filter


def pulseShape(param):
    return _filt.pulse_shape(
        getattr(param, "pulseType", "rrc"),
        getattr(param, "SpS", 2),
        getattr(param, "nFilterTaps", 256),
        getattr(param, "rollOff", 0.1),
    )


def resample(Ei, param):
    return _sig.resample(
        Ei, getattr(param, "inFs", 2), getattr(param, "outFs", 2),
        getattr(param, "N", 501),
    )


def clockSamplingInterp(x, inFs=1, outFs=1, jitter=0, seed=None):
    return _sig.clock_sampling_interp(x, inFs, outFs, jitter, _key(seed, x))


def quantizer(x, nBits=16, maxV=1, minV=-1):
    return _sig.quantizer(x, nBits, maxV, minV)


def gaussianComplexNoise(shapeOut, sigma2=1.0, seed=None):
    return _noise.gaussian_complex_noise(_key(seed), shapeOut, sigma2)


def gaussianNoise(shapeOut, sigma2=1.0, seed=None):
    return _noise.gaussian_noise(_key(seed), shapeOut, sigma2)


def phaseNoise(lw, Nsamples, Ts, seed=None):
    return _noise.phase_noise(_key(seed), lw, Nsamples, Ts)


def iqMixing(sig, param):
    return _sig.iq_mixing(
        sig, getattr(param, "Fs", 1.0), getattr(param, "ampImb", 0.0),
        getattr(param, "phaseImb", 0.0), getattr(param, "timeSkew", 0.0),
    )


# --- comm.modulation -------------------------------------------------------
grayCode = _mod.gray_code
grayMapping = _mod.gray_mapping
pamConst = _mod.pam_const
qamConst = _mod.qam_const
pskConst = _mod.psk_const
apskConst = _mod.apsk_const
minEuclid = _mod.min_euclid
demap = _mod.demap
modulateGray = _mod.modulate_gray
demodulateGray = _mod.demodulate_gray
detector = _mod.detector
def softMapper(llr, M, constType, prec=None):
    return _mod.soft_mapper(llr, M, constType)
softEstimator = _mod.soft_estimator
mlse = _mod.mlse


# --- comm.sources ----------------------------------------------------------
def bitSource(param):
    mode = getattr(param, "mode", "random")
    n_bits = getattr(param, "nBits", 1000)
    seed = getattr(param, "seed", None)
    if mode == "random":
        return _sources.bit_source(_key(seed), n_bits, "random")
    order = getattr(param, "order", 23)
    return _sources.bit_source(seed if isinstance(seed, int) else 1, n_bits,
                               "prbs", order)


prbsGenerator = _sources.prbs_generator
cazacSequence = _sources.cazac_sequence


def symbolSource(param):
    return _sources.symbol_source(
        _key(getattr(param, "seed", None)),
        getattr(param, "nSymbols", 1000),
        getattr(param, "M", 4),
        getattr(param, "constType", "qam"),
        getattr(param, "dist", "uniform"),
        getattr(param, "shapingFactor", 0.0),
        getattr(param, "px", None),
    )


# --- comm.metrics ----------------------------------------------------------
def bert(Irx, bitsTx=None, seed=123):
    """Reference metrics.py:37 signature: bitsTx=None regenerates the bit
    sequence from ``seed`` (matches ``bitSource`` with the same seed)."""
    if bitsTx is None:
        bitsTx = _sources.bit_source(_key(seed, Irx), len(Irx), "random")
    return _metrics.bert(Irx, bitsTx)
fastBERcalc = _metrics.fast_ber_calc
calcLLR = _metrics.calc_llr
calcExtrLLR = _metrics.calc_extr_llr
monteCarloGMI = _metrics.monte_carlo_gmi
monteCarloMI = _metrics.monte_carlo_mi
calcMI = _metrics.calc_mi
Qfunc = _metrics.qfunc


def calcEVM(symb, M, constType, symbTx=None):
    return _metrics.calc_evm(symb, M, constType, symb_tx=symbTx)
theoryBER = _metrics.theory_ber
theoryMI = _metrics.theory_mi
GN_Model_NyquistWDM = _metrics.gn_model_nyquist_wdm
GNmodel_OSNR = _metrics.gn_model_osnr
calcLinOSNR = _metrics.calc_lin_osnr


# --- comm.ofdm -------------------------------------------------------------
hermit = _ofdm.hermit
zeroPad = _ofdm.zero_pad
calcSymbolRate = _ofdm.calc_symbol_rate


def modulateOFDM(symb, param):
    return _ofdm.modulate_ofdm(symb, params_to_config(param, _ofdm.OFDMConfig))


def demodulateOFDM(sig, param, returnChannel=False):
    return _ofdm.demodulate_ofdm(
        sig, params_to_config(param, _ofdm.OFDMConfig), returnChannel
    )


# --- comm.fec --------------------------------------------------------------
par2gen = _fec.par2gen
gaussElim = _fec.gauss_elim_gf2
inverseMatrixGF2 = _fec.inverse_matrix_gf2
triangularize = _fec.triangularize_gf2
triangP1P2 = _fec.triang_p1p2
readAlist = _fec.read_alist
writeAlist = _fec.write_alist
parseAlist = _fec.parse_alist
hammingParityCheckMatrix = _fec.hamming_parity_check_matrix
encodeHamming = lambda bits, param: _fec.encode_hamming(
    bits, getattr(param, "m", 3), getattr(param, "extended", False)
)[0]


def encodeLDPC(bits, param):
    """LDPC encode dispatch (reference fec.py:153).

    Where the reference loads H from its shipped ALIST files by
    (mode, n, R) filename (fec.py:197), a missing ``param.H`` here is
    CONSTRUCTED from the standard's tables (comm/codes.py) — no data files.
    """
    mode = getattr(param, "mode", "DVBS2")
    H = getattr(param, "H", None)
    if mode == "DVBS2":
        if H is None:
            from opticommpy_torch.comm.codes import ldpc_edges

            edges = ldpc_edges(mode="DVBS2", n=getattr(param, "n", 64800),
                               R=getattr(param, "R", "4/5"))
            return _fec.encode_ldpc(bits, edges=edges,
                                    config=_fec.LDPCConfig(mode="DVBS2"))
        return _fec.encode_ldpc(bits, H=H, config=_fec.LDPCConfig(mode="DVBS2"))
    if H is None:
        from opticommpy_torch.comm.codes import ldpc_parity_matrix

        H = ldpc_parity_matrix(mode=mode, n=getattr(param, "n", 648),
                               R=getattr(param, "R", "1/2"))
        try:
            param.H = H
        except AttributeError:
            pass
    P1 = getattr(param, "P1", None)
    P2 = getattr(param, "P2", None)
    if P1 is not None:
        return _fec.encode_ldpc(bits, H=H, P1=P1, P2=P2,
                                config=_fec.LDPCConfig(mode="triang"))
    return _fec.encode_ldpc(bits, H=H, G=getattr(param, "G", None),
                            config=_fec.LDPCConfig(mode="G"))


def decodeLDPC(llrs, param):
    H = getattr(param, "H", None)
    graph = None
    if H is None:
        graph, _ = _fec.standard_ldpc(
            mode=getattr(param, "mode", "DVBS2"),
            n=getattr(param, "n", 64800), R=getattr(param, "R", "4/5"))
    return _fec.decode_ldpc(
        llrs, H=H, graph=graph,
        config=_fec.LDPCConfig(
            maxIter=getattr(param, "maxIter", 25),
            alg=getattr(param, "alg", "SPA"),
            # the reference decoder always breaks on parity success
            # (fec.py:494-497) — its earlyExit is not configurable, so
            # the compat surface defaults it ON for the standard
            # lifted/QC graphs that implement it when a card is present
            # (the JAX package's rule: on accelerators only). Custom-H
            # graphs default off (they would warn + run fixed)
            earlyExit=bool(getattr(
                param, "earlyExit",
                graph is not None and torch.cuda.is_available())),
        ),
    )


# --- models.devices --------------------------------------------------------
pm = _dev.pm


def mzm(Ai, u, param=None):
    return _dev.mzm(Ai, u, params_to_config(param, _cfg.MZMConfig))


def iqm(Ai, u, param=None):
    return _dev.iqm(Ai, u, params_to_config(param, _cfg.IQMConfig))


pbs = _dev.pbs
voa = _dev.voa
opticalHybrid2x4 = _dev.optical_hybrid_2x4


def photodiode(E, param=None):
    cfg = params_to_config(param, _cfg.PhotodiodeConfig)
    return _dev.photodiode(E, cfg, _key(getattr(param, "seed", None), E))


def balancedPD(E1, E2, param=None):
    cfg = params_to_config(param, _cfg.PhotodiodeConfig)
    return _dev.balanced_pd(E1, E2, cfg, _key(getattr(param, "seed", None), E1))


def coherentReceiver(Es, Elo, paramFE=None, paramPD=None):
    fe = params_to_config(paramFE, _cfg.CoherentFrontendConfig)
    pd = params_to_config(paramPD, _cfg.PhotodiodeConfig,
                          Fs=fe.Fs) if paramPD is not None else None
    return _dev.coherent_receiver(Es, Elo, fe, pd,
                                  _key(getattr(paramFE, "seed", None), Es))


def pdmCoherentReceiver(Es, Elo, paramFE=None, paramPD=None):
    fe = params_to_config(paramFE, _cfg.PDMFrontendConfig)
    pd = params_to_config(paramPD, _cfg.PhotodiodeConfig,
                          Fs=fe.Fs) if paramPD is not None else None
    return _dev.pdm_coherent_receiver(Es, Elo, fe, pd,
                                      _key(getattr(paramFE, "seed", None), Es))


def edfa(Ei, param=None):
    cfg = params_to_config(param, _cfg.EDFAConfig)
    return _dev.edfa(Ei, cfg, _key(getattr(param, "seed", None), Ei))


def basicLaserModel(param=None):
    cfg = params_to_config(param, _cfg.LaserConfig)
    return _dev.basic_laser_model(cfg, _key(getattr(param, "seed", None)))


def adc(sigIn, param):
    return _dev.adc(sigIn, params_to_config(param, _cfg.ADCConfig),
                    _key(getattr(param, "seed", None), sigIn))


def dac(sigIn, param):
    return _dev.dac(sigIn, params_to_config(param, _cfg.DACConfig),
                    _key(getattr(param, "seed", None), sigIn))


# --- models.channels -------------------------------------------------------
def linearFiberChannel(Ei, param):
    return _ch.linear_fiber_channel(Ei, params_to_config(param, _cfg.LinearFiberConfig))


def _prec_str(param):
    """Reference `prec` is a numpy dtype (channels.py:312) -> 'c64'/'c128'."""
    prec = getattr(param, "prec", None)
    if prec is None or isinstance(prec, str):
        return {}
    return {"prec": "c128" if np.dtype(prec) == np.complex128 else "c64"}


def ssfm(Ei, param):
    cfg = params_to_config(param, _cfg.SSFMConfig, **_prec_str(param))
    return _ch.ssfm(Ei, cfg, _key(getattr(param, "seed", None), Ei))


def manakovSSF(Ei, param):
    cfg = params_to_config(param, _cfg.SSFMConfig, **_prec_str(param))
    return _ch.manakov_ssf(Ei, cfg, _key(getattr(param, "seed", None), Ei))


nlinPhaseRot = _ch.nlin_phase_rot
convergenceCondition = lambda ex_fd, ey_fd, ex_c, ey_c: _ch.convergence_condition(
    torch.stack([as_device_tensor(ex_fd), as_device_tensor(ey_fd)]),
    torch.stack([as_device_tensor(ex_c), as_device_tensor(ey_c)]),
)


def awgn(sig, param=None, **kw):
    cfg = params_to_config(param, _cfg.AWGNConfig, **kw)
    return _ch.awgn(sig, _key(getattr(param, "seed", None), sig), cfg)


# --- models.tx -------------------------------------------------------------
def simpleWDMTx(param):
    cfg = params_to_config(param, _tx.WDMTxConfig)
    if hasattr(param, "powerPerChannel") and np.isscalar(param.powerPerChannel):
        cfg = dataclasses.replace(cfg, powerPerChannel=(float(param.powerPerChannel),))
    return _tx.simple_wdm_tx(_key(getattr(param, "seed", None)), cfg)


def pamTransmitter(param):
    cfg = params_to_config(param, _tx.PAMTxConfig)
    return _tx.pam_transmitter(_key(getattr(param, "seed", None)), cfg)


# --- models.amplification --------------------------------------------------
def edfaSM(Ei, Fs, Fc, param_edfa):
    cfg = params_to_config(param_edfa, _amp.EDFASMConfig)
    return _amp.edfa_sm(Ei, Fs, Fc, cfg)


get_spectrum = _amp.get_spectrum


# --- models.perturbation ---------------------------------------------------
def perturbationNLIN(Ein, param):
    cfg = params_to_config(param, _pert.PerturbationConfig)
    return _pert.perturbation_nlin(Ein, cfg)


calcPertCoeffMatrix = lambda param: _pert.calc_pert_coeff_matrix(
    params_to_config(param, _pert.PerturbationConfig)
)


# --- dsp.equalization ------------------------------------------------------
def edc(sigIn, param):
    return _eq.edc(sigIn, params_to_config(param, _eq.EDCConfig))


def mimoAdaptEqualizer(sigIn, param=None, symbRef=None):
    cfg = _eq.MIMOEqualizerConfig() if param is None else _eq.MIMOEqualizerConfig(
        numIter=getattr(param, "numIter", 1),
        nTaps=getattr(param, "nTaps", 15),
        mu=tuple(np.atleast_1d(getattr(param, "mu", [1e-3]))),
        lambdaRLS=getattr(param, "lambdaRLS", 0.99),
        SpS=getattr(param, "SpS", 2),
        L=tuple(getattr(param, "L")) if getattr(param, "L", None) else None,
        storeCoeff=getattr(param, "storeCoeff", False),
        runWL=getattr(param, "runWL", False),
        alg=tuple(np.atleast_1d(getattr(param, "alg", ["nlms"]))),
        constType=getattr(param, "constType", "qam"),
        M=getattr(param, "M", 4),
        shapingFactor=getattr(param, "shapingFactor", 0.0),
        # extension (not a reference param): param.backend = 'pallas'
        # runs each supported training stage on the Hopper kernel
        blockUpdate=getattr(param, "blockUpdate", 1),
        backend=getattr(param, "backend", "scan"),
    )
    return _eq.mimo_adapt_equalizer(
        sigIn, cfg, symb_ref=symbRef,
        return_results=getattr(param, "returnResults", False),
    )


def manakovDBP(Ei, param):
    return _eq.manakov_dbp(Ei, params_to_config(param, _cfg.SSFMConfig))


def dfe(sigIn, symbRef, param):
    return _eq.dfe(sigIn, symbRef, params_to_config(param, _eq.DFEConfig))


def ffe(sigIn, symbRef, param):
    return _eq.ffe(sigIn, symbRef, params_to_config(param, _eq.FFEConfig))


def volterra(sigIn, symbRef, param):
    return _eq.volterra(sigIn, symbRef, params_to_config(param, _eq.VolterraConfig))


# --- dsp.carrierRecovery / clockRecovery / synchronization -----------------
def cpr(Ei, param=None, symbTx=None):
    cfg = params_to_config(param, _cpr.CPRConfig)
    return _cpr.cpr(Ei, cfg, symb_tx=symbTx,
                    pilot_ind=getattr(param, "pilotInd", None),
                    return_phases=getattr(param, "returnPhases", False))


bps = _cpr.bps
ddpll = _cpr.ddpll
viterbi = _cpr.viterbi
fourthPowerFOE = _cpr.fourth_power_foe


def gardnerClockRecovery(Ei, param=None):
    cfg = params_to_config(param, _clk.ClockRecoveryConfig)
    return _clk.gardner_clock_recovery(
        Ei, cfg, return_timing=getattr(param, "returnTiming", False)
    )


gardnerTED = _clk.gardner_ted
gardnerTEDnyquist = _clk.gardner_ted_nyquist
interpolator = _clk.interpolator
calcClockDrift = _clk.calc_clock_drift


def syncDataSequences(rx, tx, param):
    return _sync.sync_data_sequences(rx, tx, params_to_config(param, _sync.SyncConfig))


def OSA(x, Fs, Fc=193.1e12):
    from opticommpy_torch.plot import osa as _osa

    return _osa(x, Fs, Fc)


# --- remaining reference-name aliases (utils/fec/metrics/plot/tx helpers) ---

decimal2bitarray = _bits.dec2bitarray  # scalar variant, utils.py:229
par2gen = _fec.par2gen
inverseMatrixGF2 = _fec.inverse_matrix_gf2
triangP1P2 = _fec.triang_p1p2
summarizeAlistFolder = _fec.summarize_alist_folder
plotBinaryMatrix = _fec.plot_binary_matrix


def GN_Model_NyquistWDM(Rs, Nch, Df, alpha, gamma, Ls, Ns, Ptx_dBm, D, Bref, Fc):
    """Reference metrics.py:851 argument order."""
    return _metrics.gn_model_nyquist_wdm(Rs, Nch, Df, alpha, gamma, Ls, Ns,
                                         Ptx_dBm, D, Bref, Fc)


ASE_NyquistWDM = _metrics.ase_nyquist_wdm


def GNmodel_OSNR(Rs, Nch, Df, Ptx, paramCh=None, Bref=12.5e9):
    """Reference metrics.py:917 signature (paramCh attribute bag)."""
    p = paramCh if paramCh is not None else parameters()
    return _metrics.gn_model_osnr(
        Rs, Nch, Df, Ptx,
        ltotal=getattr(p, "Ltotal", 800), l_span=getattr(p, "Lspan", 50),
        alpha_db=getattr(p, "alpha", 0.2), disp=getattr(p, "D", 16),
        gamma_=getattr(p, "gamma", 1.3), fc=getattr(p, "Fc", 193.1e12),
        nf_db=getattr(p, "NF", 4.5), b_ref=Bref,
    )


def setPowerforParSSFM(sig, powers):
    return _tx.set_power_for_par_ssfm(sig, powers, verbose=True)


def _plot_alias(name):
    import opticommpy_torch.plot as _plot

    return getattr(_plot, name)


def pconst(*args, **kwargs):
    return _plot_alias("pconst")(*args, **kwargs)


def constHist(*args, **kwargs):
    return _plot_alias("const_hist")(*args, **kwargs)


def plotColoredConst(*args, **kwargs):
    return _plot_alias("plot_colored_const")(*args, **kwargs)


def plotDecisionBoundaries(*args, **kwargs):
    return _plot_alias("plot_decision_boundaries")(*args, **kwargs)


def eyediagram(*args, **kwargs):
    return _plot_alias("eyediagram")(*args, **kwargs)


def plotPSD(*args, **kwargs):
    return _plot_alias("plot_psd")(*args, **kwargs)


def animateConstGIF(*args, **kwargs):
    return _plot_alias("animate_const_gif")(*args, **kwargs)


edfParams = _amp.edf_params
getSpectrum = _amp.get_spectrum


# --- reference-internal kernels exposed for line-by-line API parity --------
# The reference publishes its Numba kernels and solver internals as part of
# its API (users call them directly in notebooks). The fast paths live in
# opticommpy_torch.dsp / .comm / .models; the shims below are host-side NumPy
# forms with the reference's exact signatures.


def dotNumba(a, b):
    """Dot product (reference utils.py:282)."""
    return np.dot(a, b)


def checkGPU():
    """Accelerator probe (reference dsp/coreGPU.py:11): whether a CUDA
    device is present (``torch.cuda.is_available()``)."""
    return torch.cuda.is_available()


def minR(R, x):
    """Index of min |R - x| (reference comm/metrics.py:751)."""
    return int(np.argmin(np.abs(np.asarray(R) - x)))


def condEntropy(yI, yQ, const, pX, ind, sigma):
    """Conditional-entropy quadrature integrand (reference metrics.py:689)."""
    return _metrics._cond_entropy(yI, yQ, const, pX, ind, sigma)


def randomCmap(nColors=100, low=0.1, high=0.99, seed=None):
    """Random categorical colormap (reference plot.py:639)."""
    from matplotlib.colors import ListedColormap

    rng = np.random.default_rng(seed)
    return ListedColormap(rng.uniform(low, high, size=(nColors, 3)))


def bpsGPU(Ei, N, constSymb, B):
    """GPU blind phase search (reference carrierRecoveryGPU.py:17).

    The port has one entry for the CPU and the card alike (dsp.bps); this
    alias keeps reference call sites working.
    """
    return _cpr.bps(Ei, N, constSymb, B)


def calcNLINperturbation(C_ifwm, C_ixpm, C_ispm, x, y, prec=np.complex64):
    """First-order NLIN perturbation (reference perturbation.py:200)."""
    dx, dy, phi_x, phi_y = _pert.calc_nlin_perturbation(C_ifwm, C_ixpm,
                                                        C_ispm, x, y)
    return (_host(dx).astype(prec), _host(dy).astype(prec), _host(phi_x), _host(phi_y))


def calcNLINperturbationSimplified(C_ifwm, C_ixpm, C_ispm, x, y,
                                   coeffTol=-20, prec=np.complex64):
    """Coefficient-pruned NLIN perturbation (reference perturbation.py:342)."""
    dx, dy, phi_x, phi_y, _, _ = _pert.calc_nlin_perturbation_simplified(
        C_ifwm, C_ixpm, C_ispm, x, y, coeff_tol=coeffTol)
    return (_host(dx).astype(prec), _host(dy).astype(prec), _host(phi_x), _host(phi_y))


# --- FEC encoder/decoder kernels (reference fec.py:254-683) -----------------


def encoder(G, bits, systematic=True):
    """GF(2) generator-matrix encoder (reference fec.py:302).

    G: (k, n); bits: (k, N). Returns (n, N) codeword columns. The GF(2)
    matvec is one integer matmul mod 2 instead of the reference's triple loop.
    """
    G = (np.asarray(G) % 2).astype(np.uint8)
    bits = (np.asarray(bits) % 2).astype(np.uint8)
    k = G.shape[0]
    if systematic:
        parity = (G[:, k:].astype(np.int64).T @ bits) % 2
        return np.vstack([bits, parity.astype(np.uint8)])
    return ((G.astype(np.int64).T @ bits) % 2).astype(np.uint8)


def encodeDVBS2(bits, A):
    """DVB-S2 recursive LDPC encoder (reference fec.py:254).

    bits: (k, N); A: (m, k) first k columns of H. The per-codeword recursive
    parity accumulation codewords[k+i] = parity[i] ^ codewords[k+i-1] is a
    prefix XOR = cumulative sum mod 2 along the parity axis.
    """
    bits = (np.asarray(bits) % 2).astype(np.uint8)
    A = (np.asarray(A) % 2).astype(np.int64)
    parity = (A @ bits) % 2
    parity = (np.cumsum(parity, axis=0) % 2).astype(np.uint8)
    return np.vstack([bits, parity])


def encodeTriang(bits, P1, P2):
    """Richardson-Urbanke triangular encoder (reference fec.py:1019).

    bits: (k, N); P1: (m1, k); P2: (m2, k). Returns (k+m1+m2, N).
    """
    bits = (np.asarray(bits) % 2).astype(np.uint8)
    p1 = ((np.asarray(P1) % 2).astype(np.int64) @ bits) % 2
    p2 = ((np.asarray(P2) % 2).astype(np.int64) @ bits) % 2
    return np.vstack([bits, p1.astype(np.uint8), p2.astype(np.uint8)])


def _bp_from_adjacency(llrs, checkNodes, maxIter, alg):
    """Run our padded-edge BP given the reference's check-node adjacency.
    A tensor keeps its device; NumPy LLRs go to the CUDA device."""
    llrs = torch.atleast_2d(as_device_tensor(llrs).to(torch.float32))
    if llrs.shape[0] == 1:
        llrs = llrs.T
    n = llrs.shape[0]
    m = len(checkNodes)
    H = np.zeros((m, n), dtype=np.uint8)
    for i, vars_i in enumerate(checkNodes):
        H[i, np.asarray(vars_i, dtype=np.int64)] = 1
    graph = _fec.ldpc_graph(H)
    out_llr, n_iters, fail = _fec._bp_decode_batch(
        llrs.contiguous(), graph["cn_idx"], graph["cn_mask"], graph["vn_edge"],
        n, int(maxIter), alg,
    )
    return (_host(out_llr), int(np.max(_host(n_iters))), _host(fail).astype(np.uint8))


def sumProductAlgorithm(llrs, checkNodes, varNodes, maxIter, prec=np.float32):
    """Sum-product BP decoder (reference fec.py:347).

    llrs: (n, numCodewords); checkNodes: adjacency (list over check nodes of
    variable-index arrays); varNodes is accepted for signature parity (the
    padded edge arrays are derived from checkNodes alone). Returns
    (finalLLR, numIter, frameDecodingFail) like the reference.
    """
    del varNodes
    out, n_iter, fail = _bp_from_adjacency(llrs, checkNodes, maxIter, "SPA")
    return out.astype(prec), n_iter, fail


def minSumAlgorithm(llrs, checkNodes, varNodes, maxIter, prec=np.float32):
    """Min-sum BP decoder (reference fec.py:505). See sumProductAlgorithm."""
    del varNodes
    out, n_iter, fail = _bp_from_adjacency(llrs, checkNodes, maxIter, "MSA")
    return out.astype(prec), n_iter, fail


# --- physical-EDFA solver internals (reference amplification.py:139-415) ---
# These operate on the resolved properties dict produced by
# opticommpy_torch.models.amplification.edf_params (the rebuild's equivalent of
# the reference's `properties` bag; same physics, dict layout).

get_mode_radius = _amp.get_mode_radius


def getN2Pop(P, properties):
    """Metastable-level population (reference amplification.py:197)."""
    return _amp._n2_pop(P, properties)


def gilesSpectrum(z, P, properties):
    """Spectral Giles propagation RHS (reference amplification.py:139)."""
    return _amp._giles_rhs(z, P, properties)


def gilesSpatial(z, P, properties, param_edf=None):
    """Spatial Giles propagation RHS (reference amplification.py:163)."""
    del param_edf  # folded into the properties dict here
    return _amp._giles_rhs(z, P, properties)


def getOverlapInt(n2_norm, properties, param_edf=None):
    """Field/doping overlap integral (reference amplification.py:229)."""
    del param_edf
    dop = (2 * np.pi * properties["r"] * n2_norm) * properties["dr"]
    return np.trapezoid(properties["i_k"] * dop[:, None], axis=0)


def updtCnst(properties):
    """Precompute Giles solver constants (reference amplification.py:273)."""
    return _amp._make_consts(properties)


def edfaArgs(param_edfa):
    """Resolve EDFA defaults into the parameter bag (reference :359)."""
    cfg = params_to_config(param_edfa, _amp.EDFASMConfig)
    for f in dataclasses.fields(cfg):
        if not hasattr(param_edfa, f.name):
            setattr(param_edfa, f.name, getattr(cfg, f.name))
    return param_edfa


# --- MIMO adaptive-equalizer update rules (reference equalization.py:519-973)
# Host-side NumPy single-step updates with the reference's exact signatures
# and tap layout: H is (nModes^2, nTaps), row N*nModes+m = filter from input
# mode N to output mode m. The multi-stage path is dsp.mimo_adapt_equalizer;
# these shims serve direct call sites.


def _blocks(H, nModes):
    """(nModes, nModes, nTaps) view of the reference tap layout."""
    return H.reshape(nModes, nModes, -1)


def nlmsUp(sigIn, symbRef, outEq, mu, H, H_, nModes, runWL, prec=np.complex64):
    """NLMS tap update (reference equalization.py:519)."""
    err = (np.asarray(symbRef).reshape(1, -1) - outEq.T).astype(prec)
    x = np.asarray(sigIn).astype(prec)
    Hb, H_b = _blocks(H, nModes), _blocks(H_, nModes)
    for N in range(nModes):
        inAdapt = x[:, N] / np.sum(np.abs(x[:, N]) ** 2)
        Hb[N] += mu * err[0][:, None] * np.conj(inAdapt)[None, :]
        if runWL:
            H_b[N] += mu * err[0][:, None] * inAdapt[None, :]
    return H, H_, np.abs(err[0]) ** 2


def ddlmsUp(sigIn, constSymb, outEq, mu, H, H_, nModes, runWL,
            prec=np.complex64):
    """Decision-directed LMS tap update (reference equalization.py:647)."""
    out = outEq.T[0]
    decided = np.asarray(constSymb)[
        np.argmin(np.abs(out[:, None] - np.asarray(constSymb)[None, :]), axis=1)
    ]
    err = (decided - out).astype(prec)
    x = np.asarray(sigIn).astype(prec)
    Hb, H_b = _blocks(H, nModes), _blocks(H_, nModes)
    for N in range(nModes):
        Hb[N] += mu * err[:, None] * np.conj(x[:, N])[None, :]
        if runWL:
            H_b[N] += mu * err[:, None] * x[:, N][None, :]
    return H, H_, np.abs(err) ** 2


def cmaUp(sigIn, R, outEq, mu, H, H_, nModes, runWL, prec=np.complex64):
    """CMA tap update (reference equalization.py:788)."""
    out = outEq.T[0]
    err = (np.asarray(R).reshape(-1)[:nModes] - np.abs(out) ** 2).astype(prec)
    g = err * out
    x = np.asarray(sigIn).astype(prec)
    Hb, H_b = _blocks(H, nModes), _blocks(H_, nModes)
    for N in range(nModes):
        Hb[N] += mu * g[:, None] * np.conj(x[:, N])[None, :]
        if runWL:
            H_b[N] += mu * g[:, None] * x[:, N][None, :]
    return H, H_, np.abs(err) ** 2


def rdeUp(sigIn, R, outEq, mu, H, H_, nModes, runWL, prec=np.complex64):
    """Radius-directed tap update (reference equalization.py:846)."""
    out = outEq.T[0]
    R = np.asarray(R).reshape(-1)
    decidedR = R[np.argmin(np.abs(R[None, :] - np.abs(out)[:, None]), axis=1)]
    err = (decidedR**2 - np.abs(out) ** 2).astype(prec)
    g = err * out
    x = np.asarray(sigIn).astype(prec)
    Hb, H_b = _blocks(H, nModes), _blocks(H_, nModes)
    for N in range(nModes):
        Hb[N] += mu * g[:, None] * np.conj(x[:, N])[None, :]
        if runWL:
            H_b[N] += mu * g[:, None] * x[:, N][None, :]
    return H, H_, np.abs(err) ** 2


def dardeUp(sigIn, ref, outEq, mu, H, H_, nModes, runWL, prec=np.complex64):
    """Data-aided RDE tap update (reference equalization.py:912)."""
    out = outEq.T[0]
    decidedR = np.abs(np.asarray(ref).reshape(-1)[:nModes])
    err = (decidedR**2 - np.abs(out) ** 2).astype(prec)
    g = err * out
    x = np.asarray(sigIn).astype(prec)
    Hb, H_b = _blocks(H, nModes), _blocks(H_, nModes)
    for N in range(nModes):
        Hb[N] += mu * g[:, None] * np.conj(x[:, N])[None, :]
        if runWL:
            H_b[N] += mu * g[:, None] * x[:, N][None, :]
    return H, H_, np.abs(err) ** 2


def _rls_step(x_N, Sd_, lam, prec):
    """One RLS gain/inverse-correlation update for input mode N."""
    u = np.conj(x_N).reshape(-1, 1).astype(prec)  # the reference's inAdapt
    A = Sd_ @ u
    C = (np.conj(u).T @ A)[0, 0]
    Sd_ = (1.0 / lam) * (Sd_ - (A @ (np.conj(u).T @ Sd_)) / (lam + C))
    gain = (Sd_ @ u).reshape(-1)  # = Sd_ @ inAdapt
    return Sd_.astype(prec), gain


def rlsUp(sigIn, symbRef, outEq, lam, H, Sd, nModes, prec=np.complex64):
    """RLS tap update (reference equalization.py:575).

    Sd is the stacked per-input-mode inverse correlation matrix,
    shape (nModes*nTaps, nTaps) as in the reference.
    """
    nTaps = H.shape[1]
    err = (np.asarray(symbRef).reshape(-1)[:nModes] - outEq.T[0]).astype(prec)
    x = np.asarray(sigIn).astype(prec)
    Hb = _blocks(H, nModes)
    for N in range(nModes):
        Sd_, gain = _rls_step(x[:, N], Sd[N * nTaps:(N + 1) * nTaps], lam, prec)
        Hb[N] += err[:, None] * gain[None, :]
        Sd[N * nTaps:(N + 1) * nTaps] = Sd_
    return H, Sd, np.abs(err) ** 2


def ddrlsUp(sigIn, constSymb, outEq, lam, H, Sd, nModes, prec=np.complex64):
    """Decision-directed RLS tap update (reference equalization.py:711)."""
    out = outEq.T[0]
    decided = np.asarray(constSymb)[
        np.argmin(np.abs(out[:, None] - np.asarray(constSymb)[None, :]), axis=1)
    ]
    nTaps = H.shape[1]
    err = (decided - out).astype(prec)
    x = np.asarray(sigIn).astype(prec)
    Hb = _blocks(H, nModes)
    for N in range(nModes):
        Sd_, gain = _rls_step(x[:, N], Sd[N * nTaps:(N + 1) * nTaps], lam, prec)
        Hb[N] += err[:, None] * gain[None, :]
        Sd[N * nTaps:(N + 1) * nTaps] = Sd_
    return H, Sd, np.abs(err) ** 2


def coreAdaptEq(sigIn, symbRef, SpS, H, H_, L, mu, lambdaRLS, nTaps,
                storeCoeff, runWL, alg, constSymb, prec=np.complex64):
    """Adaptive-equalizer core loop (reference equalization.py:354).

    Host-side NumPy form with the reference's semantics (strictly sequential
    over symbols); the port's path is dsp.mimo_adapt_equalizer (the Hopper
    kernel on the card). Returns (sigOut, H, H_, errSq, Hiter).
    """
    sigIn = np.asarray(sigIn).astype(prec)
    symbRef = np.asarray(symbRef).astype(prec)
    nModes = sigIn.shape[1]
    H = np.array(H, dtype=prec)
    H_ = np.array(H_, dtype=prec)
    sigOut = np.zeros((L, nModes), dtype=prec)
    errSq = np.zeros((nModes, L))
    Hiter = np.zeros((nModes**2, nTaps, L if storeCoeff else 1), dtype=prec)
    Sd = np.tile(np.eye(nTaps, dtype=prec), (nModes, 1))
    constSymb = np.asarray(constSymb).astype(prec)
    Rcma = np.full(nModes, np.mean(np.abs(constSymb) ** 4)
                   / np.mean(np.abs(constSymb) ** 2)).astype(prec)
    Rrde = np.unique(np.abs(constSymb)).astype(prec)
    Hb, H_b = _blocks(H, nModes), _blocks(H_, nModes)
    for ind in range(L):
        win = sigIn[ind * SpS: ind * SpS + nTaps, :]  # (nTaps, nModes)
        outEq = np.einsum("nmt,tn->m", Hb, win).reshape(nModes, 1)
        if runWL:
            outEq += np.einsum("nmt,tn->m", H_b, np.conj(win)).reshape(-1, 1)
        sigOut[ind] = outEq[:, 0]
        if alg == "nlms":
            H, H_, errSq[:, ind] = nlmsUp(win, symbRef[ind], outEq, mu, H, H_,
                                          nModes, runWL, prec)
        elif alg == "cma":
            H, H_, errSq[:, ind] = cmaUp(win, Rcma, outEq, mu, H, H_,
                                         nModes, runWL, prec)
        elif alg == "dd-lms":
            H, H_, errSq[:, ind] = ddlmsUp(win, constSymb, outEq, mu, H, H_,
                                           nModes, runWL, prec)
        elif alg == "rde":
            H, H_, errSq[:, ind] = rdeUp(win, Rrde, outEq, mu, H, H_,
                                         nModes, runWL, prec)
        elif alg == "da-rde":
            H, H_, errSq[:, ind] = dardeUp(win, symbRef[ind], outEq, mu, H, H_,
                                           nModes, runWL, prec)
        elif alg == "rls":
            H, Sd, errSq[:, ind] = rlsUp(win, symbRef[ind], outEq, lambdaRLS,
                                         H, Sd, nModes, prec)
        elif alg == "dd-rls":
            H, Sd, errSq[:, ind] = ddrlsUp(win, constSymb, outEq, lambdaRLS,
                                           H, Sd, nModes, prec)
        elif alg == "static":
            errSq[:, ind] = errSq[:, ind - 1] if ind else 0.0
        else:
            raise ValueError(f"unknown equalizer algorithm: {alg}")
        Hiter[:, :, ind if storeCoeff else 0] = H
    return sigOut, H, H_, errSq, Hiter


# --- SISO FFE/DFE/Volterra cores (reference equalization.py:1301-2143) -----


def _ffe_core_np(sigIn, symbRef, nTaps, SpS, mu, nTrain, prec, constSymb, f,
                 trainingMode, preconvIters, is_complex):
    sigIn = np.asarray(sigIn).reshape(-1).astype(prec)
    symbRef = np.asarray(symbRef).reshape(-1).astype(prec)
    constSymb = np.asarray(constSymb).astype(prec)
    L = len(sigIn)
    N = int((L - nTaps + nTaps % 2) // SpS)
    if f is None:
        f = np.zeros(nTaps, dtype=prec)
        f[nTaps // 2] = 1.0
    f = np.array(f, dtype=prec)
    out = np.zeros(N, dtype=prec)
    mse = np.zeros(N)
    for _ in range(preconvIters):
        for k in range(N):
            xbuf = sigIn[k * SpS: k * SpS + nTaps]
            y = np.dot(f, xbuf)
            out[k] = y
            ref = (symbRef[k] if k < nTrain
                   else constSymb[np.argmin(np.abs(y - constSymb))])
            e = ref - y
            mse[k] = np.abs(e) ** 2
            if trainingMode == "fulltime" or k < nTrain:
                f = f + mu * e * (np.conj(xbuf) if is_complex else xbuf)
    return out, f, mse


def complexValuedFFECore(sigIn, symbRef, nTaps=5, SpS=1, mu=1e-4, nTrain=1000,
                         prec=np.complex64, constSymb=None, f=None,
                         trainingMode="data-aided", preconvIters=1):
    """Complex FFE core (reference equalization.py:1763)."""
    return _ffe_core_np(sigIn, symbRef, nTaps, SpS, mu, nTrain, prec,
                        constSymb, f, trainingMode, preconvIters, True)


def realValuedFFECore(sigIn, symbRef, nTaps=5, SpS=1, mu=1e-4, nTrain=1000,
                      prec=np.float32, constSymb=None, f=None,
                      trainingMode="data-aided", preconvIters=1):
    """Real FFE core (reference equalization.py:1655)."""
    return _ffe_core_np(sigIn, symbRef, nTaps, SpS, mu, nTrain, prec,
                        np.real(constSymb), f, trainingMode, preconvIters,
                        False)


def _dfe_core_np(sigIn, symbRef, nTapsFF, nTapsFB, SpS, mu, nTrain, prec,
                 constSymb, f, b, trainingMode, preconvIters, is_complex):
    sigIn = np.asarray(sigIn).reshape(-1).astype(prec)
    symbRef = np.asarray(symbRef).reshape(-1).astype(prec)
    constSymb = np.asarray(constSymb).astype(prec)
    L = len(sigIn)
    N = int((L - nTapsFF + nTapsFF % 2) // SpS)
    if f is None:
        f = np.zeros(nTapsFF, dtype=prec)
        f[nTapsFF // 2] = 1.0
    if b is None:
        b = np.zeros(nTapsFB, dtype=prec)
    f = np.array(f, dtype=prec)
    b = np.array(b, dtype=prec)
    out = np.zeros(N, dtype=prec)
    mse = np.zeros(N)
    for _ in range(preconvIters):
        dbuf = np.zeros(nTapsFB, dtype=prec)
        for k in range(N):
            xbuf = sigIn[k * SpS: k * SpS + nTapsFF]
            y = np.dot(f, xbuf) + np.dot(b, dbuf)
            out[k] = y
            ref = (symbRef[k] if k < nTrain
                   else constSymb[np.argmin(np.abs(y - constSymb))])
            e = ref - y
            mse[k] = np.abs(e) ** 2
            if trainingMode == "fulltime" or k < nTrain:
                f = f + mu * e * (np.conj(xbuf) if is_complex else xbuf)
                b = b + mu * e * (np.conj(dbuf) if is_complex else dbuf)
            dbuf = np.roll(dbuf, 1)
            dbuf[0] = ref
    return out, f, b, mse


def complexValuedDFECore(sigIn, symbRef, nTapsFF=5, nTapsFB=5, SpS=1, mu=1e-4,
                         nTrain=1000, prec=np.complex64, constSymb=None,
                         f=None, b=None, trainingMode="data-aided",
                         preconvIters=1):
    """Complex DFE core (reference equalization.py:1424)."""
    return _dfe_core_np(sigIn, symbRef, nTapsFF, nTapsFB, SpS, mu, nTrain,
                        prec, constSymb, f, b, trainingMode, preconvIters,
                        True)


def realValuedDFECore(sigIn, symbRef, nTapsFF=5, nTapsFB=5, SpS=1, mu=1e-4,
                      nTrain=1000, prec=np.float32, constSymb=None, f=None,
                      b=None, trainingMode="data-aided", preconvIters=1):
    """Real DFE core (reference equalization.py:1302)."""
    return _dfe_core_np(sigIn, symbRef, nTapsFF, nTapsFB, SpS, mu, nTrain,
                        prec, np.real(constSymb), f, b, trainingMode,
                        preconvIters, False)


def volterraCore(sigIn, symbRef, order=2, SpS=1, mu=1e-4, nTrain=1000,
                 h1=None, h2=None, h3=None, prec=np.float32, constSymb=None,
                 trainingMode="data-aided", preconvIters=1):
    """Volterra equalizer core (reference equalization.py:1986).

    Real-valued kernels to 3rd order; returns (sigOut, [h1, h2, h3], mse).
    """
    sigIn = np.asarray(sigIn).reshape(-1).real.astype(prec)
    symbRef = np.asarray(symbRef).reshape(-1).real.astype(prec)
    constSymb = np.real(np.asarray(constSymb)).astype(prec)
    n1 = len(h1) if h1 is not None else 5
    n2 = h2.shape[0] if h2 is not None else min(3, n1)
    n3 = h3.shape[0] if h3 is not None else min(2, n1)
    if h1 is None:
        h1 = np.zeros(n1, dtype=prec)
        h1[n1 // 2] = 1.0
    if h2 is None:
        h2 = np.zeros((n2, n2), dtype=prec)
    if h3 is None:
        h3 = np.zeros((n3, n3, n3), dtype=prec)
    h1, h2, h3 = (np.array(h, dtype=prec) for h in (h1, h2, h3))
    t2, t3 = (n1 - n2) // 2, (n1 - n3) // 2
    L = len(sigIn)
    N = int((L - n1 + n1 % 2) // SpS)
    out = np.zeros(N, dtype=prec)
    mse = np.zeros(N)
    for _ in range(preconvIters):
        for k in range(N):
            win = sigIn[k * SpS: k * SpS + n1]
            x2 = win[t2: t2 + n2]
            o2 = np.outer(x2, x2)
            y = np.dot(h1, win) + np.sum(h2 * o2)
            if order == 3:
                x3 = win[t3: t3 + n3]
                o3 = x3[:, None, None] * x3[None, :, None] * x3[None, None, :]
                y = y + np.sum(h3 * o3)
            out[k] = y
            ref = (symbRef[k] if k < nTrain
                   else constSymb[np.argmin(np.abs(y - constSymb))])
            e = ref - y
            mse[k] = np.abs(e) ** 2
            if trainingMode == "fulltime" or k < nTrain:
                h1 = h1 + mu * e * win
                h2 = h2 + (mu / 2) * e * o2
                if order == 3:
                    h3 = h3 + (mu / 7) * e * o3
    return out, [h1, h2, h3], mse
