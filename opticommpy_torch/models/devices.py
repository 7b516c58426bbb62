"""Optoelectronic device models: modulators, receivers, amplifiers, laser,
converters.

Port of ``opticommpy_tpu/models/devices.py``. Stochastic devices take a
``torch.Generator``; with none they draw from a generator seeded 0 on the
input's device, as the JAX functions default to ``PRNGKey(0)``. One
generator is passed down a receiver, so its draws follow one another in a
single stream. Where the JAX package splits one key several ways (the
ADC's and DAC's I jitter, Q jitter and ENOB noise), the port draws the
parts from the one generator in that order.
"""

import math

import scipy.constants as sconst
import torch

from opticommpy_torch.models.config import (
    ADCConfig,
    CoherentFrontendConfig,
    DACConfig,
    EDFAConfig,
    IQMConfig,
    LaserConfig,
    MZMConfig,
    PDMFrontendConfig,
    PhotodiodeConfig,
)
from opticommpy_torch.ops.filtering import fir_filter, lowpass_fir
from opticommpy_torch.ops.modulator import calc_mzm, calc_pm
from opticommpy_torch.ops.noise import gaussian_complex_noise, gaussian_noise, phase_noise
from opticommpy_torch.ops.signal import (carrier_phase, clock_sampling_interp, delay_signal,
                                         iq_mixing, quantizer)
from opticommpy_torch.utils.rng import as_device_tensor, ensure_generator
from opticommpy_torch.utils.units import dbm2w

__all__ = [
    "pm",
    "mzm",
    "iqm",
    "pbs",
    "voa",
    "photodiode",
    "balanced_pd",
    "optical_hybrid_2x4",
    "coherent_receiver",
    "pdm_coherent_receiver",
    "edfa",
    "basic_laser_model",
    "adc",
    "dac",
]


def pm(e_in, u, v_pi):
    """Optical phase modulator (reference devices.py:56): ``E_in *
    exp(j*pi*u/Vpi)``. A tensor keeps its device; any other input goes to
    the CUDA device; ``u`` follows ``e_in``."""
    e_in = as_device_tensor(e_in)
    return calc_pm(e_in, v_pi, torch.as_tensor(u).to(e_in.device))


def mzm(e_in, u, config: MZMConfig = MZMConfig()):
    """Mach-Zehnder amplitude modulator (reference devices.py:94)."""
    e_in = as_device_tensor(e_in)
    return calc_mzm(e_in, config.Vpi, torch.as_tensor(u).to(e_in.device),
                    config.Vb, config.ER)


def iqm(e_in, u, config: IQMConfig = IQMConfig()):
    """IQ modulator: two MZMs + 90-degree combiner (reference devices.py:147)."""
    e_in = as_device_tensor(e_in)
    u = torch.as_tensor(u).to(e_in.device)
    root2 = math.sqrt(2.0)
    eo_i = calc_mzm(e_in / root2, config.Vpi, u.real, config.VbI, config.ERI)
    eo_q = calc_mzm(e_in / root2, config.Vpi, u.imag, config.VbQ, config.ERQ)
    return eo_i + calc_pm(eo_q, config.Vpi, config.Vphi * torch.ones_like(u.real))


def pbs(e, theta=0.0):
    """Polarization beam splitter with input rotation (reference devices.py:223).

    Accepts (N,) single-pol (second pol empty) or (N, 2) input; returns
    (Ex, Ey).
    """
    e = as_device_tensor(e)
    if e.ndim == 1:
        e = torch.stack([e, torch.zeros_like(e)], dim=1)
    th = torch.tensor(theta, dtype=torch.float32)
    c, s = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])]).to(
        device=e.device, dtype=e.dtype)
    out = e @ rot
    return out[:, 0], out[:, 1]


def voa(e, att_db=0.0):
    """Variable optical attenuator (reference devices.py:263)."""
    return as_device_tensor(e) * 10 ** (-att_db / 20)


def photodiode(e, config: PhotodiodeConfig = None, generator=None):
    """Pin photodiode with shot/thermal noise, saturation and bandwidth.

    Ideal photocurrent ``R*|E|^2`` (summed over modes for multimode input),
    then optional saturation, shot noise ``2q(ipd+Id)B``, thermal noise
    ``4kTB/RL`` and a lowpass FIR response (reference devices.py:289).
    """
    if config is None:
        config = PhotodiodeConfig()
    e = as_device_tensor(e)
    if e.ndim > 1 and e.shape[1] > 1:
        ipd = config.R * torch.sum(torch.abs(e) ** 2, dim=1)
    else:
        ipd = config.R * (e * e.conj()).real
        if ipd.ndim > 1:
            ipd = ipd[:, 0]
    if config.ideal:
        return ipd
    fs = config.Fs
    if fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    if fs < 2 * config.B:
        raise ValueError("Sampling frequency Fs needs to be at least twice of B.")
    n_taps = config.N + (config.N % 2 == 0)  # force odd
    if config.currentSaturation:
        ipd = torch.clamp(ipd, max=config.IpdSat)
    if config.shotNoise or config.thermalNoise:
        generator = ensure_generator(generator, ipd.device)
    if config.shotNoise:
        var_shot = 2 * sconst.e * (ipd + config.Id) * config.B
        ipd = ipd + torch.sqrt(fs * var_shot / (2 * config.B)) * torch.randn(
            ipd.shape, generator=generator, device=generator.device)
    if config.thermalNoise:
        var_th = 4 * sconst.k * (config.Tc + 273.15) * config.B / config.RL
        ipd = ipd + gaussian_noise(generator, ipd.shape, fs * var_th / (2 * config.B))
    if config.bandwidthLimitation:
        ipd = fir_filter(lowpass_fir(config.B, fs, n_taps, config.fType), ipd)
    return ipd


def balanced_pd(e1, e2, config: PhotodiodeConfig = None, generator=None):
    """Balanced photodiode pair: i1 - i2 (reference devices.py:402)."""
    e1 = as_device_tensor(e1)
    e2 = torch.as_tensor(e2).to(e1.device)
    generator = ensure_generator(generator, e1.device)
    return photodiode(e1, config, generator) - photodiode(e2, config, generator)


def optical_hybrid_2x4(e_s, e_lo):
    """2x4 90-degree optical hybrid (reference devices.py:462).

    Returns the four output fields as a (4, N) tensor.
    """
    e_s = as_device_tensor(e_s)
    e_lo = torch.as_tensor(e_lo).to(e_s.device)
    T = torch.tensor([[0.5, 0.5j, 0.5j, -0.5],
                      [0.5j, -0.5, 0.5, 0.5j],
                      [0.5j, 0.5, -0.5j, -0.5],
                      [-0.5, 0.5j, -0.5, 0.5j]],
                     dtype=torch.complex64, device=e_s.device)
    zeros = torch.zeros_like(e_s)
    e_in = torch.stack([e_s, zeros, zeros, e_lo.to(e_s.dtype)])
    return T.to(e_in.dtype) @ e_in


def coherent_receiver(e_s, e_lo, config_fe: CoherentFrontendConfig = None,
                      config_pd: PhotodiodeConfig = None, generator=None):
    """Single-polarization coherent front end (reference devices.py:503).

    Optical hybrid -> two balanced PDs (I and Q) -> IQ impairments.
    """
    if config_fe is None:
        config_fe = CoherentFrontendConfig()
    fs = config_fe.Fs
    if config_pd is None:
        config_pd = PhotodiodeConfig(ideal=True, Fs=fs)
    e_s = as_device_tensor(e_s)
    generator = ensure_generator(generator, e_s.device)
    eo = optical_hybrid_2x4(e_s, e_lo)
    s_i = balanced_pd(eo[1, :], eo[0, :], config_pd, generator)
    s_q = balanced_pd(eo[2, :], eo[3, :], config_pd, generator)
    return iq_mixing(torch.complex(s_i, s_q), fs, config_fe.ampImb,
                     config_fe.phaseImb, config_fe.timeSkew)


def pdm_coherent_receiver(e_s, e_lo, config_fe: PDMFrontendConfig = None,
                          config_pd: PhotodiodeConfig = None, generator=None):
    """Polarization-multiplexed coherent front end (reference devices.py:574).

    Splits signal and LO with PBSs (LO at 45 degrees), applies polarization
    delay/PDL, and detects each polarization with a single-pol coherent
    receiver. Returns an (N, 2) tensor [Sx, Sy].
    """
    if config_fe is None:
        config_fe = PDMFrontendConfig()
    fs = config_fe.Fs
    if config_pd is None:
        config_pd = PhotodiodeConfig(ideal=True, Fs=fs)
    e_s = as_device_tensor(e_s)
    generator = ensure_generator(generator, e_s.device)
    e_lo_x, e_lo_y = pbs(torch.as_tensor(e_lo).to(e_s.device), theta=math.pi / 4)
    e_s_x, e_s_y = pbs(e_s, theta=config_fe.polRotation)
    if config_fe.polDelay != 0:
        e_s_x = delay_signal(e_s_x, -config_fe.polDelay / 2, fs)
        e_s_y = delay_signal(e_s_y, config_fe.polDelay / 2, fs)
    if config_fe.pdl != 0:
        e_s_x = 10 ** (-(config_fe.pdl / 2) / 20) * e_s_x
        e_s_y = 10 ** ((config_fe.pdl / 2) / 20) * e_s_y
    fe_x = CoherentFrontendConfig(Fs=fs, phaseImb=config_fe.phaseImbX,
                                  ampImb=config_fe.ampImbX,
                                  timeSkew=config_fe.timeSkewX)
    fe_y = CoherentFrontendConfig(Fs=fs, phaseImb=config_fe.phaseImbY,
                                  ampImb=config_fe.ampImbY,
                                  timeSkew=config_fe.timeSkewY)
    s_x = coherent_receiver(e_s_x, e_lo_x, fe_x, config_pd, generator)
    s_y = coherent_receiver(e_s_y, e_lo_y, fe_y, config_pd, generator)
    return torch.stack([s_x, s_y], dim=1)


def edfa(e_in, config: EDFAConfig = None, generator=None):
    """Lumped EDFA: flat gain + additive ASE noise (reference devices.py:671).

    ASE PSD ``N_ase = (G-1) * nsp * h * Fc`` with ``nsp = (G*NF-1)/(2(G-1))``
    (Essiambre et al. 2010, Eq. 54), over the simulation bandwidth Fs.
    """
    if config is None:
        config = EDFAConfig()
    gain, p_noise = _edfa_gain(config)
    e_in = as_device_tensor(e_in)
    generator = ensure_generator(generator, e_in.device)
    return e_in * gain + gaussian_complex_noise(generator, e_in.shape, p_noise)


def _edfa_gain(config: EDFAConfig):
    """(field gain ``sqrt(G)``, ASE noise power over ``Fs``) of :func:`edfa`."""
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    if config.G <= 0:
        raise ValueError("EDFA gain should be a positive scalar")
    if config.NF < 3:
        raise ValueError("The minimal EDFA noise figure is 3 dB")
    nf_lin = 10 ** (config.NF / 10)
    g_lin = 10 ** (config.G / 10)
    nsp = (g_lin * nf_lin - 1) / (2 * (g_lin - 1))
    return math.sqrt(g_lin), (g_lin - 1) * nsp * sconst.h * config.Fc * config.Fs


def basic_laser_model(config: LaserConfig = None, generator=None, device=None):
    """CW laser with random-walk phase noise, RIN and frequency offset.

    Parity with reference devices.py:729 (basicLaserModel). The field lands
    on the generator's device; an integer seed or ``None`` makes a generator
    on ``device``, the CUDA device when none is named.
    """
    if config is None:
        config = LaserConfig()
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    generator = ensure_generator(generator, device)
    pn = phase_noise(generator, config.lw, config.Ns, 1 / config.Fs)
    delta_p = gaussian_complex_noise(generator, pn.shape, config.RIN_var)
    if config.freqShift != 0:
        # exact to one float32 rounding; the JAX package's float32 ramp is not
        fo = carrier_phase(config.Ns, config.freqShift, config.Fs, pn.device)
    else:
        fo = 0.0
    return torch.sqrt(dbm2w(config.P) + delta_p) * torch.exp(1j * (fo + pn))


def _converter_input(sig_in, generator, device):
    """(signal as (N, M), squeezed?, generator): a tensor keeps its device,
    or goes to ``device``; any other input goes to ``device``, the CUDA
    device when none is named. The generator defaults to seed 0 there."""
    sig_in = as_device_tensor(sig_in, device)
    squeeze = sig_in.ndim == 1
    if squeeze:
        sig_in = sig_in[:, None]
    return sig_in, squeeze, ensure_generator(generator, sig_in.device)


def _enob_noise(out, generator, scale, n_bits, enob):
    """The extra noise of an ENOB below nBits: variance
    ``scale^2/12 * (2^-2ENOB - 2^-2nBits)``, per axis of a complex output."""
    pn_extra = scale**2 / 12 * (2.0 ** (-2 * enob) - 2.0 ** (-2 * n_bits))
    if out.is_complex():
        return out + gaussian_complex_noise(generator, out.shape, 2 * pn_extra).to(out.device)
    return out + gaussian_noise(generator, out.shape, pn_extra).to(out.device)


def adc(sig_in, config: ADCConfig = ADCConfig(), generator=None, device=None):
    """ADC (reference devices.py:793): anti-aliasing filter, resampling to
    ``outFs`` with sampling jitter, clipping to [Vmin, Vmax], ``nBits``
    quantization, the output filter, then the extra noise of an ENOB below
    nBits. The I jitter, Q jitter and ENOB noise are drawn from
    ``generator`` in that order (seed 0 on the signal's device when None).
    """
    sig_in, squeeze, gen = _converter_input(sig_in, generator, device)
    if config.AAF:
        n_taps = min(sig_in.shape[0], config.N)
        hi = lowpass_fir(config.outFs / 2, config.inFs, n_taps)
        ho = lowpass_fir(config.outFs / 2, config.outFs, n_taps)
        sig_in = fir_filter(hi, sig_in)

    def convert(x):
        x = clock_sampling_interp(x, config.inFs, config.outFs, config.jitter, gen)
        x = torch.clamp(x, config.Vmin, config.Vmax)
        return quantizer(x, config.nBits, config.Vmax, config.Vmin)

    if sig_in.is_complex():
        re = convert(sig_in.real)
        out = torch.complex(re, convert(sig_in.imag))
    else:
        out = convert(sig_in)
    if config.AAF:
        out = fir_filter(ho, out)
    if config.nBits > config.ENOB:
        out = _enob_noise(out, gen, config.Vmax - config.Vmin, config.nBits, config.ENOB)
    return out[:, 0] if squeeze else out


def dac(sig_in, config: DACConfig = DACConfig(), generator=None, device=None):
    """DAC (reference devices.py:912): ``nBits`` quantization between the
    data's own extremes, resampling to ``outFs`` with sampling jitter, the
    anti-imaging filter, the extra noise of an ENOB below nBits, then
    scaling by ``Vpp / (v_max - v_min)``. The I jitter, Q jitter and ENOB
    noise are drawn from ``generator`` in that order (seed 0 on the
    signal's device when None).
    """
    sig_in, squeeze, gen = _converter_input(sig_in, generator, device)
    if sig_in.is_complex():
        v_max = torch.maximum(torch.max(sig_in.real), torch.max(sig_in.imag))
        v_min = torch.minimum(torch.min(sig_in.real), torch.min(sig_in.imag))
        re = clock_sampling_interp(quantizer(sig_in.real, config.nBits, v_max, v_min),
                                   config.inFs, config.outFs, config.jitter, gen)
        im = clock_sampling_interp(quantizer(sig_in.imag, config.nBits, v_max, v_min),
                                   config.inFs, config.outFs, config.jitter, gen)
        out = torch.complex(re, im)
    else:
        v_max, v_min = torch.max(sig_in), torch.min(sig_in)
        out = clock_sampling_interp(quantizer(sig_in, config.nBits, v_max, v_min),
                                    config.inFs, config.outFs, config.jitter, gen)
    if config.AIF:
        n_taps = min(out.shape[0], config.N)
        out = fir_filter(lowpass_fir(config.outFs / 2, config.outFs, n_taps), out)
    if config.nBits > config.ENOB:
        out = _enob_noise(out, gen, float(v_max - v_min), config.nBits, config.ENOB)
    out = out * (torch.full_like(v_max, config.Vpp) / (v_max - v_min))
    return out[:, 0] if squeeze else out
