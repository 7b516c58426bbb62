"""DSP primitives (port of ``opticommpy_tpu/ops``): filtering, noise,
modulator transfer functions, signal conditioning and whitening-filter
estimation."""

from opticommpy_torch.ops.filtering import (
    fir_filter,
    lowpass_fir,
    overlap_save,
    pulse_shape,
    rc_taps,
    rrc_taps,
)
from opticommpy_torch.ops.modulator import calc_mzm, calc_pm
from opticommpy_torch.ops.noise import (
    gaussian_complex_noise,
    gaussian_noise,
    phase_noise,
)
from opticommpy_torch.ops.signal import (
    anorm,
    clock_sampling_interp,
    decimate,
    delay_signal,
    finddelay,
    freq_shift,
    iq_mixing,
    moving_average,
    pnorm,
    quantizer,
    resample,
    sig_pow,
    signal_power,
    symbol_sync,
    upsample,
)
from opticommpy_torch.ops.whitening import (
    autocorr,
    estimate_whitening_filter,
    levinson,
)

__all__ = [
    "fir_filter",
    "lowpass_fir",
    "overlap_save",
    "pulse_shape",
    "rc_taps",
    "rrc_taps",
    "calc_mzm",
    "calc_pm",
    "gaussian_complex_noise",
    "gaussian_noise",
    "phase_noise",
    "anorm",
    "clock_sampling_interp",
    "decimate",
    "delay_signal",
    "finddelay",
    "freq_shift",
    "iq_mixing",
    "moving_average",
    "pnorm",
    "quantizer",
    "resample",
    "sig_pow",
    "signal_power",
    "symbol_sync",
    "upsample",
    "autocorr",
    "estimate_whitening_filter",
    "levinson",
]
