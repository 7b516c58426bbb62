"""Receiver DSP: equalization and carrier recovery (port of ``opticommpy_tpu/dsp``)."""

from opticommpy_torch.dsp.carrier_recovery import (  # noqa: F401
    CPRConfig,
    bps,
    cpr,
    fourth_power_foe,
    residual_linewidth,
    unwrap,
)
from opticommpy_torch.dsp.equalization import (  # noqa: F401
    EDCConfig,
    MIMOEqualizer,
    MIMOEqualizerConfig,
    edc,
    mimo_adapt_equalizer,
)
