"""Receiver DSP: equalization, carrier and clock recovery, sequence
synchronization (port of ``opticommpy_tpu/dsp``)."""

from opticommpy_torch.dsp.carrier_recovery import (  # noqa: F401
    CPRConfig,
    bps,
    cpr,
    ddpll,
    fourth_power_foe,
    residual_linewidth,
    unwrap,
    viterbi,
)
from opticommpy_torch.dsp.clock_recovery import (  # noqa: F401
    ClockRecoveryConfig,
    FFWClockRecoveryConfig,
    calc_clock_drift,
    ffw_clock_recovery,
    gardner_clock_recovery,
)
from opticommpy_torch.dsp.equalization import (  # noqa: F401
    DFEConfig,
    EDCConfig,
    FFEConfig,
    MIMOEqualizer,
    MIMOEqualizerConfig,
    VolterraConfig,
    dfe,
    edc,
    ffe,
    manakov_dbp,
    mimo_adapt_equalizer,
    mimo_adapt_equalizer_batch,
    mimo_apply,
    mimo_apply_fused,
    volterra,
)
from opticommpy_torch.dsp.synchronization import (  # noqa: F401
    SyncConfig,
    sync_data_sequences,
)
