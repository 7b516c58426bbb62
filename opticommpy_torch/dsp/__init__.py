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
    unwrap_derotate,
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

# the Hopper kernels of the serial recurrences (the JAX package's Pallas
# entry points, ``*_pallas``, under the port's ``*_kernel`` names)
from opticommpy_torch.kernels.bps import bps_kernel  # noqa: F401,E402
from opticommpy_torch.kernels.dfe import dfe_kernel, ffe_kernel  # noqa: F401,E402
from opticommpy_torch.kernels.ddpll import ddpll_kernel  # noqa: F401,E402
from opticommpy_torch.kernels.gardner import gardner_kernel  # noqa: F401,E402
from opticommpy_torch.kernels.mimo_eq import (  # noqa: F401,E402
    mimo_eq_kernel,
    mimo_eq_kernel_batch,
    mimo_lms_kernel,
)
