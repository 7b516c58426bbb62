"""Physical models: devices, fiber channel, transmitter, amplification,
perturbation (port of ``opticommpy_tpu/models``)."""

from opticommpy_torch.models import (  # noqa: F401
    amplification,
    channels,
    config,
    devices,
    perturbation,
    tx,
)
from opticommpy_torch.models.channels import (  # noqa: F401
    awgn,
    linear_fiber_channel,
    manakov_ssf,
    ssfm,
)
from opticommpy_torch.models.config import (  # noqa: F401
    ADCConfig,
    AWGNConfig,
    CoherentFrontendConfig,
    DACConfig,
    EDFAConfig,
    IQMConfig,
    LaserConfig,
    LinearFiberConfig,
    MZMConfig,
    PDMFrontendConfig,
    PhotodiodeConfig,
    SSFMConfig,
)
from opticommpy_torch.models.devices import (  # noqa: F401
    adc,
    balanced_pd,
    basic_laser_model,
    coherent_receiver,
    dac,
    edfa,
    iqm,
    mzm,
    optical_hybrid_2x4,
    pbs,
    pdm_coherent_receiver,
    photodiode,
    pm,
    voa,
)
from opticommpy_torch.models.tx import (  # noqa: F401
    PAMTxConfig,
    WDMTxConfig,
    pam_transmitter,
    simple_wdm_tx,
)
