"""Carry parameters and state from the JAX package to the port and back.

Nothing here imports JAX: configs are matched by class and field name, and
arrays travel as NumPy.

- :func:`config_from_jax` builds the port's config from a JAX config
  dataclass instance.
- :func:`taps_from_numpy` / :func:`taps_to_numpy` move equalizer taps
  ``H[out, in, taps]``, or a batch of them ``H[b, out, in, taps]``
  (complex64).
- :func:`sd_from_numpy` / :func:`sd_to_numpy` move the RLS
  inverse-correlation state ``Sd[in, taps, taps]``, or a batch
  ``Sd[b, in, taps, taps]`` (complex64).
"""

import dataclasses

import numpy as np
import torch

from opticommpy_torch.utils.rng import default_device

__all__ = ["config_from_jax", "port_config_classes", "taps_from_numpy",
           "taps_to_numpy", "sd_from_numpy", "sd_to_numpy"]


def port_config_classes():
    """{class name: port config class} for every config the port copies."""
    from opticommpy_torch.comm.fec import LDPCConfig
    from opticommpy_torch.comm.ofdm import OFDMConfig
    from opticommpy_torch.dsp.carrier_recovery import CPRConfig
    from opticommpy_torch.dsp.clock_recovery import (ClockRecoveryConfig,
                                                     FFWClockRecoveryConfig)
    from opticommpy_torch.dsp.equalization import (DFEConfig, EDCConfig, FFEConfig,
                                                   MIMOEqualizerConfig, VolterraConfig)
    from opticommpy_torch.dsp.synchronization import SyncConfig
    from opticommpy_torch.models import config as model_config
    from opticommpy_torch.models.amplification import EDFASMConfig
    from opticommpy_torch.models.perturbation import PerturbationConfig
    from opticommpy_torch.models.tx import PAMTxConfig, WDMTxConfig
    from opticommpy_torch.pipelines import CoherentDSPConfig, IMDDConfig

    classes = [obj for obj in vars(model_config).values()
               if dataclasses.is_dataclass(obj) and isinstance(obj, type)]
    classes += [WDMTxConfig, EDCConfig, MIMOEqualizerConfig, CPRConfig,
                CoherentDSPConfig, ClockRecoveryConfig, FFWClockRecoveryConfig, LDPCConfig,
                DFEConfig, FFEConfig, VolterraConfig, PAMTxConfig, IMDDConfig, SyncConfig,
                EDFASMConfig, OFDMConfig, PerturbationConfig]
    return {cls.__name__: cls for cls in classes}


def config_from_jax(obj):
    """The port's config equal, field by field, to a JAX config instance."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        raise TypeError(f"expected a config dataclass instance, got {obj!r}")
    name = type(obj).__name__
    cls = port_config_classes().get(name)
    if cls is None:
        raise ValueError(f"the port has no config named {name}")
    values = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    port_fields = {f.name for f in dataclasses.fields(cls)}
    if set(values) != port_fields:
        raise ValueError(f"{name}: fields differ: "
                         f"{sorted(set(values) ^ port_fields)}")
    return cls(**values)


def _complex_tensor(a, what, device):
    a = np.asarray(a)
    if a.ndim not in (3, 4):
        raise ValueError(f"{what} must have 3 dimensions, or 4 for a batch, "
                         f"got {a.shape}")
    return torch.as_tensor(a.astype(np.complex64), device=default_device(device))


def taps_from_numpy(H, device=None):
    """Equalizer taps (modes, modes, taps), or (B, modes, modes, taps), as a
    complex64 tensor on ``device`` (the CUDA device when none is named)."""
    return _complex_tensor(H, "H", device)


def taps_to_numpy(H):
    """Equalizer taps, single or batched, as a complex64 NumPy array."""
    return H.detach().to("cpu", torch.complex64).numpy()


def sd_from_numpy(Sd, device=None):
    """RLS state Sd (modes, taps, taps), or (B, modes, taps, taps), as a
    complex64 tensor on ``device`` (the CUDA device when none is named)."""
    return _complex_tensor(Sd, "Sd", device)


def sd_to_numpy(Sd):
    """RLS state Sd, single or batched, as a complex64 NumPy array."""
    return Sd.detach().to("cpu", torch.complex64).numpy()
