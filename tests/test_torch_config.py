"""The port's configs, parameter carry-over and import hygiene."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.comm.fec import LDPCConfig  # noqa: E402
from opticommpy_tpu.comm.ofdm import OFDMConfig  # noqa: E402
from opticommpy_tpu.dsp.carrier_recovery import CPRConfig  # noqa: E402
from opticommpy_tpu.dsp.clock_recovery import (  # noqa: E402
    ClockRecoveryConfig,
    FFWClockRecoveryConfig,
)
from opticommpy_tpu.dsp.equalization import (  # noqa: E402
    DFEConfig,
    EDCConfig,
    FFEConfig,
    MIMOEqualizerConfig,
    VolterraConfig,
)
from opticommpy_tpu.dsp.synchronization import SyncConfig  # noqa: E402
from opticommpy_tpu.models import config as jax_model_config  # noqa: E402
from opticommpy_tpu.models.amplification import EDFASMConfig  # noqa: E402
from opticommpy_tpu.models.perturbation import PerturbationConfig  # noqa: E402
from opticommpy_tpu.models.tx import PAMTxConfig, WDMTxConfig  # noqa: E402
from opticommpy_tpu.pipelines import CoherentDSPConfig, IMDDConfig  # noqa: E402
from opticommpy_torch.convert import (  # noqa: E402
    config_from_jax,
    port_config_classes,
    sd_from_numpy,
    sd_to_numpy,
    taps_from_numpy,
    taps_to_numpy,
)

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "opticommpy_torch"

JAX_CONFIGS = sorted(
    [obj for obj in vars(jax_model_config).values()
     if dataclasses.is_dataclass(obj) and isinstance(obj, type)]
    + [WDMTxConfig, EDCConfig, MIMOEqualizerConfig, CPRConfig, CoherentDSPConfig,
       ClockRecoveryConfig, FFWClockRecoveryConfig, LDPCConfig, DFEConfig, FFEConfig,
       VolterraConfig, PAMTxConfig, IMDDConfig, SyncConfig, EDFASMConfig, OFDMConfig,
       PerturbationConfig],
    key=lambda c: c.__name__)


@pytest.mark.parametrize("jax_cls", JAX_CONFIGS, ids=lambda c: c.__name__)
def test_fields_and_defaults_match_jax(jax_cls):
    port_cls = port_config_classes()[jax_cls.__name__]
    assert port_cls.__dataclass_params__.frozen
    jax_fields = [(f.name, f.default) for f in dataclasses.fields(jax_cls)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port_cls)]
    assert port_fields == jax_fields


def test_every_port_config_has_a_jax_counterpart():
    assert sorted(port_config_classes()) == [c.__name__ for c in JAX_CONFIGS]


@pytest.mark.parametrize("jax_cls", JAX_CONFIGS, ids=lambda c: c.__name__)
def test_config_from_jax_round_trips(jax_cls):
    first = dataclasses.fields(jax_cls)[0]
    value = 7 if first.type in (int, "int") else first.default
    obj = dataclasses.replace(jax_cls(), **{first.name: value})
    port = config_from_jax(obj)
    assert type(port) is port_config_classes()[jax_cls.__name__]
    assert dataclasses.asdict(port) == dataclasses.asdict(obj)


def test_config_from_jax_rejects_non_configs():
    with pytest.raises(TypeError):
        config_from_jax(WDMTxConfig)


def test_taps_and_sd_round_trip():
    rng = np.random.default_rng(0)
    H = (rng.normal(size=(2, 2, 15)) + 1j * rng.normal(size=(2, 2, 15))).astype(np.complex64)
    Sd = (rng.normal(size=(2, 15, 15)) + 1j * rng.normal(size=(2, 15, 15))).astype(np.complex64)
    Ht = taps_from_numpy(H, device="cpu")
    assert Ht.dtype == torch.complex64 and tuple(Ht.shape) == (2, 2, 15)
    np.testing.assert_array_equal(taps_to_numpy(Ht), H)
    np.testing.assert_array_equal(sd_to_numpy(sd_from_numpy(Sd, device="cpu")), Sd)
    with pytest.raises(ValueError):
        taps_from_numpy(H[0], device="cpu")


def test_package_source_has_no_jax_import():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+opticommpy_tpu"
                         r"|from\s+opticommpy_tpu)\b", re.M)
    offenders = [str(p.relative_to(PORT_ROOT)) for p in PORT_ROOT.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['opticommpy_tpu'] = None; "
            "import opticommpy_torch, opticommpy_torch.pipelines, "
            "opticommpy_torch.convert, opticommpy_torch.kernels.bps, "
            "opticommpy_torch.kernels.mimo_eq, opticommpy_torch.kernels.rls, "
            "opticommpy_torch.kernels.gardner, opticommpy_torch.kernels.ddpll, "
            "opticommpy_torch.dsp.clock_recovery, opticommpy_torch.comm.fec, "
            "opticommpy_torch.comm.fec_qc, opticommpy_torch.kernels.ldpc, "
            "opticommpy_torch.kernels.qc, opticommpy_torch.compat, "
            "opticommpy_torch.utils.checkpoint, opticommpy_torch.utils.profiling; "
            "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PORT_ROOT.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
