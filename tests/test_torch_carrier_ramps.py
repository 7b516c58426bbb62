"""Exact carrier phase ramps: the WDM Tx's frequency shifts and the laser's
frequency offset at the 11-channel link's record (2^20 samples at 512 GHz)
and its outer channels (+-187.5 GHz), where ``2 pi f t`` reaches 2.4e6 rad.

The port reduces the turns ``k f / Fs`` modulo 1 in float64 before one
float32 rounding (``ops.signal.carrier_phase``). The JAX package forms the
ramp in float32 (opticommpy_tpu/models/devices.py:299, tx.py:167), which
keeps ~0.25 rad of it; its error is shown beside the port's, as
``test_torch_comm_mi.py::test_cazac_sequence`` shows the JAX package's
CAZAC phase.
"""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_tpu.models import config as jcfg  # noqa: E402
from opticommpy_tpu.models import devices as jdev  # noqa: E402
from opticommpy_torch.models import devices as tdev  # noqa: E402
from opticommpy_torch.models import tx as ttx  # noqa: E402
from opticommpy_torch.ops.signal import carrier_phase  # noqa: E402

N, FS = 2**20, 512e9
# one float32 rounding of a phase in [-pi, pi]
ULP_PI = float(np.spacing(np.float32(np.pi)))


def _exact(f):
    """2 pi (k f / Fs mod 1) in [-pi, pi], from extended-precision turns."""
    k = np.arange(N).astype(np.longdouble)
    turns = k * np.longdouble(f) / np.longdouble(FS)
    return 2 * np.pi * (turns - np.round(turns)).astype(np.float64)


def _phase_err(z, f):
    """Largest angle (rad) between the unit phasors of ``z`` and the exact ramp."""
    z = np.asarray(z, dtype=np.complex128)
    return float(np.abs(np.angle(z * np.exp(-1j * _exact(f)))).max())


@pytest.mark.parametrize("f", (187.5e9, -187.5e9, 187.5e9 + 150e6))
def test_carrier_phase_is_one_float32_rounding_of_the_exact_ramp(f):
    ph = carrier_phase(N, f, FS, "cpu")
    assert ph.dtype == torch.float32 and ph.shape == (N,)
    assert float(ph.abs().max()) <= np.float32(np.pi)
    err = np.abs(ph.double().numpy() - _exact(f)).max()
    assert err <= ULP_PI / 2 + 1e-9  # float64 turns: ~3e-10 rad
    both = carrier_phase(N, [f, -f], FS, "cpu")
    assert both.shape == (2, N) and torch.equal(both[0], ph)


@pytest.mark.parametrize("f", (187.5e9, -187.5e9))
def test_laser_frequency_offset_is_exact(f):
    cfg = dict(P=0.0, lw=0.0, Ns=N, Fs=FS, RIN_var=0.0, freqShift=f)
    out = tdev.basic_laser_model(tdev.LaserConfig(**cfg), torch.Generator().manual_seed(1))
    # the phase's rounding and the complex exponential's: 1.43e-7 rad
    assert _phase_err(out.numpy(), f) <= ULP_PI
    # the JAX package's float32 ramp: 0.34 rad
    ref = jdev.basic_laser_model(jcfg.LaserConfig(**cfg), jax.random.PRNGKey(1))
    assert _phase_err(ref, f) > 0.1


@pytest.mark.parametrize("ch", (0, 1))
def test_wdm_tx_frequency_shift_is_exact(ch):
    """Two channels at +-187.5 GHz (grid spacing 375 GHz), only channel
    ``ch`` lit: the field over the same channel built at f = 0 is its
    carrier."""
    kw = dict(M=16, Rs=32e9, SpS=16, nBits=4 * N // 16, nChannels=2, nPolModes=1,
              nFilterTaps=64, laserLinewidth=0.0,
              powerPerChannel=tuple(0.0 if c == ch else -np.inf for c in range(2)))
    symbols, pn = ttx.wdm_tx_draw(torch.Generator().manual_seed(3), ttx.WDMTxConfig(**kw))
    shifted, _, grid = ttx.wdm_tx_build(symbols, pn, ttx.WDMTxConfig(wdmGridSpacing=375e9, **kw))
    base, _, _ = ttx.wdm_tx_build(symbols, pn, ttx.WDMTxConfig(wdmGridSpacing=0.0, **kw))
    assert abs(grid[ch]) == 187.5e9
    ratio = shifted.numpy()[:, 0].astype(np.complex128) / base.numpy()[:, 0]
    # the phase's rounding, the exponential's and the product's: 2.2e-7 rad
    assert _phase_err(ratio, grid[ch]) <= 2 * ULP_PI


@pytest.mark.gpu
def test_carrier_phase_is_exact_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = [187.5e9, -187.5e9, 150e6]
    assert torch.equal(carrier_phase(N, f, FS, "cuda").cpu(), carrier_phase(N, f, FS, "cpu"))
