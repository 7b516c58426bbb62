"""The device rule at every entry point of the port's main path: a tensor
keeps its device, and anything else (a NumPy array, a list, a scalar array)
goes to the CUDA device, so only a CPU tensor (or ``device="cpu"`` where a
function takes a device) asks for the CPU.

Each case calls one public function on NumPy input. With a card, every
tensor it returns lies on the card; without one, it raises RuntimeError and
names ``device='cpu'`` instead of running on the host. A CPU tensor given
alongside (the secondary inputs: references, taps, a second field) follows
the main input, which the last test pins.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from opticommpy_torch import pipelines as tpipe  # noqa: E402
from opticommpy_torch.comm import ofdm as tofdm  # noqa: E402
from opticommpy_torch.comm import metrics as tmet  # noqa: E402
from opticommpy_torch.comm import modulation as tmod  # noqa: E402
from opticommpy_torch.dsp import carrier_recovery as tcr  # noqa: E402
from opticommpy_torch.dsp import clock_recovery as tclk  # noqa: E402
from opticommpy_torch.dsp import equalization as teq  # noqa: E402
from opticommpy_torch.kernels import bps as tbps  # noqa: E402
from opticommpy_torch.kernels import ddpll as tddpll  # noqa: E402
from opticommpy_torch.kernels import mimo_eq as tmimo  # noqa: E402
from opticommpy_torch.kernels import rls as trls  # noqa: E402
from opticommpy_torch.models import amplification as tamp  # noqa: E402
from opticommpy_torch.models import channels as tch  # noqa: E402
from opticommpy_torch.models import perturbation as tpert  # noqa: E402
from opticommpy_torch.models import devices as tdev  # noqa: E402
from opticommpy_torch.models.config import LinearFiberConfig, SSFMConfig  # noqa: E402
from opticommpy_torch.ops import filtering as tfilt  # noqa: E402
from opticommpy_torch.ops import signal as tsig  # noqa: E402
from opticommpy_torch.ops import whitening as twh  # noqa: E402
from opticommpy_torch import parallel as tpar  # noqa: E402
from opticommpy_torch.utils import checkpoint as tck  # noqa: E402
from opticommpy_torch.utils import units as tunits  # noqa: E402

from _torch_parity import mixed_polmux, norm_qam  # noqa: E402

_C16 = norm_qam(16)
_RNG = np.random.default_rng(13)
_SIG, _SYM = mixed_polmux(13, 512)  # (1024, 2) at 2 samples/symbol, (512, 2)
_SIG8 = np.repeat(_SYM, 8, axis=0)  # (4096, 2) at 8 samples/symbol
_X1 = _SIG[:, 0].copy()  # one mode, (1024,)
_REAL = _RNG.normal(size=1024).astype(np.float32)
_BITS = _RNG.integers(0, 2, size=256).astype(np.int32)
_PHASE = np.cumsum(_RNG.normal(scale=0.05, size=(512, 2)), axis=0).astype(np.float32)
_TAPS = np.zeros((2, 2, 7), np.complex64)
_TAPS[[0, 1], [0, 1], 3] = 1.0
_FS = 64e9
_CHAIN = tpipe.CoherentDSPConfig(SpS_in=8, nFilterTaps=64, L=10.0, nTrain=128,
                                 cpr_window=9, cpr_phases=16)
_EQ = teq.MIMOEqualizerConfig(nTaps=7, M=16, mu=(1e-3,))
_SSFM = SSFMConfig(Ltotal=1, Lspan=1, hz=0.5, Fs=_FS)
_EDFA = tamp.EDFASMConfig(type="none", lngth=6.0, forPumpW=(30e-3,), bckPumpW=(0.0,),
                          noiseBand=50e9)
_OFDM = tofdm.OFDMConfig(Nfft=64, G=8, SpS=1, pilotCarriers=(0, 21, 42, 63))
_PERT = tpert.calc_pert_coeff_matrix(tpert.PerturbationConfig(matrixOrder=4))


def _saved_state():
    """A checkpoint file of NumPy leaves (saving needs no device)."""
    return tck.save_state(os.path.join(tempfile.mkdtemp(), "state.npz"), [_SIG, _TAPS])

# each entry point, called on NumPy input; the function returns tensors
NUMPY_INPUT_CALLS = {
    # pipelines
    "coherent_dsp_chain": lambda: tpipe.coherent_dsp_chain(_SIG8, _SYM, _CHAIN),
    "coherent_dsp_chain_batch": lambda: tpipe.coherent_dsp_chain_batch(
        _SIG8[None], _SYM[None], _CHAIN),
    "coherent_dsp_serve": lambda: tpipe.coherent_dsp_serve(_SIG, _TAPS, _CHAIN),
    # equalization
    "edc": lambda: teq.edc(_SIG, teq.EDCConfig(L=10, Fs=_FS)),
    "mimo_adapt_equalizer": lambda: teq.mimo_adapt_equalizer(_SIG, _EQ, symb_ref=_SYM),
    "mimo_adapt_equalizer_batch": lambda: teq.mimo_adapt_equalizer_batch(
        _SIG[None], _EQ, symb_ref=_SYM[None]),
    "mimo_apply": lambda: teq.mimo_apply(_TAPS, _SIG),
    "mimo_apply_fused": lambda: teq.mimo_apply_fused(_TAPS, _SIG, scale=1.0),
    # carrier recovery
    "unwrap": lambda: tcr.unwrap(4 * _PHASE),
    "unwrap_derotate": lambda: tcr.unwrap_derotate(_PHASE, _SYM, 4),
    "bps": lambda: tcr.bps(_SYM, 4, _C16, 16),
    "ddpll": lambda: tcr.ddpll(_SYM[:64], 1 / 32e9, 0.1, 1e-8, 1e-8, _C16),
    "viterbi": lambda: tcr.viterbi(_SYM),
    "fourth_power_foe": lambda: tcr.fourth_power_foe(_SYM, 32e9),
    "cpr": lambda: tcr.cpr(_SYM, tcr.CPRConfig(M=16, N=9, B=16)),
    "residual_linewidth": lambda: tcr.residual_linewidth(_PHASE, 1 / 32e9),
    # clock recovery
    "gardner_clock_recovery": lambda: tclk.gardner_clock_recovery(
        _SIG[:256], static_out=True),
    "ffw_clock_recovery": lambda: tclk.ffw_clock_recovery(
        _SIG, tclk.FFWClockRecoveryConfig(blockLen=256)),
    "gardner_ted": lambda: tclk.gardner_ted(_X1[:3]),
    "gardner_ted_nyquist": lambda: tclk.gardner_ted_nyquist(_X1[:3]),
    "interpolator": lambda: tclk.interpolator(_X1[:4], 0.3),
    # channels and devices
    "linear_fiber_channel": lambda: tch.linear_fiber_channel(
        _SIG, LinearFiberConfig(L=10, Fs=_FS)),
    "manakov_ssf": lambda: tch.manakov_ssf(_SIG, _SSFM),
    "mzm": lambda: tdev.mzm(np.ones(64, np.complex64), _REAL[:64]),
    "iqm": lambda: tdev.iqm(np.ones(64, np.complex64), _X1[:64]),
    "pbs": lambda: tdev.pbs(_SIG),
    "photodiode": lambda: tdev.photodiode(_SIG, tdev.PhotodiodeConfig(ideal=True)),
    "balanced_pd": lambda: tdev.balanced_pd(
        _X1, _X1[::-1].copy(), tdev.PhotodiodeConfig(ideal=True)),
    "optical_hybrid_2x4": lambda: tdev.optical_hybrid_2x4(_X1, np.ones(1024, np.complex64)),
    "coherent_receiver": lambda: tdev.coherent_receiver(
        _X1, np.ones(1024, np.complex64), tdev.CoherentFrontendConfig(Fs=_FS)),
    "pdm_coherent_receiver": lambda: tdev.pdm_coherent_receiver(
        _SIG, np.ones(1024, np.complex64), tdev.PDMFrontendConfig(Fs=_FS)),
    "edfa": lambda: tdev.edfa(_SIG, tdev.EDFAConfig(Fs=_FS)),
    "edfa_sm": lambda: tamp.edfa_sm(1e-2 * _SIG, 400e9, 193.1e12, _EDFA),
    "calc_nlin_perturbation": lambda: tpert.calc_nlin_perturbation(*_PERT[1:], _SYM[:, 0],
                                                                   _SYM[:, 1]),
    "perturbation_nlin": lambda: tpert.perturbation_nlin(
        _SYM, tpert.PerturbationConfig(matrixOrder=4)),
    # OFDM
    "modulate_ofdm": lambda: tofdm.modulate_ofdm(_SYM[:, 0].reshape(-1)[:480], _OFDM),
    "demodulate_ofdm": lambda: tofdm.demodulate_ofdm(_SIG[:, 0][:360], _OFDM,
                                                     return_channel=True),
    # checkpoints
    "load_state": lambda: tck.load_state(_saved_state()),
    # filtering and signal conditioning
    "fir_filter": lambda: tfilt.fir_filter(np.ones(5, np.float32), _SIG),
    "overlap_save": lambda: tfilt.overlap_save(_SIG, np.ones(5, np.float32), nfft=64),
    "sig_pow": lambda: tsig.sig_pow(_SIG),
    "signal_power": lambda: tsig.signal_power(_SIG),
    "pnorm": lambda: tsig.pnorm(_SIG),
    "anorm": lambda: tsig.anorm(_SIG),
    "upsample": lambda: tsig.upsample(_SYM, 2),
    "clock_sampling_interp": lambda: tsig.clock_sampling_interp(_SIG, 2.0, 3.0),
    "decimate": lambda: tsig.decimate(_SIG8, 8, 2),
    "resample": lambda: tsig.resample(_SIG, 2.0, 1.0, n_taps=31),
    "finddelay": lambda: tsig.finddelay(_X1, np.roll(_X1, 3)),
    "symbol_sync": lambda: tsig.symbol_sync(_SIG, np.roll(_SYM, 5, axis=0), 2),
    "moving_average": lambda: tsig.moving_average(_SIG, 5),
    "delay_signal": lambda: tsig.delay_signal(_SIG, 0.5),
    "iq_mixing": lambda: tsig.iq_mixing(_SIG, _FS, 1.0, 0.1),
    # modulation and metrics
    "min_euclid": lambda: tmod.min_euclid(_SYM, _C16),
    "demap": lambda: tmod.demap(np.arange(16), tmod.bit_map(16, "qam")),
    "modulate_gray": lambda: tmod.modulate_gray(_BITS, 16, "qam"),
    "demodulate_gray": lambda: tmod.demodulate_gray(_SYM * np.sqrt(10), 16, "qam"),
    "mlse": lambda: tmod.mlse(_REAL[:64], np.array([1.0, 0.4]),
                              tmod.gray_mapping(4, "pam")),
    "bert": lambda: tmet.bert(_BITS + 0.1 * _REAL[:256], _BITS),
    "fast_ber_calc": lambda: tmet.fast_ber_calc(_SYM, _SYM, 16, "qam"),
    "monte_carlo_gmi": lambda: tmet.monte_carlo_gmi(_SIG[::2], _SYM, 16, "qam"),
    "calc_llr": lambda: tmet.calc_llr(_SYM[:, 0], 0.1, _C16, tmod.bit_map(16, "qam"),
                                      np.ones(16) / 16),
    "calc_evm": lambda: tmet.calc_evm(_SYM, 16, "qam"),
    "llr2bit_prob": lambda: tunits.llr2bit_prob(_REAL),
    # the kernels' entries (their plain versions for a CPU tensor)
    "bps_kernel": lambda: tbps.bps_kernel(_SYM, 4, _C16, 16),
    "mimo_eq_kernel": lambda: tmimo.mimo_eq_kernel(_SIG, _SYM, _C16, n_taps=7,
                                                   n_train=128),
    "mimo_eq_kernel_batch": lambda: tmimo.mimo_eq_kernel_batch(
        _SIG[None], _SYM[None], _C16, n_taps=7, n_train=128),
    "mimo_rls_kernel": lambda: trls.mimo_rls_kernel(_SIG, _SYM, _C16, n_taps=7),
    "mimo_rls_kernel_batch": lambda: trls.mimo_rls_kernel_batch(
        _SIG[None], _SYM[None], _C16, n_taps=7),
    "ddpll_kernel": lambda: tddpll.ddpll_kernel(_SYM, 1 / 32e9, 0.1, 1e-8, 1e-8, _C16),
    # whitening
    "autocorr": lambda: twh.autocorr(_REAL, 4),
    "levinson": lambda: twh.levinson(np.array([1.0, 0.5, 0.2], np.float32), 3),
    "estimate_whitening_filter": lambda: twh.estimate_whitening_filter(_REAL, 4),
}


def _tensors(out):
    """Every tensor in a (nested) tuple or list of outputs."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


@pytest.mark.parametrize("name", sorted(NUMPY_INPUT_CALLS))
def test_numpy_input_goes_to_the_card(name):
    """Given NumPy input, the function runs on the card, and without one it
    raises: only a CPU tensor asks for the CPU."""
    call = NUMPY_INPUT_CALLS[name]
    if torch.cuda.is_available():
        tensors = _tensors(call())
        assert tensors and all(t.is_cuda for t in tensors), name
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("name", ["edc", "fir_filter", "pnorm", "cpr", "mimo_adapt_equalizer",
                                  "coherent_dsp_chain", "mlse", "autocorr"])
def test_cpu_tensor_input_stays_on_the_cpu(name):
    """The same calls with the main input as a CPU tensor (the secondary
    NumPy inputs follow it) run on the CPU, whether or not there is a card."""
    cpu_calls = {
        "edc": lambda x: teq.edc(x, teq.EDCConfig(L=10, Fs=_FS)),
        "fir_filter": lambda x: tfilt.fir_filter(np.ones(5, np.float32), x),
        "pnorm": tsig.pnorm,
        "cpr": lambda x: tcr.cpr(x[::2], tcr.CPRConfig(M=16, N=9, B=16)),
        "mimo_adapt_equalizer": lambda x: teq.mimo_adapt_equalizer(x, _EQ, symb_ref=_SYM),
        "coherent_dsp_chain": lambda x: tpipe.coherent_dsp_chain(
            torch.as_tensor(_SIG8), _SYM, _CHAIN),
        "mlse": lambda x: tmod.mlse(x[:64, 0].real.contiguous(), np.array([1.0, 0.4]),
                                    tmod.gray_mapping(4, "pam")),
        "autocorr": lambda x: twh.autocorr(x[:, 0], 4),
    }
    tensors = _tensors(cpu_calls[name](torch.as_tensor(_SIG)))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_init_distributed_needs_a_card_unless_the_cpu_is_asked_for():
    """The parallel entry points' process group: NCCL on a card; without one,
    init_distributed, local_device_count and make_mesh raise unless the
    caller asks for gloo or the CPU, and there is no quiet fall to gloo."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    if torch.cuda.is_available():
        assert tpar.init_distributed() == (0, 1)
        assert dist.get_backend() == "nccl"
        assert tpar.local_device_count() == torch.cuda.device_count()
        dist.destroy_process_group()
    else:
        for call in (tpar.init_distributed, tpar.local_device_count,
                     lambda: tpar.make_mesh(1, 1)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert not dist.is_initialized()
    assert tpar.init_distributed(backend="gloo") == (0, 1)
    assert dist.get_backend() == "gloo" and not tpar.is_multihost()
    assert tpar.local_device_count(device="cpu") == 1
    dist.destroy_process_group()


@pytest.fixture
def _mesh_of_one():
    """A (1, 1) mesh and a 1-stage mesh on a group of one (NCCL with a card,
    gloo on the CPU without one), closed after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = tpar.make_mesh(1, 1, device_type=device_type)
    yield mesh, DeviceMesh(device_type, torch.arange(1), mesh_dim_names=("stage",))
    dist.destroy_process_group()


PARALLEL_NUMPY_CALLS = {
    "sharded_fir": lambda m, s: tpar.sharded_fir(_SIG, np.ones(5, np.float32), m),
    "sharded_edc": lambda m, s: tpar.sharded_edc(_SIG, teq.EDCConfig(L=10, Fs=_FS), m),
    "manakov_ssf_dp": lambda m, s: tpar.manakov_ssf_dp(_SIG, _SSFM, None, m),
    "manakov_ssf_pp": lambda m, s: tpar.manakov_ssf_pp(_SIG, _SSFM, None, s),
    "manakov_ssf_sp": lambda m, s: tpar.manakov_ssf_sp(_SIG, _SSFM, mesh=m),
}


@pytest.mark.parametrize("name", sorted(PARALLEL_NUMPY_CALLS))
def test_numpy_input_to_a_parallel_entry_goes_to_the_card(name, _mesh_of_one):
    """NumPy input to the sharded functions goes to the card, or raises
    without one, as at every other entry point."""
    call = PARALLEL_NUMPY_CALLS[name]
    if torch.cuda.is_available():
        tensors = _tensors(call(*_mesh_of_one))
        assert tensors and all(t.is_cuda for t in tensors), name
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(*_mesh_of_one)
