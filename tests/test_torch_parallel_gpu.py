"""chip_smoke.py's phase O at a small size on the card: the port's parallel
routes at world size 1 on NCCL, each against its unsharded call (the dp
SSFM, decode, trainer and clock recovery bit for bit with the same kernel
launches; pp within 1e-6, sp within 5e-4, the sharded receive step within
5e-2 on the interior), then dryrun_multichip(1). Imports no JAX; needs a
CUDA device and skips without one.
"""

import numpy as np
import pytest
import torch

from _torch_parity import mixed_polmux, require_cuda

pytestmark = pytest.mark.gpu


def _small_inputs(dev):
    """Phase O's arguments at a small size: 3 band-limited polmux signals of
    2^14 samples over 2 x 50 km with EDFAs, 8 path-E codewords, 3 training
    signals and 3 offset signals."""
    import chip_smoke
    from opticommpy_torch.dsp import EDCConfig, MIMOEqualizerConfig
    from opticommpy_torch.dsp.clock_recovery import FFWClockRecoveryConfig
    from opticommpy_torch.models import SSFMConfig
    from opticommpy_torch.ops import pulse_shape
    from opticommpy_torch.ops.signal import clock_sampling_interp

    rng = np.random.default_rng(21)
    n = 2**14
    x = rng.normal(size=(n, 6)) + 1j * rng.normal(size=(n, 6))
    X = np.fft.fft(x, axis=0)
    X[np.abs(np.fft.fftfreq(n)) > 0.3] = 0
    sig = torch.as_tensor((0.02 * np.fft.ifft(X, axis=0)).astype(np.complex64), device=dev)
    cfg = SSFMConfig(Ltotal=100, Lspan=50, hz=0.5, alpha=0.2, D=16, gamma=1.3, Fs=128e9,
                     amp="edfa", NF=4.5, nlprMethod=False, trapIters=1, fusedLinear=True)
    llr = chip_smoke._path_e_llrs(dev, B=8)[2]
    sigs, syms = zip(*(mixed_polmux(30 + b, 4096) for b in range(3)))
    eq_cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
                                 L=(1000, 3096), M=16, numIter=2, backend="pallas")
    train_in = (torch.as_tensor(np.stack(sigs), device=dev),
                torch.as_tensor(np.stack(syms), device=dev), eq_cfg)
    ffw_cfg = FFWClockRecoveryConfig(blockLen=512, rollOff=0.1)
    ffw_in = [(clock_sampling_interp(train_in[0][b], 2.0, 2.0 * (1 + ppm * 1e-6))[:8000],
               ffw_cfg) for b, ppm in enumerate((60.0, -120.0, 200.0))]
    gen_state = torch.Generator(device=dev).manual_seed(17).get_state()
    return (sig, cfg, gen_state, llr, train_in, ffw_in, EDCConfig(L=100, D=16, Fs=128e9, Rs=32e9),
            pulse_shape("rrc", 4, 64, 0.1).astype(np.float32))


def test_phase_o_at_world_size_one_on_gpu():
    import chip_smoke

    dev = require_cuda()
    out = chip_smoke.phase_parallel_o(dev, *_small_inputs(dev))
    assert out["qc_mega"] == 1 and out["mimo_eq_batch"] == 3
    assert all(s >= 0 for s in out["secs"].values())
