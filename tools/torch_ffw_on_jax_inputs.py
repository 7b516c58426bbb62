"""The port's feedforward clock recovery on the JAX package's path-B signals.

Reads what tools/jax_path_b_inputs.py saved (the 11 signals the JAX
package's ffw_clock_recovery retimes on chip_smoke.py's path B, its clock
estimates, per-block timing and outputs) and runs
opticommpy_torch.dsp.ffw_clock_recovery on the CPU on the same signals with
the same configuration. Prints per channel the true offset, both estimates
and their difference, the largest timing difference over the blocks, and
the largest output difference before the last 2048-sample block of the
JAX package's block resampler and within it. Exits 1 if an estimate
differs from the JAX package's by 0.1 ppm or more (tests/test_torch_clock.py's
bound), or an output sample before that block by 1e-4 or more: the tests
hold outputs to 2e-5 at 16,384 samples, and here an estimate that differs
in its last float32 bits (1e-4 ppm) moves the timing at output i by
1e-10 * i samples, 1.3e-5 samples at the end of 131,046.

Usage: python tools/torch_ffw_on_jax_inputs.py [IN.npz]
(default build/path_b_inputs.npz)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from opticommpy_torch.dsp.clock_recovery import (  # noqa: E402
    FFWClockRecoveryConfig,
    ffw_clock_recovery,
)

PPM_ATOL, Y_ATOL, JAX_BLOCK = 0.1, 1e-4, 2048


def main(path):
    d = np.load(path)
    cfg = FFWClockRecoveryConfig(blockLen=int(d["block_len"]), maxPPM=float(d["max_ppm"]),
                                 rollOff=float(d["roll_off"]), fit="linear", sps=2)
    n_out = d["y"].shape[1]
    last = (n_out - 1) // JAX_BLOCK * JAX_BLOCK  # first output of the last block
    ok = True
    for k in range(d["x"].shape[0]):
        y, (ppm, tau) = ffw_clock_recovery(torch.as_tensor(d["x"][k]), cfg, return_est=True)
        y = y.numpy()
        dp = abs(float(ppm) - float(d["ppm"][k]))
        d_tau = float(np.abs(tau.numpy() - d["tau"][k]).max())
        d_head = float(np.abs(y[:last] - d["y"][k][:last]).max())
        d_tail = float(np.abs(y[last:] - d["y"][k][last:]).max())
        ok &= dp < PPM_ATOL and d_head < Y_ATOL
        print(f"ch {k:2d}: true {float(d['ppm_true'][k]):7.1f} ppm, JAX {float(d['ppm'][k]):9.4f}, "
              f"port {float(ppm):9.4f}, |diff| {dp:.2e} ppm; max |tau diff| {d_tau:.2e} symbol; "
              f"max |y diff| {d_head:.2e} on outputs 0..{last - 1}, {d_tail:.2e} on "
              f"{last}..{n_out - 1}")
    print("port within 0.1 ppm and 1e-4 of the JAX package before its last block:", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "build/path_b_inputs.npz"))
