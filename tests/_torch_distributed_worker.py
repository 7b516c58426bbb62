"""Worker for the 2-process test of tests/test_torch_parallel.py: the
port's ``init_distributed`` at a coordinator address on gloo (imports no
JAX).

    python tests/_torch_distributed_worker.py HOST:PORT PROCESS_ID

Each process holds half of a global (8,) tensor; the test reads the
RESULT lines: the global sum (gathered), the all-reduced sum, and the
data-parallel SSFM with the batch split over both processes, then
``sharded_edc`` with the time axis split over both, against the unsharded
port run.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    torch.set_num_threads(1)
    import torch.distributed as dist

    from opticommpy_torch.dsp.equalization import EDCConfig, edc
    from opticommpy_torch.models import SSFMConfig, manakov_ssf
    from opticommpy_torch.parallel import (P, init_distributed, is_multihost,
                                           local_device_count, make_mesh, manakov_ssf_dp,
                                           sharded_edc)
    from opticommpy_torch.parallel.sharded import _gather, _local_block

    coord, pid = sys.argv[1], int(sys.argv[2])
    rank, world = init_distributed(coordinator_address=coord, num_processes=2, process_id=pid,
                                   backend="gloo")
    assert (rank, world) == (pid, 2), (rank, world)
    assert init_distributed() == (pid, 2)  # a second call changes nothing
    assert is_multihost()
    assert local_device_count(device="cpu") == 1

    # a global (8,) tensor, each process holding its half
    hosts = make_mesh(2, 1, device_type="cpu")
    mine = _local_block(torch.arange(8, dtype=torch.float32), hosts, P("data"))
    print(f"RESULT sum {pid} {float(_gather(mine, hosts, P('data')).sum())}", flush=True)
    total = mine.sum()
    dist.all_reduce(total)
    print(f"RESULT all_reduce {pid} {float(total)}", flush=True)

    # the dp SSFM with the batch split over both processes, then sharded_edc
    # with the time axis split over both
    fs, n = 32e9 * 4, 2048
    rng = np.random.default_rng(5)  # the same input on both processes
    z = rng.normal(size=(n, 4)) + 1j * rng.normal(size=(n, 4))
    Zf = np.fft.fft(z, axis=0)
    Zf[np.abs(np.fft.fftfreq(n)) > 0.35] = 0
    e0 = torch.from_numpy((0.01 * np.fft.ifft(Zf, axis=0)).astype(np.complex64))
    cfg = SSFMConfig(Ltotal=50.0, Lspan=50.0, hz=10.0, alpha=0.2, D=16.0, gamma=1.3, Fs=fs,
                     amp="ideal", nlprMethod=False, trapIters=1)
    edc_cfg = EDCConfig(L=cfg.Ltotal, D=cfg.D, Fs=fs, Rs=32e9, NfilterCoeffs=256)
    out_dp = manakov_ssf_dp(e0, cfg, None, hosts)
    out_e = sharded_edc(out_dp, edc_cfg, make_mesh(1, 2, device_type="cpu"))
    ref_dp = manakov_ssf(e0, cfg)
    ref_e = edc(ref_dp, edc_cfg)

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    err_dp = rel(out_dp, ref_dp)
    err_e = rel(out_e[600:n - 600], ref_e[600:n - 600])
    print(f"RESULT e2e {pid} err_dp {err_dp:.3e} err_edc {err_e:.3e}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
