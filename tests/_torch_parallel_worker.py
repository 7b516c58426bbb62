"""Worker for tests/test_torch_parallel.py: every multi-rank case of the
port's ``parallel/`` in one gloo group of four CPU processes. It imports no
JAX.

    python tests/_torch_parallel_worker.py IN.npz OUT.npz

reads the inputs the test made from its seeds, runs each case on four
spawned processes (one torch thread each) and has rank 0 write OUT.npz:
each case's output, the unsharded port call beside every data-parallel
route (``*_ref``), the ``batch_isend_irecv`` calls each function posted,
whether every rank returned the same tensors, and the dry run's stage
errors at world size 4. The configurations are the cases of
tests/test_parallel.py; the test reads them from here for the JAX side.
"""

import hashlib
import os
import socket
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLD = 4
FS = 32e9 * 4

# SSFMConfig keywords of each case (tests/test_parallel.py:95-237)
PP_FIXED = dict(Ltotal=8 * 25, Lspan=25, hz=5.0, alpha=0.2, D=16, gamma=1.3, Fs=FS,
                amp="ideal", nlprMethod=False)
PP_ADAPTIVE = dict(Ltotal=4 * 25, Lspan=25, alpha=0.2, D=16, gamma=1.3, Fs=FS, amp="ideal",
                   nlprMethod=True, maxNlinPhaseRot=2e-2)
PP_EDFA = dict(Ltotal=4 * 25, Lspan=25, hz=5.0, alpha=0.2, D=16, gamma=1.3, Fs=FS,
               amp="edfa", nlprMethod=False)
DP_ADAPTIVE = dict(Ltotal=50, Lspan=50, alpha=0.2, D=16, gamma=1.3, Fs=FS, amp="none",
                   nlprMethod=True, maxNlinPhaseRot=2e-2)
DP_EDFA = dict(DP_ADAPTIVE, amp="edfa")
SP = dict(Ltotal=100.0, Lspan=50.0, hz=1.0, alpha=0.2, D=16.0, gamma=1.3, Fs=FS,
          amp="ideal", nlprMethod=False, trapIters=1)
SP_2D = dict(SP, hz=2.0)
SP_ONE_SPAN = dict(SP, Ltotal=50.0)
SP_EDFA = dict(SP, amp="edfa")
SP_NOISE_SHAPE = (2**12, 8)  # no signal: ASE alone, 4 signals over a (2, 2) mesh
EDC = dict(L=80, D=17, Fs=64e9, Rs=32e9)
QC = (64800, "4/5", 8, "NMSA", "f32")
TRAIN = dict(nTaps=9, SpS=2, mu=(2e-3, 1e-3), alg=("nlms", "dd-lms"), L=(400, 624), M=16,
             numIter=2, backend="pallas")
FFW = dict(blockLen=512, rollOff=0.1)


def _cases(rank, inp):
    """{name: output} of every case on this rank, and the calls of
    ``batch_isend_irecv`` per function."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from opticommpy_torch.comm.fec_qc import make_qc_decoder
    from opticommpy_torch.dsp.clock_recovery import FFWClockRecoveryConfig, ffw_clock_recovery
    from opticommpy_torch.dsp.equalization import (EDCConfig, MIMOEqualizerConfig, edc,
                                                   mimo_adapt_equalizer_batch)
    from opticommpy_torch.models import SSFMConfig, manakov_ssf
    from opticommpy_torch.parallel import (P, make_mesh, manakov_ssf_dp, manakov_ssf_pp,
                                           manakov_ssf_sp, sharded_edc, sharded_fir)
    from opticommpy_torch.parallel.sharded import _data_parallel

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    m14, m22, m41 = make_mesh(1, 4), make_mesh(2, 2), make_mesh(4, 1)
    stages = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("stage",))
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    out, p2p = {}, {}
    with mock.patch.object(dist, "batch_isend_irecv", wraps=dist.batch_isend_irecv) as spy:
        def counted(name, key, fn):
            before = spy.call_count
            out[key] = fn()
            p2p[name] = p2p.get(name, 0) + spy.call_count - before

        counted("sharded_fir", "fir_odd", lambda: sharded_fir(t["fir_x"], t["fir_h"], m14))
        counted("sharded_fir", "fir_even",
                lambda: sharded_fir(t["fir_x_even"], t["fir_h_even"], m22))
        counted("sharded_edc", "edc", lambda: sharded_edc(t["edc_disp"], EDCConfig(**EDC), m14))
        counted("manakov_ssf_pp", "pp_fixed", lambda: manakov_ssf_pp(
            t["pp_fixed"], SSFMConfig(**PP_FIXED), gen(0), stages, n_microbatches=4))
        counted("manakov_ssf_pp", "pp_adaptive", lambda: manakov_ssf_pp(
            t["pp_adaptive"], SSFMConfig(**PP_ADAPTIVE), gen(1), stages))
        counted("manakov_ssf_pp", "pp_edfa", lambda: manakov_ssf_pp(
            t["pp_edfa"], SSFMConfig(**PP_EDFA), gen(2), stages))
        counted("manakov_ssf_sp", "sp_default",
                lambda: manakov_ssf_sp(t["sp_default"], SSFMConfig(**SP), mesh=m14))
        counted("manakov_ssf_sp", "sp_sync2", lambda: manakov_ssf_sp(
            t["sp_sync2"], SSFMConfig(**SP), mesh=m14, spans_per_sync=2))
        counted("manakov_ssf_sp", "sp_2d", lambda: manakov_ssf_sp(
            t["sp_2d"], SSFMConfig(**SP_2D), mesh=m22, data_axis="data"))
        for halo in (128, 512):
            counted("manakov_ssf_sp", f"sp_halo{halo}", lambda: manakov_ssf_sp(
                t["sp_halo"], SSFMConfig(**SP_ONE_SPAN), mesh=m14, halo=halo))
        counted("manakov_ssf_sp", "sp_edfa",
                lambda: manakov_ssf_sp(t["sp_edfa"], SSFMConfig(**SP_EDFA), gen(7), mesh=m14))
        counted("manakov_ssf_sp", "sp_noise_2d", lambda: manakov_ssf_sp(
            torch.zeros(SP_NOISE_SHAPE, dtype=torch.complex64), SSFMConfig(**SP_EDFA), gen(8),
            mesh=m22, data_axis="data"))

    # the data-parallel routes; rank 0 also runs each unsharded port call
    dec = make_qc_decoder(*QC)
    eq_cfg = MIMOEqualizerConfig(**TRAIN)
    cr_cfg = FFWClockRecoveryConfig(**FFW)

    def train(s, r):
        return mimo_adapt_equalizer_batch(s, eq_cfg, symb_ref=r)

    def cr(s):
        return torch.stack([ffw_clock_recovery(x, cr_cfg) for x in s])

    out["dp_adaptive"] = manakov_ssf_dp(t["dp_sig"], SSFMConfig(**DP_ADAPTIVE), None, m41)
    out["dp_edfa"] = manakov_ssf_dp(t["dp_sig"], SSFMConfig(**DP_EDFA), gen(3), m41)
    qc = _data_parallel(dec, m41, (P(None, "data"),), (P(None, "data"), P("data"), P("data")))
    out["qc_llr"], out["qc_iters"], out["qc_fail"] = qc(t["qc_llr"])
    out["train"] = _data_parallel(train, m41, (P("data"), P("data")), P("data"))(
        t["train_sig"], t["train_sym"])
    out["ffw"] = _data_parallel(cr, m41, (P("data"),), P("data"))(t["ffw_sig"])
    if rank == 0:
        ref = dict(dp_adaptive=manakov_ssf(t["dp_sig"], SSFMConfig(**DP_ADAPTIVE)),
                   dp_edfa=manakov_ssf(t["dp_sig"], SSFMConfig(**DP_EDFA), gen(3)),
                   train=train(t["train_sig"], t["train_sym"]), ffw=cr(t["ffw_sig"]),
                   edc=edc(t["edc_disp"], EDCConfig(**EDC)))
        ref["qc_llr"], ref["qc_iters"], ref["qc_fail"] = dec(t["qc_llr"])
        out.update({f"{k}_ref": v for k, v in ref.items()})
    return out, p2p


def _digest(x):
    return hashlib.sha1(x.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()


def run(rank, port, path_in, path_out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from opticommpy_torch.parallel import init_distributed
    from opticommpy_torch.parallel.dryrun import dryrun_multichip

    init_distributed(f"127.0.0.1:{port}", WORLD, rank, backend="gloo")
    with np.load(path_in) as f:
        inp = dict(f)
    out, p2p = _cases(rank, inp)
    digests = {k: _digest(v.reshape(-1)) for k, v in out.items() if not k.endswith("_ref")}
    everyone = [None] * WORLD
    dist.all_gather_object(everyone, digests)
    dry = dryrun_multichip(WORLD, device="cpu")
    if rank == 0:
        res = {k: v.numpy() for k, v in out.items()}
        res.update({f"p2p_{k}": np.int64(v) for k, v in p2p.items()})
        res["same_on_every_rank"] = np.bool_(all(d == digests for d in everyone))
        res.update({f"dryrun_{k}": np.float64(v) for k, v in dry.items()
                    if k in ("dp", "step", "pp", "sp", "dcn")})
        np.savez(path_out, **res)
    dist.barrier()
    dist.destroy_process_group()


def main():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(run, args=(port, sys.argv[1], sys.argv[2]), nprocs=WORLD)


if __name__ == "__main__":
    main()
