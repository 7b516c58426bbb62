"""The port's parallel/ held to the JAX package's on the same inputs.

The JAX side runs here on the 8-device virtual CPU mesh of conftest.py, on
meshes of the shapes the port uses: (data 1, time 4), (2, 2), (4, 1) and a
4-stage mesh. The port side runs in one gloo group of four spawned CPU
processes (tests/_torch_parallel_worker.py, which imports no JAX) on
inputs made here from NumPy seeds. Tolerances are those of
tests/test_parallel.py: sharded_fir rtol/atol 1e-3; sharded_edc < 5e-2 on
the interior; pp and dp rtol 1e-3, atol 2e-4; sp < 5e-4 (halo 128 and 512:
err(512) < err(128) < 5e-3); EDFA output power 0.8-1.6 x the input; the QC
decode's decisions, iteration counts and failure flags equal. Each
data-parallel route (SSFM, QC decode, trainer, feedforward clock recovery)
is also held bit for bit to the unsharded port call, and halos must travel
by point-to-point messages at world size 4 and by none at world size 1.
"""

import os
import socket
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

torch.set_num_threads(1)

import _torch_parallel_worker as W  # noqa: E402
from _torch_parity import cpu, rel_err, to_np  # noqa: E402

from opticommpy_tpu import parallel as jpar  # noqa: E402
from opticommpy_tpu.dsp import EDCConfig as JEDCConfig, edc as jedc  # noqa: E402
from opticommpy_tpu.models import (LinearFiberConfig, SSFMConfig as JSSFMConfig,  # noqa: E402
                                   linear_fiber_channel, manakov_ssf as jmanakov)
from opticommpy_tpu.ops import fir_filter as jfir  # noqa: E402
from opticommpy_tpu.parallel import sharded as jsharded  # noqa: E402
from opticommpy_torch import parallel as tpar  # noqa: E402
from opticommpy_torch.parallel import sharded as tsharded  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _bandlimited_batch(rng, n, k_signals, scale=0.03):
    """tests/test_parallel.py's pp/dp input: (n, 2k) complex64 noise through
    a sinc low-pass."""
    sig = scale * (rng.normal(size=(n, 2 * k_signals))
                   + 1j * rng.normal(size=(n, 2 * k_signals))).astype(np.complex64)
    h = np.sinc(np.arange(-16, 17) / 4)
    for c in range(sig.shape[1]):
        sig[:, c] = np.convolve(sig[:, c], h, "same")
    return sig.astype(np.complex64)


def _sp_workload(n=2**13, k_signals=2, band=0.35, seed=11):
    """tests/test_parallel.py's sp input: band-limited to 0.35 Fs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2 * k_signals)) + 1j * rng.normal(size=(n, 2 * k_signals))
    X = np.fft.fft(x, axis=0)
    X[np.abs(np.fft.fftfreq(n)) > band] = 0
    return (0.01 * np.fft.ifft(X, axis=0)).astype(np.complex64)


def _edc_inputs():
    """(clean signal, dispersed by 80 km: JAX linear_fiber_channel), (2^13, 1)."""
    rng = np.random.default_rng(2)
    n, sps = 2**13, 2
    sym = rng.choice([-1 - 1j, -1 + 1j, 1 - 1j, 1 + 1j], size=n // sps)
    up = np.zeros(n, dtype=complex)
    up[::sps] = sym
    h = np.sinc(np.arange(-8, 9) / 2) * np.hamming(17)
    sig = np.convolve(up, h, "same").astype(np.complex64)[:, None]
    disp = linear_fiber_channel(jnp.asarray(sig), LinearFiberConfig(L=80, alpha=0.0, D=17,
                                                                      Fs=64e9))
    return sig, np.asarray(disp)


def _qc_inputs():
    """16 encoded DVB-S2 R4/5 codewords (4 a rank) at Es/N0 3.2 dB:
    (codewords (n, 16) int8, LLRs float32)."""
    from opticommpy_torch.comm.fec import encode_ldpc, standard_ldpc

    n, R, _, _, _ = W.QC
    _, edges = standard_ldpc("DVBS2", n, R)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=(n * 4 // 5, 16)).astype(np.int32)
    cw = encode_ldpc(cpu(bits), edges=edges).numpy()
    sigma = np.sqrt(0.5 * 10 ** (-3.2 / 10))
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    return cw, (2 * y / sigma**2).astype(np.float32)


def _train_inputs():
    """4 polmux 16-QAM signals at 2 SpS through a 2x2 mix: (signals (4,
    2048, 2), symbols (4, 1024, 2))."""
    from _torch_parity import norm_qam

    rng = np.random.default_rng(8)
    const = norm_qam(16)
    sym = const[rng.integers(0, 16, size=(4, 1024, 2))]
    x = np.zeros((4, 2048, 2), complex)
    x[:, ::2] = sym
    mix = np.eye(2) + 0.1 * (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))
    sig = x @ mix.T + 0.01 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return sig.astype(np.complex64), sym.astype(np.complex64)


def _ffw_inputs():
    """4 RRC 16-QAM signals at 2 SpS, clocks 50-300 ppm fast, (4, 4096, 2)."""
    from _torch_parity import norm_qam
    from opticommpy_torch.ops import fir_filter, pulse_shape, upsample
    from opticommpy_torch.ops.signal import clock_sampling_interp, pnorm

    rng = np.random.default_rng(9)
    sym = norm_qam(16)[rng.integers(0, 16, size=(2048, 2))]
    base = pnorm(fir_filter(cpu(pulse_shape("rrc", 2, 257, 0.1).astype(np.float32)),
                            upsample(cpu(sym), 2)))
    return np.stack([clock_sampling_interp(base, 2.0, 2.0 * (1 + ppm * 1e-6))[:4096].numpy()
                     for ppm in np.linspace(50.0, 300.0, 4)])


@pytest.fixture(scope="module")
def inputs():
    rng0, rng1 = np.random.default_rng(0), np.random.default_rng(1)
    sig, disp = _edc_inputs()
    qc_cw, qc_llr = _qc_inputs()
    train_sig, train_sym = _train_inputs()
    return dict(
        fir_x=(rng0.normal(size=(4096, 2)) + 1j * rng0.normal(size=(4096, 2))).astype(
            np.complex64),
        fir_h=rng0.normal(size=33).astype(np.float32),
        fir_x_even=rng1.normal(size=(2048, 1)).astype(np.float32),
        fir_h_even=rng1.normal(size=32).astype(np.float32),
        edc_sig=sig, edc_disp=disp,
        pp_fixed=_bandlimited_batch(np.random.default_rng(4), 2**11, 8),
        pp_adaptive=_bandlimited_batch(np.random.default_rng(5), 2**10, 4),
        pp_edfa=_bandlimited_batch(np.random.default_rng(6), 2**10, 4, scale=0.05),
        dp_sig=_bandlimited_batch(np.random.default_rng(3), 2**11, 4),
        sp_default=_sp_workload(), sp_sync2=_sp_workload(seed=12),
        sp_2d=_sp_workload(n=2**12, k_signals=4, seed=13), sp_halo=_sp_workload(seed=14),
        sp_edfa=_sp_workload(seed=15),
        qc_cw=qc_cw, qc_llr=qc_llr, train_sig=train_sig, train_sym=train_sym,
        ffw_sig=_ffw_inputs())


def _spawn(args, log):
    """A CPU worker process (torch at one thread), its output to ``log``."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR")}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen([sys.executable] + args, stdout=log, stderr=subprocess.STDOUT,
                            env=env)


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """The processes' outputs: the worker's (one launch of four gloo
    processes) and, under "two_process", the two processes of the
    coordinator-address test; the JAX package's QC decode of the same LLRs
    ("jax_qc") runs here while they run."""
    from opticommpy_tpu.comm import fec_qc

    d = tmp_path_factory.mktemp("torch_parallel")
    path_in, path_out = str(d / "in.npz"), str(d / "out.npz")
    np.savez(path_in, **{k: v for k, v in inputs.items() if k != "qc_cw"})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    logs = [open(d / f"log{i}.txt", "w+") for i in range(3)]
    procs = [_spawn([os.path.join(HERE, "_torch_parallel_worker.py"), path_in, path_out],
                    logs[0])]
    procs += [_spawn([os.path.join(HERE, "_torch_distributed_worker.py"), coord, str(pid)],
                     logs[1 + pid]) for pid in (0, 1)]
    try:
        jax_qc = fec_qc.make_qc_decoder(*W.QC)(jnp.asarray(inputs["qc_llr"]))
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            p.kill()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    assert procs[0].returncode == 0, outs[0]
    with np.load(path_out) as f:
        res = dict(f)
    res["jax_qc"] = [np.asarray(a) for a in jax_qc]
    res["two_process"] = [(p.returncode, out) for p, out in zip(procs[1:], outs[1:])]
    return res


def _devices():
    return np.array(jax.devices()[:4])


def _jmesh(n_data, n_time):
    return jpar.make_mesh(n_data=n_data, n_time=n_time, devices=list(_devices()))


def _jstages():
    return Mesh(_devices(), ("stage",))


def test_sharded_fir_odd_taps_matches_jax(inputs, port):
    x, h = inputs["fir_x"], inputs["fir_h"]
    want = np.asarray(jpar.sharded_fir(x, h, _jmesh(1, 4)))
    np.testing.assert_allclose(port["fir_odd"], want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(port["fir_odd"], np.asarray(jfir(h, x)), rtol=1e-3, atol=1e-3)


def test_sharded_fir_even_taps_matches_jax(inputs, port):
    x, h = inputs["fir_x_even"], inputs["fir_h_even"]
    want = np.asarray(jpar.sharded_fir(x, h, _jmesh(2, 2)))
    assert port["fir_even"].dtype == np.float32
    np.testing.assert_allclose(port["fir_even"], want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(port["fir_even"], np.asarray(jfir(h, x)), rtol=1e-3, atol=1e-3)


def test_sharded_edc_matches_jax_and_inverts_cd(inputs, port):
    disp, sig = inputs["edc_disp"], inputs["edc_sig"]
    cfg = JEDCConfig(**W.EDC)
    ref = np.asarray(jedc(disp, cfg))
    got = port["edc"]
    sl = slice(600, -600)

    def nmse(a, b):
        return np.mean(np.abs(a[sl] - b[sl]) ** 2) / np.mean(np.abs(b[sl]) ** 2)

    assert nmse(got, ref) < 5e-2
    assert nmse(got, sig) < 5e-2
    assert nmse(got, np.asarray(jpar.sharded_edc(disp, cfg, _jmesh(1, 4)))) < 5e-2


def test_sharded_edc_keeps_every_tap_of_edc(port):
    """The port's sharded_edc pads an even-length impulse with a zero tap
    where the JAX package drops its first tap (ROADMAP.md queue 3): at world
    size 4 it is the port's edc, to float32 rounding."""
    assert rel_err(port["edc"], port["edc_ref"]) < 1e-5


@pytest.mark.parametrize("case", ["pp_fixed", "pp_adaptive"])
def test_manakov_pp_matches_jax(inputs, port, case):
    kw = dict(pp_fixed=W.PP_FIXED, pp_adaptive=W.PP_ADAPTIVE)[case]
    m = dict(pp_fixed=4, pp_adaptive=None)[case]
    sig, cfg, key = inputs[case], JSSFMConfig(**kw), jax.random.PRNGKey(0)
    want = np.asarray(jpar.manakov_ssf_pp(sig, cfg, key, _jstages(), n_microbatches=m))
    np.testing.assert_allclose(port[case], want, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(port[case], np.asarray(jmanakov(sig, cfg, key)), rtol=1e-3,
                               atol=2e-4)


def test_manakov_dp_adaptive_matches_jax(inputs, port):
    sig, cfg, key = inputs["dp_sig"], JSSFMConfig(**W.DP_ADAPTIVE), jax.random.PRNGKey(0)
    want = np.asarray(jpar.manakov_ssf_dp(sig, cfg, key, _jmesh(4, 1)))
    np.testing.assert_allclose(port["dp_adaptive"], want, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("case", ["pp_edfa", "sp_edfa"])
def test_edfa_output_power_window(inputs, port, case):
    """ASE: the gain-balanced link's output power near its input power
    (tests/test_parallel.py:127,237)."""
    p_in = np.mean(np.abs(inputs[case]) ** 2)
    p_out = np.mean(np.abs(port[case]) ** 2)
    assert 0.8 * p_in < p_out < 1.6 * p_in


@pytest.mark.parametrize("case", ["dp_adaptive", "dp_edfa", "qc_llr", "qc_iters", "qc_fail",
                                  "train", "ffw"])
def test_data_parallel_route_equals_the_unsharded_port_call(port, case):
    assert port[case].shape == port[f"{case}_ref"].shape
    assert np.array_equal(port[case], port[f"{case}_ref"])


@pytest.mark.parametrize("case", ["sp_default", "sp_sync2", "sp_2d"])
def test_manakov_sp_matches_jax(inputs, port, case):
    kw = dict(sp_default=W.SP, sp_sync2=W.SP, sp_2d=W.SP_2D)[case]
    sig, cfg = inputs[case], JSSFMConfig(**kw)
    ref = np.asarray(jmanakov(sig, cfg))
    assert rel_err(port[case], ref) < 5e-4
    mesh, extra = _jmesh(1, 4), {}
    if case == "sp_2d":
        mesh, extra = _jmesh(2, 2), dict(data_axis="data")
    if case == "sp_sync2":
        extra = dict(spans_per_sync=2)
    want = np.asarray(jpar.manakov_ssf_sp(sig, cfg, mesh=mesh, **extra))
    assert rel_err(port[case], want) < 5e-4


def test_manakov_sp_halo_shrinks_error(inputs, port):
    ref = np.asarray(jmanakov(inputs["sp_halo"], JSSFMConfig(**W.SP_ONE_SPAN)))
    err128, err512 = rel_err(port["sp_halo128"], ref), rel_err(port["sp_halo512"], ref)
    assert err512 < err128 < 5e-3


def test_manakov_sp_draws_each_data_block_its_own_noise(port):
    """ASE alone (no signal) through manakov_ssf_sp with the batch split over
    'data' as well: the JAX package folds its key by (span, time block)
    only, so signals 0 and 2, in two data blocks, get the same noise; the
    port seeds each (span, time block, data block) on its own (ROADMAP.md
    queue 3)."""
    cfg = JSSFMConfig(**W.SP_EDFA)
    jax_out = np.asarray(jpar.manakov_ssf_sp(np.zeros(W.SP_NOISE_SHAPE, np.complex64), cfg,
                                             jax.random.PRNGKey(8), mesh=_jmesh(2, 2),
                                             data_axis="data"))
    assert np.array_equal(jax_out[:, 0:2], jax_out[:, 4:6])
    got = port["sp_noise_2d"]
    assert np.all(np.abs(got).mean(axis=0) > 0)
    for a, b in ((0, 2), (0, 4), (2, 6)):
        assert not np.allclose(got[:, a:a + 2], got[:, b:b + 2])


def test_sharded_qc_decode_matches_jax(inputs, port):
    """The port's codeword-split decode against the JAX package's decode:
    decisions, iteration counts and failure flags equal; some codewords
    decode error-free."""
    out, iters, fail = port["jax_qc"]
    assert np.array_equal(port["qc_llr"] < 0, out.astype(np.float32) < 0)
    assert np.array_equal(port["qc_iters"], iters)
    assert np.array_equal(port["qc_fail"], fail)
    assert ((port["qc_llr"] < 0) == (inputs["qc_cw"] > 0)).all(axis=0).any()


@pytest.mark.parametrize("name", ["sharded_fir", "sharded_edc", "manakov_ssf_pp",
                                  "manakov_ssf_sp"])
def test_halos_travel_by_p2p_at_world_size_4(port, name):
    assert port[f"p2p_{name}"] > 0


def test_every_rank_returns_the_same_tensors(port):
    assert bool(port["same_on_every_rank"])


def test_dryrun_multichip_at_world_size_4(port):
    """dryrun_multichip(4) on gloo: its own bounds held inside, the
    DCN-shaped stage run (it needs 4 ranks)."""
    assert port["dryrun_dp"] < 1e-3 and port["dryrun_pp"] < 1e-3
    assert port["dryrun_step"] < 5e-2 and port["dryrun_sp"] < 5e-3
    assert port["dryrun_dcn"] < 1e-3


def test_next_smooth_matches_jax():
    ns = list(range(1, 3000)) + [2**20 + 7000, 2**18 + 3, 1_000_001, 3**7 * 5 + 1]
    assert [tsharded._next_smooth(n) for n in ns] == [jsharded._next_smooth(n) for n in ns]


@pytest.mark.parametrize("kw", [W.SP, W.PP_FIXED, dict(W.SP, Fs=512e9, Lspan=80.0),
                                dict(W.SP, D=4.0, Fs=64e9)])
@pytest.mark.parametrize("spans_per_sync", [1, 2, 3])
def test_default_sp_halo_matches_jax(kw, spans_per_sync):
    from opticommpy_torch.models import SSFMConfig

    assert (tpar.default_sp_halo(SSFMConfig(**kw), spans_per_sync)
            == jpar.default_sp_halo(JSSFMConfig(**kw), spans_per_sync))


@pytest.fixture
def group_of_one():
    """A gloo group of one in this process, closed after the test."""
    assert not dist.is_initialized()
    mesh = tpar.make_mesh(1, 1, device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def test_jax_sharded_edc_drops_a_tap_the_port_keeps(group_of_one):
    """A Savory-sized filter short for the band (100 km at 128 GS/s, band
    0.3 Fs): the JAX package's sharded_edc, which drops the first of the
    impulse's even number of taps, is beyond the 5e-2 bound of its own test
    from its edc; the port's is edc's to float32 rounding (ROADMAP.md
    queue 3)."""
    from opticommpy_torch.dsp.equalization import EDCConfig, edc

    sig = _sp_workload(n=2**12, k_signals=1, band=0.3, seed=16)
    kw = dict(L=100, D=16, Fs=128e9, Rs=32e9)
    jax_err = rel_err(jpar.sharded_edc(sig, JEDCConfig(**kw), _jmesh(1, 4)),
                      jedc(sig, JEDCConfig(**kw)))
    assert jax_err > 5e-2
    x = cpu(sig)
    assert rel_err(tpar.sharded_edc(x, EDCConfig(**kw), group_of_one),
                   edc(x, EDCConfig(**kw))) < 1e-5


def test_world_size_one_posts_no_p2p_and_copies_its_own_halos(inputs, group_of_one):
    """At world size 1 every neighbour is oneself: the circular halos of
    manakov_ssf_sp are a local copy, and no function posts a message."""
    from opticommpy_torch.models import SSFMConfig, manakov_ssf
    from opticommpy_torch.ops import fir_filter
    from torch.distributed.device_mesh import DeviceMesh

    mesh = group_of_one
    stages = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("stage",))
    x, h = cpu(inputs["fir_x"], inputs["fir_h"])
    sp_sig, pp_sig = cpu(inputs["sp_default"], inputs["pp_fixed"])
    with mock.patch.object(dist, "batch_isend_irecv", wraps=dist.batch_isend_irecv) as p2p, \
            mock.patch.object(tsharded, "_halo_exchange",
                              wraps=tsharded._halo_exchange) as halo:
        y = tpar.sharded_fir(x, h, mesh)
        pp = tpar.manakov_ssf_pp(pp_sig, SSFMConfig(**W.PP_FIXED), None, stages,
                                 n_microbatches=1)
        sp = tpar.manakov_ssf_sp(sp_sig, SSFMConfig(**W.SP), mesh=mesh)
    assert p2p.call_count == 0
    assert [c.kwargs.get("circular", False) for c in halo.call_args_list] == [False, True, True]
    np.testing.assert_allclose(to_np(y), to_np(fir_filter(h, x)), rtol=1e-5, atol=1e-5)
    assert torch.equal(pp, manakov_ssf(pp_sig, SSFMConfig(**W.PP_FIXED)))
    assert rel_err(sp, manakov_ssf(sp_sig, SSFMConfig(**W.SP))) < 5e-4


def test_two_process_init_distributed(port):
    """Two processes open a gloo group at a coordinator address
    (tests/test_parallel.py:282, on torch.distributed): multi-host, one CPU
    device each, a sum and an all-reduce over both, and the dp SSFM +
    sharded_edc step against the unsharded run."""
    import re

    for pid, (rc, out) in enumerate(port["two_process"]):
        assert rc == 0, f"worker {pid} failed:\n{out}"
        assert f"RESULT sum {pid} 28.0" in out, out
        assert f"RESULT all_reduce {pid} 28.0" in out, out
        m = re.search(rf"RESULT e2e {pid} err_dp (\S+) err_edc (\S+)", out)
        assert m, out
        assert float(m.group(1)) < 1e-3, out
        assert float(m.group(2)) < 5e-2, out
