"""Multi-device dry run: one sharded simulation step on every parallel
route, each stage checked against the unsharded port call.

Port of the JAX package's ``__graft_entry__.dryrun_multichip``. Run it on
``W`` processes, one device each::

    torchrun --nproc-per-node W python -m opticommpy_torch.parallel.dryrun

(``--device cpu`` runs it on gloo over CPU processes), or call
:func:`dryrun_multichip` from one process: a process with no group opens a
group of one. The stages and their bounds (those of the JAX package's
tests):

- dp: the Manakov SSFM with the WDM batch split over ``data`` (< 1e-3);
  then ``sharded_edc`` and a matched filter with the time axis split over
  ``time`` (< 5e-2 on the interior);
- pp: spans staged over all ranks, GPipe microbatches (< 1e-3);
- sp: one signal's time axis over all ranks, halo 128 (< 5e-3);
- DCN-shaped (2, W/2) mesh when W >= 4: dp over the outer dim, then
  ``sharded_edc`` over the inner (< 1e-3);
- the DVB-S2 R4/5 QC decode with the codeword batch split over ``data``:
  decisions, iteration counts and failure flags bit for bit;
- the batched multi-stage equalizer trainer split over ``data``: bit for
  bit;
- feedforward clock recovery of signals at different clock offsets split
  over ``data``: bit for bit, and the retimed signals closer to the clean
  waveform than the offset ones.
"""

import argparse

import numpy as np
import torch

from opticommpy_torch.parallel.distributed import init_distributed
from opticommpy_torch.parallel.mesh import P, _mesh, make_mesh
from opticommpy_torch.parallel.sharded import (_data_parallel, manakov_ssf_dp, manakov_ssf_pp,
                                               manakov_ssf_sp, sharded_edc, sharded_fir)
from opticommpy_torch.utils.rng import default_device

__all__ = ["dryrun_multichip"]


def _bandlimited(rng, n, cols, band=0.35, scale=0.01):
    """Band-limited complex64 columns: the halo-truncation bound of the
    sequence-parallel stages assumes a finite band-edge group delay."""
    z = rng.normal(size=(n, cols)) + 1j * rng.normal(size=(n, cols))
    Zf = np.fft.fft(z, axis=0)
    Zf[np.abs(np.fft.fftfreq(n)) > band] = 0
    return (scale * np.fft.ifft(Zf, axis=0)).astype(np.complex64)


def _rel_err(a, b):
    a = a.detach().cpu().to(torch.complex128)
    b = b.detach().cpu().to(torch.complex128)
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def _power(y):
    return float(torch.mean((y * y.conj()).real))


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def dryrun_multichip(n_devices=None, device=None):
    """Run every parallel route once on the process group's ranks and check
    each stage against the unsharded port call; returns the stages' errors.

    ``n_devices`` must be the group's size (the size by default). Tensors
    live on ``device``, the CUDA device by default (without a card this
    raises unless ``device='cpu'``); a process with no group opens one of
    its own first (NCCL on a card, gloo for the CPU).
    """
    from opticommpy_torch.comm import fec_qc
    from opticommpy_torch.comm.fec import encode_ldpc, standard_ldpc
    from opticommpy_torch.comm.modulation import gray_mapping
    from opticommpy_torch.dsp.clock_recovery import FFWClockRecoveryConfig, ffw_clock_recovery
    from opticommpy_torch.dsp.equalization import (EDCConfig, MIMOEqualizerConfig, edc,
                                                   mimo_adapt_equalizer_batch)
    from opticommpy_torch.models import SSFMConfig, manakov_ssf
    from opticommpy_torch.ops import fir_filter, pulse_shape, upsample
    from opticommpy_torch.ops.signal import clock_sampling_interp, pnorm

    dev = default_device(device)
    rank, world = init_distributed(device=dev)
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs a group of {n_devices} "
                           f"ranks, the group has {world}")
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    # factor the ranks into (data, time)
    n_time = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_time
    mesh = make_mesh(n_data, n_time, device_type=dev.type)
    k_signals = n_data  # one WDM signal per data block
    n = 2048 * n_time
    fs = 32e9 * 4
    cfg = SSFMConfig(Ltotal=50.0, Lspan=50.0, hz=10.0, alpha=0.2, D=16.0, gamma=1.3, Fs=fs,
                     amp="ideal", nlprMethod=False, trapIters=1)
    # 256 taps: the 50 km CD impulse at this bandwidth spans ~100 samples
    edc_cfg = EDCConfig(L=cfg.Ltotal, D=cfg.D, Fs=fs, Rs=32e9, NfilterCoeffs=256)
    taps = 33
    h = np.hamming(taps).astype(np.float32)
    h = as_t(h / h.sum())

    rng = np.random.default_rng(0)
    e0 = as_t(_bandlimited(rng, n, 2 * k_signals))
    e_dp = manakov_ssf_dp(e0, cfg, None, mesh)
    # the sequence-parallel receive step keeps the batch split and adds the
    # time split: a local slice, no gather in between
    y = sharded_fir(sharded_edc(e_dp, edc_cfg, mesh, mode_axis="data"), h, mesh,
                    mode_axis="data")
    p = _power(y)
    _check(np.isfinite(p), "dryrun produced non-finite power")
    e_ref = manakov_ssf(e0, cfg)
    err_dp = _rel_err(e_dp, e_ref)
    y_ref = fir_filter(h, edc(e_ref, edc_cfg))
    # the interior: the 5e-2 band of sharded_edc excludes the filter edges
    err_step = _rel_err(y[600:-600], y_ref[600:-600])
    _check(err_dp < 1e-3, f"dp stage vs single device: rel err {err_dp:.2e}")
    _check(err_step < 5e-2, f"dp+sp step vs single device: rel err {err_step:.2e}")

    # pp: spans pipelined over every rank
    stage_mesh = _mesh((n_devices,), ("stage",), device_type=dev.type)
    cfg_pp = SSFMConfig(Ltotal=25.0 * n_devices, Lspan=25.0, hz=12.5, alpha=0.2, D=16.0,
                        gamma=1.3, Fs=fs, amp="ideal", nlprMethod=False, trapIters=1)
    e_pp = e0.repeat(1, max(1, n_devices // k_signals))
    out_pp = manakov_ssf_pp(e_pp, cfg_pp, None, stage_mesh, n_microbatches=e_pp.shape[1] // 2)
    p_pp = _power(out_pp)
    _check(np.isfinite(p_pp), "pp dryrun produced non-finite power")
    err_pp = _rel_err(out_pp, manakov_ssf(e_pp, cfg_pp))
    _check(err_pp < 1e-3, f"pp stage vs single device: rel err {err_pp:.2e}")

    # sp: one signal's time axis over every rank, cyclic halos each span
    sp_mesh = _mesh((1, n_devices), ("data", "time"), device_type=dev.type)
    e_sp = as_t(_bandlimited(rng, 512 * n_devices, 2))  # local block 512 >= 2 x halo
    out_sp = manakov_ssf_sp(e_sp, cfg, mesh=sp_mesh, halo=128)
    p_sp = _power(out_sp)
    _check(np.isfinite(p_sp), "sp dryrun produced non-finite power")
    err_sp = _rel_err(out_sp, manakov_ssf(e_sp, cfg))
    _check(err_sp < 5e-3, f"sp-SSFM vs single device: rel err {err_sp:.2e}")

    # DCN-shaped stage: the outer dim stands for the hosts of a multi-host
    # run (the WDM batch on it), the inner for the devices of one host (the
    # time axis on it)
    p_dcn = err_dcn = None
    if n_devices >= 4:
        dcn_mesh = _mesh((2, n_devices // 2), ("dcn", "ici"), device_type=dev.type)
        e_dcn = as_t(_bandlimited(rng, n, 4))
        gen = torch.Generator(device=dev).manual_seed(1)
        out_dcn = manakov_ssf_dp(e_dcn, cfg, gen, dcn_mesh, data_axis="dcn")
        err_dcn = _rel_err(out_dcn, manakov_ssf(e_dcn, cfg))
        _check(err_dcn < 1e-3, f"dcn dp stage vs single device: rel err {err_dcn:.2e}")
        out_dcn = sharded_edc(out_dcn, edc_cfg, dcn_mesh, time_axis="ici", mode_axis="dcn")
        p_dcn = _power(out_dcn)
        _check(np.isfinite(p_dcn), "dcn dryrun produced non-finite power")

    # FEC dp: the QC DVB-S2 decode, codewords split over "data"
    n_fec, R_fec, k_fec = 64800, "4/5", 51840
    _, edges = standard_ldpc("DVBS2", n_fec, R_fec)
    B_fec = 2 * n_devices
    rng_f = np.random.default_rng(7)
    bits = as_t(rng_f.integers(0, 2, size=(k_fec, B_fec)).astype(np.int32))
    cw = encode_ldpc(bits, edges=edges).cpu().numpy()
    sigma = np.sqrt(0.5 * 10 ** (-3.2 / 10))  # above the NMSA-8 waterfall
    y_f = (1 - 2.0 * cw) + sigma * rng_f.normal(size=cw.shape)
    llr = as_t((2 * y_f / sigma**2).astype(np.float32))
    dec = fec_qc.make_qc_decoder(n_fec, R_fec, 8, "NMSA", "f32")
    fec_mesh = _mesh((n_devices,), ("data",), device_type=dev.type)
    dec_dp = _data_parallel(dec, fec_mesh, (P(None, "data"),),
                            (P(None, "data"), P("data"), P("data")))
    out_s, it_s, fail_s = dec_dp(llr)
    out_r, it_r, fail_r = dec(llr)
    _check(torch.equal(out_s < 0, out_r < 0), "sharded decode decisions differ")
    _check(torch.equal(it_s, it_r), "sharded decode iteration counts differ")
    _check(torch.equal(fail_s, fail_r), "sharded decode failure flags differ")
    n_ok = int(B_fec - int(fail_s.sum()))
    n_exact = int(((out_s < 0).cpu().numpy() == (cw > 0)).all(axis=0).sum())
    err_fec = _rel_err(out_s.float(), out_r.float())

    # training dp: the batched multi-stage equalizer trainer, signals split
    B_tr, n_tr = n_devices, 1024
    const = gray_mapping(16, "qam")
    const = const / np.sqrt(np.mean(np.abs(const) ** 2))
    sym_tr = const[rng_f.integers(0, 16, size=(B_tr, n_tr, 2))]
    x_tr = np.zeros((B_tr, n_tr * 2, 2), complex)
    x_tr[:, ::2] = sym_tr
    mix = np.eye(2) + 0.1 * (rng_f.normal(size=(2, 2)) + 1j * rng_f.normal(size=(2, 2)))
    sig_tr = as_t((x_tr @ mix.T + 0.01 * (rng_f.normal(size=x_tr.shape)
                                          + 1j * rng_f.normal(size=x_tr.shape))
                   ).astype(np.complex64))
    sym_tr = as_t(sym_tr.astype(np.complex64))
    eq_cfg = MIMOEqualizerConfig(nTaps=9, SpS=2, mu=(2e-3, 1e-3), alg=("nlms", "dd-lms"),
                                 L=(400, n_tr - 400), M=16, numIter=2, backend="pallas")

    def train(s, r):
        return mimo_adapt_equalizer_batch(s, eq_cfg, symb_ref=r)

    y_ts = _data_parallel(train, fec_mesh, (P("data"), P("data")), P("data"))(sig_tr, sym_tr)
    y_tr = train(sig_tr, sym_tr)
    _check(torch.equal(y_ts, y_tr), "sharded multi-stage training differs from the batch")
    mse_tr = float(torch.mean(torch.abs(y_ts[:, -256:] - sym_tr[:, -256:]) ** 2))

    # clock-recovery dp: signals at different clock offsets, split
    B_cr, n_cr = n_devices, 4096  # samples at 2 SpS
    sym_cr = as_t(const[rng_f.integers(0, 16, size=(n_cr // 2, 2))].astype(np.complex64))
    pulse = as_t(pulse_shape("rrc", 2, 257, 0.1).astype(np.float32))
    base = pnorm(fir_filter(pulse, upsample(sym_cr, 2)))
    ppms = np.linspace(50.0, 300.0, B_cr)
    sig_cr = torch.stack([clock_sampling_interp(base, 2.0, 2.0 * (1 + ppm * 1e-6))[:n_cr]
                          for ppm in ppms])
    cr_cfg = FFWClockRecoveryConfig(blockLen=512, rollOff=0.1)

    def cr_stage(s):
        return torch.stack([ffw_clock_recovery(x, cr_cfg) for x in s])

    y_crs = _data_parallel(cr_stage, fec_mesh, (P("data"),), P("data"))(sig_cr)
    y_cr = cr_stage(sig_cr)
    _check(torch.equal(y_crs, y_cr), "sharded clock recovery differs from the batch")
    n_out = y_cr.shape[1]
    ref_cr = base[None, :n_out]
    mse_rec = float(torch.mean(torch.abs(y_cr[:, 64:-64] - ref_cr[:, 64:-64]) ** 2))
    mse_off = float(torch.mean(torch.abs(sig_cr[:, 64:n_out - 64] - ref_cr[:, 64:-64]) ** 2))
    _check(mse_rec < mse_off, f"retimed MSE {mse_rec} not below the offset's {mse_off}")

    say = print if rank == 0 else (lambda *a: None)
    say(f"dryrun_multichip({n_devices}) on {dev.type}: ok, mean output power {p:.3e}, "
        f"pp power {p_pp:.3e}, sp power {p_sp:.3e}, dcn power {p_dcn}")
    say(f"  stage self-checks vs single device (rel err): dp {err_dp:.2e} (<1e-3), "
        f"dp+sp step {err_step:.2e} (<5e-2), pp {err_pp:.2e} (<1e-3), sp-SSFM "
        f"{err_sp:.2e} (<5e-3), dcn dp "
        f"{err_dcn if err_dcn is None else f'{err_dcn:.2e}'} (<1e-3)")
    say(f"  FEC dp stage (QC DVB-S2 {n_fec}b R{R_fec}, B={B_fec} split over {n_devices}): "
        f"decisions/iters/fails bit-exact vs single device (totals rel err "
        f"{err_fec:.1e}); {n_ok}/{B_fec} converged, {n_exact}/{B_fec} error-free")
    say(f"  training dp stage (nlms -> dd-lms, B={B_tr} split over {n_devices}): bit-exact "
        f"vs the batch; converged tail MSE {mse_tr:.2e}")
    say(f"  clock-recovery dp stage (ffw, B={B_cr} signals at {ppms[0]:.0f}-"
        f"{ppms[-1]:.0f} ppm split over {n_devices}): bit-exact vs the batch; retimed MSE "
        f"{mse_rec:.2e} vs offset {mse_off:.2e}")
    return dict(dp=err_dp, step=err_step, pp=err_pp, sp=err_sp, dcn=err_dcn, fec=err_fec,
                fec_ok=n_ok, fec_exact=n_exact, train_mse=mse_tr, cr_mse=(mse_rec, mse_off))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo over CPU processes; the CUDA device by default")
    args = ap.parse_args(argv)
    dryrun_multichip(device=args.device)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
