"""Lifted-circulant belief-propagation decoder for IEEE 802.11n and AR4JA
LDPC codes (port of ``opticommpy_tpu/comm/fec_lift.py``).

- **IEEE 802.11n**: H is an (mb, 24) base of Z x Z circulant-permutation
  blocks (Z = n/24 in {27, 54, 81}); every edge bundle between check
  block-row rb and variable block-column cb is a cyclic roll by the base
  shift of one (Z, B) plane.
- **AR4JA**: each M x M base block is a GF(2) sum of permutations
  ``pi(i) = Q*tq[i//Q] + (off[i//Q] + i) % Q`` (Q = M/4); split into
  quarter-planes of Q rows, every edge bundle is a cyclic roll of a (Q, B)
  plane.

So the code is planes of L rows, a static edge list (check plane, variable
plane, shift), check and variable sides bucketed by degree, and every
permutation a roll. Semantics (flooding schedule, freeze on convergence,
min-sum / NMSA / SPA, message storage type) are those of the QC decoder.

Backends of :func:`make_lift_decoder`: ``'xla'``, the plain roll route in
torch ops on any device; ``'pallas'``, one launch of the iteration kernel
K12 per iteration (:mod:`opticommpy_torch.kernels.lift`; its plain version
on CPU tensors); ``'auto'``: K12 for every MSA/NMSA decode of CUDA tensors
(K12 takes any lift, check degree and batch), else ``'xla'``. The JAX
package's 'auto' takes its TPU kernel only where the lift fits the TPU's
sublane tile and VMEM budget (AR4JA 8192 R1/2 at bf16); those limits are
the TPU's and are not carried over. An explicit ``'pallas'`` keeps the JAX
package's contract: it needs ``L % 8 == 0`` and MSA/NMSA, and raises
otherwise.
"""

from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from . import _code_tables
from .codes import _rate_tag
from .fec_qc import _msg_dtype, _plain_check_update

__all__ = ["lift_tables", "lift_backend", "make_lift_decoder"]


def _edges_80211(n, R):
    data = _code_tables.IEEE80211[f"{n}_{_rate_tag(R)}"]
    shifts = np.asarray(data["shifts"], dtype=np.int64)
    Z = n // 24
    mb = shifts.shape[0]
    edges = []
    for rb, cb in zip(*np.nonzero(shifts >= 0)):
        s = int(shifts[rb, cb])
        # check row i meets variable (i + s) % Z: check-aligned totals are
        # roll(T, -s); the back-roll to variable alignment is +s
        edges.append((int(rb), int(cb), (-s) % Z, s % Z))
    return Z, 24, mb, edges


def _edges_ar4ja(n, R):
    data = _code_tables.AR4JA[f"{n}_{_rate_tag(R)}"]
    M, nb = data["M"], data["nb"]
    mb = data["m"] // M
    Q = M // 4
    edges = []
    for key2, perms in data["blocks"].items():
        rb, cb = (int(v) for v in key2.split(","))
        for p in perms:
            for j in range(4):
                tq, off = int(p[j][0]), int(p[j][1])
                edges.append((rb * 4 + j, cb * 4 + tq, (-off) % Q, off % Q))
    # GF(2) cancellation of duplicate (check, var, shift) triples, as
    # codes.ar4ja_edges does (none survive in the shipped tables)
    cnt = Counter(edges)
    edges = [e for e, c in cnt.items() if c % 2 == 1]
    return Q, nb * 4, mb * 4, edges


@lru_cache(maxsize=None)
def lift_tables(mode, n, R):
    """Static plane/edge addressing of one lifted-circulant code (plain
    NumPy arrays and Python ints):

    - ``L, V, C, E``: lift size, number of variable, check and edge planes.
    - ``chk_buckets``: ((d, ng), ...) check planes by degree; per bucket
      ``ev/esh`` (d, ng): variable plane (bucket-order position) and
      T-roll per edge slot. Edge ids are bucket-major, slot-major: ``eid =
      off + sl * ng + ig``.
    - ``var_buckets``: ((dv, ngv), ...); per bucket ``ve/vsh`` (dv, ngv):
      edge id and back-roll per variable-plane entry, in the order the
      check side meets them (bucket, group, slot).
    - ``var_order/pos_of_v``: natural plane id <-> bucket-order position.
    """
    if mode == "IEEE_802.11nD2":
        L, V, C, edges = _edges_80211(n, R)
    elif mode == "AR4JA":
        L, V, C, edges = _edges_ar4ja(n, R)
    else:
        raise ValueError(f"no lift construction for mode {mode!r}")

    by_chk = [[] for _ in range(C)]
    for c, v, tsh, bsh in edges:
        by_chk[c].append((v, tsh, bsh))
    for lst in by_chk:
        lst.sort()
    cdeg = np.array([len(lst) for lst in by_chk])
    if (cdeg == 0).any():
        raise ValueError("check plane with no edges")
    chk_order = np.lexsort((np.arange(C), cdeg))

    vdeg = np.zeros(V, np.int64)
    for c, v, tsh, bsh in edges:
        vdeg[v] += 1
    var_order = np.lexsort((np.arange(V), vdeg)).astype(np.int32)
    pos_of_v = np.empty(V, np.int32)
    pos_of_v[var_order] = np.arange(V, dtype=np.int32)

    chk_buckets, ev_tabs, esh_tabs = [], [], []
    by_var = [[] for _ in range(V)]  # (eid, back-roll) per variable plane
    off = 0
    for d in np.unique(cdeg):
        cs = chk_order[cdeg[chk_order] == d]
        ng = int(cs.size)
        chk_buckets.append((int(d), ng))
        ev = np.empty((int(d), ng), np.int32)
        esh = np.empty((int(d), ng), np.int32)
        for ig, c in enumerate(cs):
            for sl, (v, tsh, bs) in enumerate(by_chk[c]):
                ev[sl, ig] = pos_of_v[v]
                esh[sl, ig] = tsh
                by_var[v].append((off + sl * ng + ig, bs))
        ev_tabs.append(ev)
        esh_tabs.append(esh)
        off += int(d) * ng

    var_buckets, ve_tabs, vsh_tabs = [], [], []
    for dv in np.unique(vdeg):
        vs = var_order[vdeg[var_order] == dv]
        ngv = int(vs.size)
        var_buckets.append((int(dv), ngv))
        ve = np.empty((int(dv), ngv), np.int32)
        vsh = np.empty((int(dv), ngv), np.int32)
        for ig, v in enumerate(vs):
            for sl, (eid, bs) in enumerate(by_var[v]):
                ve[sl, ig] = eid
                vsh[sl, ig] = bs
        ve_tabs.append(ve)
        vsh_tabs.append(vsh)

    return {
        "L": L, "V": V, "C": C, "E": off,
        "chk_buckets": tuple(chk_buckets), "ev": ev_tabs, "esh": esh_tabs,
        "var_buckets": tuple(var_buckets), "ve": ve_tabs, "vsh": vsh_tabs,
        "var_order": var_order, "pos_of_v": pos_of_v,
    }


def _roll(p, sh, L):
    """Cyclic roll of an (L, ...) plane along axis 0: ``out[l] = p[(l - sh)
    mod L]``."""
    sh = int(sh) % L
    if sh == 0:
        return p
    return torch.roll(p, sh, dims=0)


def lift_backend(mode, n, R, alg, on_cuda):
    """The route ``backend='auto'`` takes: ``'pallas'`` (K12) for CUDA
    tensors and the MSA/NMSA algorithms, at any lift and message type of the
    codes :func:`lift_tables` builds; ``'xla'`` for SPA, which has no
    kernel, and on the CPU."""
    lift_tables(mode, n, R)  # raises for a mode with no lift construction
    return "pallas" if on_cuda and alg in ("MSA", "NMSA") else "xla"


def make_lift_decoder(mode, n, R, max_iter, alg="MSA", msg_dtype="f32", early_exit=False,
                      backend="auto"):
    """Build ``decode(llrs (V*L, B) float32) -> (out_llr, n_iters, fail)``.

    Same contract and semantics as
    :func:`~opticommpy_torch.comm.fec_qc.make_qc_decoder`; the code
    structure comes from :func:`lift_tables`. ``early_exit`` stops once the
    whole batch has converged (one device-to-host read per iteration;
    identical outputs either way). ``backend``: 'auto' | 'xla' | 'pallas'
    (module docstring); 'auto' is resolved per call from the LLRs' device
    (:func:`lift_backend`).
    """
    L = lift_tables(mode, n, R)["L"]
    if backend == "pallas" and (L % 8 != 0 or alg not in ("MSA", "NMSA")):
        raise ValueError(f"pallas lift backend needs L%8==0 and MSA/NMSA (got L={L}, "
                         f"alg={alg}); use backend='xla'")
    if backend != "auto":
        return _make_lift_decoder(mode, n, R, max_iter, alg, msg_dtype, early_exit, backend)

    def decode(llrs):
        route = lift_backend(mode, n, R, alg, llrs.is_cuda)
        return _make_lift_decoder(mode, n, R, max_iter, alg, msg_dtype, early_exit,
                                  route)(llrs)

    return decode


@lru_cache(maxsize=None)
def _make_lift_decoder(mode, n, R, max_iter, alg, msg_dtype, early_exit, backend):
    tb = lift_tables(mode, n, R)
    L, V = tb["L"], tb["V"]
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "pallas" and alg not in ("MSA", "NMSA"):
        raise ValueError(f"the lift kernel K12 runs MSA/NMSA, not {alg}; use backend='xla'")
    mdt = _msg_dtype(msg_dtype)
    check_update = _plain_check_update(alg)
    var_order, pos_back = tb["var_order"], tb["pos_of_v"]

    def v2c(T):
        """Check-aligned totals per bucket: list of (d, ng, L, B) in the
        message type."""
        out = []
        for (d, ng), ev, esh in zip(tb["chk_buckets"], tb["ev"], tb["esh"]):
            planes = [_roll(T[ev[sl, ig]], esh[sl, ig], L) for sl in range(d) for ig in range(ng)]
            out.append(torch.stack(planes).reshape(d, ng, L, -1).to(mdt))
        return out

    def c2v_sum(M_flat, llr_bo):
        """Bucket-order totals T (V, L, B) float32: each plane's channel LLR
        plus its messages rolled back, added one by one in the order the
        check side meets them (the kernel's order)."""
        sums, off = [], 0
        for (dv, ngv), ve, vsh in zip(tb["var_buckets"], tb["ve"], tb["vsh"]):
            acc = llr_bo[off:off + ngv]
            for sl in range(dv):
                acc = acc + torch.stack([_roll(M_flat[ve[sl, ig]], vsh[sl, ig], L)
                                         for ig in range(ngv)]).float()
            sums.append(acc)
            off += ngv
        return torch.cat(sums)

    def split(llrs):
        B = llrs.shape[1]
        order = torch.as_tensor(var_order, dtype=torch.long, device=llrs.device)
        return llrs.reshape(V, L, B)[order]

    def finish(fT, n_iters, done):
        pos = torch.as_tensor(pos_back, dtype=torch.long, device=fT.device)
        return fT[pos].reshape(V * L, fT.shape[-1]), n_iters, ~done

    if backend == "pallas":
        from opticommpy_torch.kernels import lift as liftk

        alpha = 0.75 if alg == "NMSA" else None
        layouts = {}

        def decode_kernel(llrs):
            dev = llrs.device
            lay = layouts.get(dev)
            if lay is None:
                lay = layouts[dev] = liftk.LiftLayout(tb, dev)
            llr_bo = split(llrs)
            B = llr_bo.shape[-1]
            X = torch.cat([x.reshape(-1, L, B) for x in v2c(llr_bo)])
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            fT, n_iters = llr_bo, torch.zeros(B, dtype=torch.int32, device=dev)
            for _ in range(max_iter):
                if early_exit and bool(done.all()):
                    break
                X, T, ok = liftk.lift_iter(X, llr_bo, lay, alpha)
                fT = torch.where(done, fT, T)
                n_iters = torch.where(done, n_iters, n_iters + 1)
                done = done | ok
            return finish(fT, n_iters, done)

        return decode_kernel

    def decode(llrs):
        llr_bo = split(llrs)
        B, dev = llr_bo.shape[-1], llr_bo.device
        Xb = v2c(llr_bo)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        fT, n_iters = llr_bo, torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(max_iter):
            if early_exit and bool(done.all()):
                break
            Ms = [check_update(x) for x in Xb]
            T = c2v_sum(torch.cat([m.reshape(-1, L, B) for m in Ms]), llr_bo)
            tot = v2c(T)
            Xb = [t - m for t, m in zip(tot, Ms)]
            ok = torch.ones(B, dtype=torch.bool, device=dev)
            for t in tot:
                par = torch.sum(t < 0, dim=0, dtype=torch.int32) & 1
                ok = ok & torch.all((par == 0).reshape(-1, B), dim=0)
            fT = torch.where(done, fT, T)
            n_iters = torch.where(done, n_iters, n_iters + 1)
            done = done | ok
        return finish(fT, n_iters, done)

    return decode
