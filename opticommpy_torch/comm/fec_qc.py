"""Quasi-cyclic belief-propagation decoder for DVB-S2 LDPC codes (port of
``opticommpy_tpu/comm/fec_qc.py``).

The ETSI EN 302 307-1 construction is quasi-cyclic: info bit ``i = 360 g +
t`` meets checks ``(x + t q) mod m``, so writing checks as a ``(Z=360, q)``
plane (``c = q s + a0``), every info edge bundle is a cyclic roll by
``x // q`` along the Z axis of one 360-row plane, and the accumulator
staircase is a one-position shift in flat check order.

Message layout: ``X[(S+2), q, Z, B]``, variable-to-check messages in check
alignment (row s of plane ``(sl, a0)`` belongs to check ``c = q s + a0``).
Slots ``0..S-1`` hold the S info entries of each check column, slot ``S``
the accumulator self edge ``p_j -> c_j``, slot ``S+1`` the staircase edge
``p_{j-1} -> c_j`` (masked at ``j = 0``: check 0 has degree dc - 1).

Backends of :func:`make_qc_decoder`:

- ``'xla'``: the plain route in torch ops (the JAX package's XLA route:
  rolls, stacks and the slot-axis check update), on any device;
- ``'pallas'``: the same with the check update on K8
  (:mod:`opticommpy_torch.kernels.ldpc`);
- ``'fused'``: carry ``(M, T, Tp)``, one K9 and one K10 launch per step
  (:mod:`opticommpy_torch.kernels.qc`); on CPU tensors their plain versions;
- ``'auto'``: by the LLRs' device, as the JAX package routes: ``'xla'`` on
  the CPU and for SPA; on CUDA, MSA/NMSA go to ``'fused'`` where the JAX
  package's megakernel would not take them (:func:`takes_megakernel`), and
  raise ``NotImplementedError`` where it would.

The megakernel (``'mega'``, K11) and the ``layered`` schedule are not ported
yet (``ROADMAP.md`` queue 2, item 8); they raise ``NotImplementedError``.
"""

from functools import lru_cache

import numpy as np
import torch

from . import _code_tables
from .codes import _rate_tag

Z = 360  # ETSI EN 302 307-1 group size

_NOT_PORTED = ("is not ported yet: the DVB-S2 megakernel (K11) and its "
               "layered schedule are ROADMAP.md queue 2, item 8; use "
               "schedule='flooding' with backend 'auto', 'fused', 'pallas' "
               "or 'xla'")

# the JAX package's megakernel keeps the whole decoder state of a
# 128-codeword tile resident and takes a configuration when that state fits
# this budget (opticommpy_tpu/kernels/qc_mega.py:311-336)
_MEGA_BUDGET = 100 * 2**20
_MEGA_TILE = 128


def qc_tables(R="4/5", n=64800):
    """Static QC addressing tables of one DVB-S2 code (plain NumPy arrays
    and Python ints, host-side):

    - ``g_tab, s_tab`` (q, S): per check column ``a0``, the info group and
      roll amount ``x1 = x // q`` of each of its S entries.
    - ``buckets``: tuple of ``(deg, n_groups)`` variable-degree buckets.
    - ``order_rows`` (G,): group ids in bucket order (degree-major).
    - ``pos_of_g`` (G,): position of canonical group g in bucket order.
    - ``ent_addr``: per bucket, (n_groups, deg, 3) int array of each group
      entry's (a0, slot, shift) address, a0 ascending, then slot.
    """
    data = _code_tables.DVBS2[f"{n}_{_rate_tag(R)}"]
    k = data["k"]
    m = n - k
    q = m // Z
    G = k // Z
    cols = [[] for _ in range(q)]
    for g, row in enumerate(data["table"]):
        for x in row:
            cols[x % q].append((g, x // q))
    S = len(cols[0])
    if any(len(c) != S for c in cols):  # pragma: no cover - none shipped
        raise ValueError("non-uniform check-column degrees; use fec decoder")
    g_tab = np.array([[e[0] for e in c] for c in cols], np.int32)
    s_tab = np.array([[e[1] for e in c] for c in cols], np.int32)
    ent = [[] for _ in range(G)]
    for a0 in range(q):
        for sl in range(S):
            ent[g_tab[a0, sl]].append((a0, sl, s_tab[a0, sl]))
    gdeg = np.array([len(e) for e in ent], np.int64)
    order_rows = np.lexsort((np.arange(G), gdeg)).astype(np.int32)
    pos_of_g = np.empty(G, np.int32)
    pos_of_g[order_rows] = np.arange(G, dtype=np.int32)
    buckets, ent_addr = [], []
    for d in np.unique(gdeg):
        gs = order_rows[gdeg[order_rows] == d]
        buckets.append((int(d), int(gs.size)))
        ent_addr.append(np.array([ent[g] for g in gs], np.int32).reshape(gs.size, int(d), 3))
    return {
        "n": n, "k": k, "m": m, "q": q, "G": G, "S": S,
        "g_tab": g_tab, "s_tab": s_tab,
        "buckets": tuple(buckets), "ent_addr": ent_addr,
        "order_rows": order_rows, "pos_of_g": pos_of_g,
    }


def takes_megakernel(tb, msg_dtype):
    """Whether the JAX package's ``'auto'`` route on an accelerator decodes
    the code ``tb`` (MSA/NMSA, flooding) with ``msg_dtype`` messages on its
    megakernel K11 (``opticommpy_tpu/comm/fec_qc.py:406-457``): when the
    flooding state of a 128-codeword tile fits the megakernel's budget,
    whatever the batch (smaller batches are padded to the tile). True for
    bfloat16 at every rate, and for float32 at 1/4, 1/3, 2/5, 1/2 and 2/3."""
    msz = 2 if msg_dtype == "bf16" else 4
    bt, D = _MEGA_TILE, tb["S"] + 2
    nbytes = ((tb["G"] + tb["q"]) * Z * bt * (msz + 4 + 4)  # totals, accumulators, outputs
              + 2 * D * Z * bt * msz  # messages and edge values of one column
              + 8 * Z * bt * 4)  # roll and vote planes
    return nbytes <= _MEGA_BUDGET


def slot_tables(tb):
    """(pos, sh) (S, q) NumPy: the T plane (bucket order) and the roll of
    each info slot of each check column."""
    pos = np.ascontiguousarray(tb["pos_of_g"][tb["g_tab"]].T)
    return pos, np.ascontiguousarray(tb["s_tab"].T % Z)


def _roll(p, sh):
    """Cyclic roll of a (Z, ...) plane along axis 0, ``jnp.roll``'s
    direction: ``out[z] = p[(z - sh) mod Z]``."""
    sh = int(sh) % Z
    if sh == 0:
        return p
    return torch.roll(p, sh, dims=0)


def _check_msa_slots(x):
    """Min-sum leave-one-out along axis 0 of (D, ...), dtype-preserving.

    Exact exclusive minimum by prefix/suffix min chains over the D slabs,
    ``out_mag[i] = min(mag[:i], mag[i+1:])``; min and sign are exact in
    bf16, so the update runs in the storage type. +inf inputs are neutral
    (the masked staircase slot of check 0).
    """
    D = x.shape[0]
    mag = torch.abs(x)
    inf = torch.full_like(mag[:1], float("inf"))
    fe = [inf]  # fe[i] = min(mag[:i])
    for i in range(1, D):
        fe.append(torch.minimum(fe[-1], mag[i - 1:i]))
    be = [inf]  # be[i] = min(mag[i+1:]), built backwards
    for i in range(D - 1, 0, -1):
        be.append(torch.minimum(be[-1], mag[i:i + 1]))
    be.reverse()
    out_mag = torch.cat([torch.minimum(f, b) for f, b in zip(fe, be)], dim=0)
    neg = x < 0
    par = torch.sum(neg, dim=0, keepdim=True, dtype=torch.int32) & 1
    flip = torch.where(neg, 1 - par, par)  # parity of the other slots' signs
    return torch.where(flip == 1, -out_mag, out_mag)


def _check_spa_slots(x):
    """SPA leave-one-out along axis 0 of (D, ...): exclusive tanh products
    by the same prefix/suffix chains, float32 math, cast back."""
    dt = x.dtype
    D = x.shape[0]
    t = torch.tanh(x.float() / 2.0)
    one = torch.ones_like(t[:1])
    fe = [one]
    for i in range(1, D):
        fe.append(fe[-1] * t[i - 1:i])
    be = [one]
    for i in range(D - 1, 0, -1):
        be.append(be[-1] * t[i:i + 1])
    be.reverse()
    prod = torch.cat([f * b for f, b in zip(fe, be)], dim=0)
    prod = torch.clamp(prod, -0.999999, 0.999999)
    return (2.0 * torch.atanh(prod)).to(dt)


def _msg_dtype(msg_dtype):
    return torch.bfloat16 if msg_dtype == "bf16" else torch.float32


def _split_llrs(tb, llrs):
    """(info LLRs (G, Z, B) in bucket order, parity LLRs (q, Z, B))."""
    k, q, G = tb["k"], tb["q"], tb["G"]
    B = llrs.shape[1]
    order = torch.as_tensor(tb["order_rows"], dtype=torch.long, device=llrs.device)
    llr_info = llrs[:k].reshape(G, Z, B)[order]
    llr_p = llrs[k:].reshape(Z, q, B).permute(1, 0, 2).contiguous()
    return llr_info, llr_p


def _staircase_back(M_stair):
    """Parity-side sums of the staircase messages: (q, Z, B) float32 with
    ``out[a0] = M[a0 + 1]`` and ``out[q-1][z] = M[0][z + 1]``; the masked
    message of check 0 counts as 0."""
    Mp = M_stair.to(torch.float32, copy=True)
    Mp[0, 0] = 0.0
    return torch.cat([Mp[1:], torch.roll(Mp[:1], -1, dims=1)], dim=0)


def v2c_totals(T, Tp, pos, sh, mdt):
    """Per-edge totals (S+2, q, Z, B) in the type ``mdt`` from the
    bucket-order totals T (G, Z, B) and Tp (q, Z, B): slot ``sl`` of check
    column ``a0`` is plane ``pos[sl, a0]`` of T rolled by ``sh[sl, a0]``
    (:func:`slot_tables`); slot S is p_j at check j, slot S+1 the staircase
    edge p_{j-1} at check j."""
    S, q = pos.shape
    slots = [torch.stack([_roll(T[pos[sl, a0]], sh[sl, a0]) for a0 in range(q)]).to(mdt)
             for sl in range(S)]
    shiftfwd = torch.cat([torch.roll(Tp[-1:], 1, dims=1), Tp[:-1]], dim=0)
    return torch.stack(slots + [Tp.to(mdt), shiftfwd.to(mdt)])


def _outputs(tb, fT, fTp, n_iters, done):
    pos = torch.as_tensor(tb["pos_of_g"], dtype=torch.long, device=fT.device)
    B = fT.shape[-1]
    out_info = fT[pos].reshape(tb["G"] * Z, B)
    out_p = fTp.permute(1, 0, 2).reshape(tb["m"], B)
    return torch.cat([out_info, out_p]), n_iters, ~done


@lru_cache(maxsize=None)
def make_qc_decoder(n, R, max_iter, alg="MSA", msg_dtype="f32", early_exit=False,
                    backend="auto", schedule="flooding"):
    """Build ``decode(llrs (n, B) float32) -> (out_llr, n_iters, fail)``.

    ``msg_dtype`` is the storage type of the messages (math in float32).
    ``early_exit=True`` stops once every codeword converged, with outputs
    identical to the fixed loop (per-codeword results freeze at their own
    convergence either way); the loop reads the batch's flag back to the
    host once per step. ``backend``: 'auto' | 'xla' | 'pallas' | 'fused'
    (module docstring). ``schedule``: 'flooding'.
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "layered":
        raise NotImplementedError(f"schedule='layered' {_NOT_PORTED}")
    if backend == "mega":
        raise NotImplementedError(f"backend='mega' {_NOT_PORTED}")
    if backend not in ("auto", "xla", "pallas", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    tb = qc_tables(R, n)
    if backend == "fused":
        return _make_fused_decoder(tb, max_iter, alg, msg_dtype, early_exit)
    if backend == "pallas":
        from opticommpy_torch.kernels.ldpc import check_update_msa

        alpha = 0.75 if alg == "NMSA" else None
        return _make_roll_decoder(tb, max_iter, msg_dtype, early_exit,
                                  lambda x: check_update_msa(x, alpha))
    xla = _make_roll_decoder(tb, max_iter, msg_dtype, early_exit, _plain_check_update(alg))
    if backend == "xla" or alg not in ("MSA", "NMSA"):
        return xla
    if takes_megakernel(tb, msg_dtype):
        def decode(llrs):
            if llrs.is_cuda:
                raise NotImplementedError(
                    f"make_qc_decoder(backend='auto') on CUDA: the JAX package "
                    f"decodes DVB-S2 R{R} {alg} with {msg_dtype} messages on its "
                    f"megakernel (K11), which is not ported yet (ROADMAP.md queue "
                    f"2, item 8); decode with msgDtype='f32' at rate 3/5, 3/4, "
                    f"4/5, 5/6, 8/9 or 9/10, or build make_qc_decoder(..., "
                    f"backend='fused') for the K9/K10 route")
            return xla(llrs)

        return decode
    fused = _make_fused_decoder(tb, max_iter, alg, msg_dtype, early_exit)

    def decode(llrs):
        return fused(llrs) if llrs.is_cuda else xla(llrs)

    return decode


def _plain_check_update(alg):
    if alg == "SPA":
        return _check_spa_slots
    if alg == "NMSA":
        # normalized min-sum (alpha=0.75, exact in bf16)
        return lambda x: (0.75 * _check_msa_slots(x).float()).to(x.dtype)
    return _check_msa_slots


def _make_roll_decoder(tb, max_iter, msg_dtype, early_exit, check_update):
    """The plain roll route (``'xla'``; ``'pallas'`` with K8 as the check
    update), carry = the edge tensor X."""
    S = tb["S"]
    pos, sh = slot_tables(tb)
    mdt = _msg_dtype(msg_dtype)

    def c2v_info_sum(M):
        """Bucket-order (G, Z, B) float32 sums of the check messages rolled
        back to variable alignment."""
        out = []
        for bi, (d, ng) in enumerate(tb["buckets"]):
            addr = tb["ent_addr"][bi].reshape(ng * d, 3).tolist()
            planes = torch.stack([_roll(M[sl, a0], -sh) for a0, sl, sh in addr])
            out.append(planes.reshape(ng, d, *planes.shape[1:]).float().sum(dim=1))
        return torch.cat(out)

    def decode(llrs):
        B = llrs.shape[1]
        dev = llrs.device
        llr_info, llr_p = _split_llrs(tb, llrs)
        X = v2c_totals(llr_info, llr_p, pos, sh, mdt)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        fT, fTp = llr_info, llr_p
        n_iters = torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(max_iter):
            # early exit: one device-to-host read of the batch flag per step
            if early_exit and bool(done.all()):
                break
            X[S + 1, 0, 0] = float("inf")  # no p_{-1} at check 0
            M = check_update(X)
            T = llr_info + c2v_info_sum(M)
            Tp = llr_p + M[S].float() + _staircase_back(M[S + 1])
            tot_e = v2c_totals(T, Tp, pos, sh, mdt)
            X = tot_e - M
            bits = tot_e < 0
            bits[S + 1, 0, 0] = False
            ok = torch.all(torch.sum(bits, dim=0, dtype=torch.int32) % 2 == 0, dim=0)
            ok = torch.all(ok, dim=0)
            fT = torch.where(done, fT, T)
            fTp = torch.where(done, fTp, Tp)
            # X itself is not frozen: every output is, and done latches
            n_iters = torch.where(done, n_iters, n_iters + 1)
            done = done | ok
        return _outputs(tb, fT, fTp, n_iters, done)

    return decode


def fused_init(tb, llrs, msg_dtype):
    """The fused route's inputs and its carry before step 0: (llr_info
    (G, Z, B) float32 in bucket order, llr_p (q, Z, B), carry) with the
    carry a dict of the messages ``M``, the totals in the message type
    ``Tc`` and ``Tpc``, ``done``, the frozen outputs ``fT`` and ``fTp``, and
    ``n_iters``."""
    B, dev = llrs.shape[1], llrs.device
    mdt = _msg_dtype(msg_dtype)
    llr_info, llr_p = _split_llrs(tb, llrs)
    llr_info = llr_info.contiguous()
    carry = dict(M=torch.zeros((tb["S"] + 2, tb["q"], Z, B), dtype=mdt, device=dev),
                 Tc=llr_info.to(mdt), Tpc=llr_p.to(mdt),
                 done=torch.zeros(B, dtype=torch.bool, device=dev), fT=llr_info, fTp=llr_p,
                 n_iters=torch.zeros(B, dtype=torch.int32, device=dev))
    return llr_info, llr_p, carry


def fused_step(carry, llr_info, llr_p, lay, alpha, kk, K, plain=False):
    """Step ``kk`` of the ``K`` steps of the fused route, updating ``carry``
    (:func:`fused_init`) in place: K9, the delayed vote and the parity
    totals, then K10. ``lay`` is the :class:`~opticommpy_torch.kernels.qc.
    QCLayout` of the code on the tensors' device. With ``plain`` the step
    runs the kernels' plain versions on any device."""
    from opticommpy_torch.kernels import qc as qck

    check = qck.check_column_plain if plain else qck.check_column_update
    var = qck.var_totals_plain if plain else qck.var_totals_update
    S = lay.S
    M, ok_in = check(carry["Tc"], carry["Tpc"], carry["M"], lay, alpha)
    carry["M"] = M
    done = carry["done"] | ok_in if kk > 0 else carry["done"]
    last = kk == K - 1
    if not last:
        carry["n_iters"] = carry["n_iters"] + (~done).to(torch.int32)
    freeze = done | last
    Tp = llr_p + M[S].float() + _staircase_back(M[S + 1])
    carry["fTp"] = torch.where(freeze, carry["fTp"], Tp)
    T, carry["fT"], Tc = var(M, llr_info, carry["fT"], freeze, lay,
                             msg_copy=M.dtype == torch.bfloat16)
    carry.update(done=done, Tc=T if Tc is None else Tc, Tpc=Tp.to(M.dtype))


def _make_fused_decoder(tb, max_iter, alg, msg_dtype, early_exit):
    """The fused route: carry ``(M, T, Tp)``, K9 then K10 per step.

    The edge tensor X = v2c(T) - M is never stored: K9 recomputes it from
    the totals. The parity vote of iteration j's totals is seen only when
    the next K9 pass reads them, so the done/freeze bookkeeping runs one
    step delayed: step kk folds the vote of its input totals (discarded at
    kk = 0, where they are the channel LLRs), the loop runs max_iter + 1
    steps, and the last step only contributes its vote. Outputs equal the
    plain route's up to float32 summation order.
    """
    from opticommpy_torch.kernels import qc as qck

    if alg not in ("MSA", "NMSA"):
        raise ValueError("fused QC decoder supports MSA/NMSA only")
    alpha = 0.75 if alg == "NMSA" else None
    K = max_iter + 1
    layouts = {}

    def decode(llrs):
        dev = llrs.device
        lay = layouts.get(dev)
        if lay is None:
            lay = layouts[dev] = qck.QCLayout(tb, dev)
        llr_info, llr_p, c = fused_init(tb, llrs, msg_dtype)
        for kk in range(K):
            # early exit: one device-to-host read of the batch flag per step
            if early_exit and bool(c["done"].all()):
                break
            fused_step(c, llr_info, llr_p, lay, alpha, kk, K)
        return _outputs(tb, c["fT"], c["fTp"], c["n_iters"], c["done"])

    return decode
