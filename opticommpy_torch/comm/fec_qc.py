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
- ``'mega'``: the whole decode in one launch of K11
  (:mod:`opticommpy_torch.kernels.qc_mega`), flooding or layered; on CPU
  tensors its plain version :func:`mega_decode_plain`. As in the JAX
  package, a flooding configuration that the megakernel's budget refuses
  (:func:`takes_megakernel`) takes the fused route instead;
- ``'auto'``: by the LLRs' device: on CUDA, every MSA/NMSA decode goes to
  K11 (both schedules, both message types, every rate: the card's K11 keeps
  no decoder state resident, so the TPU's budget does not bind it, and its
  flooding schedule equals ``'fused'`` bit for bit); SPA and CPU tensors go
  to ``'xla'``.

The ``layered`` schedule (serial-C: in-place float32 totals, later check
columns see earlier columns' new messages within a sweep) runs on
``'mega'`` only, or on ``'auto'`` with CUDA tensors.
"""

from functools import lru_cache

import numpy as np
import torch

from . import _code_tables
from .codes import _rate_tag

Z = 360  # ETSI EN 302 307-1 group size

# the JAX package's megakernel keeps the whole decoder state of a
# 128-codeword tile resident and takes a configuration when that state fits
# this budget (opticommpy_tpu/kernels/qc_mega.py:311-340); the port routes by
# the same rule
MEGA_VMEM_BUDGET = 100 * 2**20
_MEGA_TILE = 128


class MegaBudgetError(ValueError):
    """Megakernel resident state exceeds the budget."""


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


def mega_state_bytes(G, q, S, bt, msg_dtype, schedule="flooding"):
    """Bytes the JAX package's megakernel keeps resident for a tile of
    ``bt`` codewords with ``msg_dtype`` ('bf16' or 'f32') messages. The
    layered schedule keeps one float32 totals buffer, flooding the totals in
    the message type and a float32 accumulator."""
    msz = 2 if msg_dtype == "bf16" else 4
    D = S + 2
    GZ = G * Z
    if schedule == "layered":
        return (GZ * bt * (4 + 4)  # T (f32, in place), fT
                + q * Z * bt * (4 + 4)  # Tp, fTp
                + 2 * D * Z * bt * msz  # messages and edge values of one column
                + 8 * Z * bt * 4)  # roll and vote planes
    return (GZ * bt * (msz + 4 + 4)  # totals, accumulators, outputs
            + q * Z * bt * (msz + 4 + 4)
            + 2 * D * Z * bt * msz
            + 8 * Z * bt * 4)


def takes_megakernel(tb, msg_dtype, schedule="flooding"):
    """Whether the JAX package's ``'auto'`` route on an accelerator decodes
    the code ``tb`` (MSA/NMSA) with ``msg_dtype`` messages on its
    megakernel K11 (``opticommpy_tpu/comm/fec_qc.py:406-457``): when the
    state of a 128-codeword tile fits the megakernel's budget, whatever the
    batch (smaller batches are padded to the tile). Flooding: true for
    bfloat16 at every rate, and for float32 at 1/4, 1/3, 2/5, 1/2 and 2/3;
    layered: true for every shipped rate and type."""
    return (mega_state_bytes(tb["G"], tb["q"], tb["S"], _MEGA_TILE, msg_dtype, schedule)
            <= MEGA_VMEM_BUDGET)


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
    convergence either way): on ``'mega'`` each codeword's CTA stops on the
    device; the other routes read the batch's flag back to the host once
    per step. ``backend``: 'auto' | 'xla' | 'pallas' | 'fused' | 'mega'
    (module docstring). ``schedule``: 'flooding' or 'layered' (``'mega'``,
    or ``'auto'`` with CUDA tensors; raises ``ValueError`` elsewhere, as
    the JAX package does).
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "layered" and backend not in ("mega", "auto"):
        raise ValueError("schedule='layered' runs inside the megakernel only (backend 'mega' "
                         "or 'auto')")
    if backend not in ("auto", "xla", "pallas", "fused", "mega"):
        raise ValueError(f"unknown backend {backend!r}")
    kernel_alg = alg in ("MSA", "NMSA")
    if schedule == "layered" and backend == "auto" and not kernel_alg:
        raise ValueError(_LAYERED_NEEDS_MEGA)
    tb = qc_tables(R, n)
    if backend == "fused":
        return _make_fused_decoder(tb, max_iter, alg, msg_dtype, early_exit)
    if backend == "pallas":
        from opticommpy_torch.kernels.ldpc import check_update_msa

        alpha = 0.75 if alg == "NMSA" else None
        return _make_roll_decoder(tb, max_iter, msg_dtype, early_exit,
                                  lambda x: check_update_msa(x, alpha))
    if backend == "mega":
        # the megakernel where the JAX package's budget takes the
        # configuration; flooding hands off to the fused route elsewhere
        if takes_megakernel(tb, msg_dtype, schedule):
            return _make_mega_decoder(tb, max_iter, alg, msg_dtype, early_exit, schedule)
        if schedule == "layered":
            raise MegaBudgetError("schedule='layered' requires a megakernel-eligible config")
        return _make_fused_decoder(tb, max_iter, alg, msg_dtype, early_exit)
    xla = _make_roll_decoder(tb, max_iter, msg_dtype, early_exit, _plain_check_update(alg))
    if backend == "xla" or not kernel_alg:
        return xla
    on_cuda = _make_mega_decoder(tb, max_iter, alg, msg_dtype, early_exit, schedule)

    def decode(llrs):
        if llrs.is_cuda:
            return on_cuda(llrs)
        if schedule == "layered":
            raise ValueError(_LAYERED_NEEDS_MEGA)
        return xla(llrs)

    return decode


_LAYERED_NEEDS_MEGA = ("schedule='layered' needs the megakernel (MSA/NMSA on CUDA tensors, "
                       "or backend='mega' explicitly for its plain version on the CPU)")


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
    llr_info, llr_p = _split_llrs(tb, llrs)
    llr_info = llr_info.contiguous()
    return llr_info, llr_p, _fused_carry(llr_info, llr_p, tb["S"], msg_dtype)


def _fused_carry(llr_info, llr_p, S, msg_dtype):
    B, dev = llr_info.shape[-1], llr_info.device
    mdt = _msg_dtype(msg_dtype)
    return dict(M=torch.zeros((S + 2, llr_p.shape[0], Z, B), dtype=mdt, device=dev),
                Tc=llr_info.to(mdt), Tpc=llr_p.to(mdt),
                done=torch.zeros(B, dtype=torch.bool, device=dev), fT=llr_info, fTp=llr_p,
                n_iters=torch.zeros(B, dtype=torch.int32, device=dev))


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


def _kernel_alpha(alg):
    """The normalisation of the kernel routes' ``alg`` (None for MSA);
    raises ``ValueError`` for SPA."""
    if alg not in ("MSA", "NMSA"):
        raise ValueError("fused QC decoder supports MSA/NMSA only")
    return 0.75 if alg == "NMSA" else None


def _layout(layouts, tb, dev):
    """The :class:`~opticommpy_torch.kernels.qc.QCLayout` of ``tb`` on
    ``dev``, cached in ``layouts``."""
    from opticommpy_torch.kernels import qc as qck

    lay = layouts.get(dev)
    if lay is None:
        lay = layouts[dev] = qck.QCLayout(tb, dev)
    return lay


def _make_mega_decoder(tb, max_iter, alg, msg_dtype, early_exit, schedule):
    """The megakernel route: the whole decode (flooding or layered) in one
    K11 launch per call, each codeword's early exit on the device; on CPU
    tensors its plain version :func:`mega_decode_plain`."""
    from opticommpy_torch.kernels.qc_mega import qc_decode_mega

    alpha = _kernel_alpha(alg)
    layouts = {}

    def decode(llrs):
        lay = _layout(layouts, tb, llrs.device)
        llr_info, llr_p = _split_llrs(tb, llrs)
        fT, fTp, done, n_iters = qc_decode_mega(llr_info, llr_p, lay, max_iter + 1, alpha,
                                                msg_dtype, early_exit, schedule)
        return _outputs(tb, fT, fTp, n_iters, done)

    return decode


def _make_fused_decoder(tb, max_iter, alg, msg_dtype, early_exit):
    """The fused route: carry ``(M, T, Tp)``, K9 then K10 per step.

    The edge tensor X = v2c(T) - M is never stored: K9 recomputes it from
    the totals. The parity vote of iteration j's totals is seen only when
    the next K9 pass reads them, so the done/freeze bookkeeping runs one
    step delayed: step kk folds the vote of its input totals (discarded at
    kk = 0, where they are the channel LLRs), the loop runs max_iter + 1
    steps, and the last step only contributes its vote. Outputs equal the
    plain route's up to float32 summation order; K11's flooding schedule
    equals this route bit for bit.
    """
    alpha = _kernel_alpha(alg)
    K = max_iter + 1
    layouts = {}

    def decode(llrs):
        lay = _layout(layouts, tb, llrs.device)
        llr_info, llr_p, c = fused_init(tb, llrs, msg_dtype)
        for kk in range(K):
            # early exit: one device-to-host read of the batch flag per step
            if early_exit and bool(c["done"].all()):
                break
            fused_step(c, llr_info, llr_p, lay, alpha, kk, K)
        return _outputs(tb, c["fT"], c["fTp"], c["n_iters"], c["done"])

    return decode


def mega_decode_plain(llr_info, llr_p, lay, K, alpha=None, msg_dtype="f32", early_exit=False,
                      schedule="flooding"):
    """K11's plain version: the whole decode of ``K`` steps (``max_iter +
    1``) from llr_info (G, Z, B) float32 in bucket order and llr_p (q, Z,
    B), with the :class:`~opticommpy_torch.kernels.qc.QCLayout` ``lay`` of
    the code on their device. Returns (fT (G, Z, B), fTp (q, Z, B) float32
    frozen totals, done (B,) bool, n_iters (B,) int32).

    - ``'flooding'``: the fused route's steps (:func:`fused_step` on the
      plain versions of K9 and K10): the vote delayed by one step and
      discarded at step 0, the phantom last step that only votes, the
      frozen outputs starting from the channel LLRs.
    - ``'layered'``: :func:`_layered_plain`.

    With ``early_exit`` the loop stops once every codeword is done; the
    outputs are the fixed loop's, frozen per codeword.
    """
    if schedule == "layered":
        return _layered_plain(llr_info, llr_p, lay, K, alpha, msg_dtype, early_exit)
    c = _fused_carry(llr_info, llr_p, lay.S, msg_dtype)
    for kk in range(K):
        if early_exit and bool(c["done"].all()):
            break
        fused_step(c, llr_info, llr_p, lay, alpha, kk, K, plain=True)
    return c["fT"], c["fTp"], c["done"], c["n_iters"]


def _layered_plain(llr_info, llr_p, lay, K, alpha, msg_dtype, early_exit):
    """Serial-C sweeps over the q check columns (the JAX megakernel's
    layered branch, ``qc_mega.py:58-65,83-90,195-229,248-264``). Per column:
    x = rolled float32 totals - old message, rounded to the message type;
    min/sign over the S + 2 slots; the new messages, rounded to the message
    type; the deltas new - old added to the totals in place, slot by slot
    (two slots of one column may reach one group). The staircase slot is
    masked at check 0, and column 0's staircase delta reaches plane q - 1
    rolled by -1. The vote of each sweep sees mid-sweep totals; the sweep
    where ``done`` first latches freezes its end-of-sweep totals: ``frozen
    = done_before | (last & ~ok)``."""
    S, q = lay.S, lay.q
    D = S + 2
    mdt = _msg_dtype(msg_dtype)
    B, dev = llr_info.shape[-1], llr_info.device
    T, Tp = llr_info.clone(), llr_p.clone()
    M = torch.zeros((q, D, Z, B), dtype=mdt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iters = torch.zeros(B, dtype=torch.int32, device=dev)
    fT, fTp = T.clone(), Tp.clone()
    pos, sh = lay.pos_np, lay.sh_np
    for k in range(K):
        if early_exit and bool(done.all()):
            break
        vote = torch.ones(B, dtype=torch.bool, device=dev)
        for j in range(q):
            jm1 = q - 1 if j == 0 else j - 1
            tot = torch.stack([_roll(T[pos[sl, j]], sh[sl, j]) for sl in range(S)]
                              + [Tp[j], _roll(Tp[jm1], 1 if j == 0 else 0)])
            old = M[j].float()
            x = (tot - old).to(mdt).float()
            tneg = tot < 0
            if j == 0:  # check 0 has no p_{-1}
                x[S + 1, 0] = float("inf")
                tneg[S + 1, 0] = False
            mag = x.abs()
            m1 = torch.full_like(mag[0], float("inf"))
            m2 = torch.full_like(mag[0], float("inf"))
            for sl in range(D):
                m2 = torch.minimum(m2, torch.maximum(m1, mag[sl]))
                m1 = torch.minimum(m1, mag[sl])
            neg = x < 0
            parx = torch.sum(neg, dim=0, dtype=torch.int32) & 1
            partot = torch.sum(tneg, dim=0, dtype=torch.int32) & 1
            vote &= torch.all(partot == 0, dim=0)
            om = torch.where(mag == m1, m2, m1)
            if alpha is not None:
                om = om * alpha
            new = torch.where((parx ^ neg.to(torch.int32)) == 1, -om, om).to(mdt)
            delta = new.float() - old  # before M[j] changes: at float32 old is M[j]
            M[j] = new
            for sl in range(S):
                T[int(pos[sl, j])] += _roll(delta[sl], -int(sh[sl, j]))
            Tp[j] += delta[S]
            d = delta[S + 1]
            if j == 0:
                d[0] = 0.0
                d = torch.roll(d, -1, dims=0)
            Tp[jm1] += d
        ok = vote & (k > 0)
        done_before = done
        done = done | ok
        last = k == K - 1
        n_iters = n_iters + (~done & (not last)).to(torch.int32)
        frozen = done_before | (last & ~ok) if k > 0 else torch.zeros_like(done)
        fT = torch.where(frozen, fT, T)
        fTp = torch.where(frozen, fTp, Tp)
    return fT, fTp, done, n_iters
