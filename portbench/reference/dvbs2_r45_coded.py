"""Plain reference of the DVB-S2 64800-bit rate-4/5 LDPC code.

Plain PyTorch on any device; it imports nothing of the program under test.
The parity-check matrix is built from the standard's accumulator address
table (``dvbs2_64800_45.json`` beside this file, a frozen copy): the
information bit ``360 g + t`` of table row ``g`` enters check
``(x + t q) mod m`` for each address ``x`` of the row, ``q = m / 360``;
parity bit ``j`` enters checks ``j`` and ``j + 1`` (the staircase).

The encoder accumulates: ``p_j = p_{j-1} xor (A u)_j``.

The decoder is flooding normalized min-sum as OptiCommPy's ``decodeLDPC``
defines it, in the serving configuration the cell states (20 iterations,
check messages scaled by 0.75, messages stored in ``msg`` precision,
totals accumulated in float32, channel LLRs clipped at 200): per
iteration every check sends ``0.75 x`` the least magnitude of its other
incoming messages with the product of their signs; every variable's total
is its LLR plus all incoming check messages; each edge's next message is
the total less that edge's check message. A codeword is done once the
signs of its totals satisfy every check; its output totals are those of
that iteration. The loop stops once every codeword is done.
"""

import json
import os

import numpy as np
import torch

_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dvbs2_64800_45.json")


def code():
    """Edges and the check-major / variable-major addressing of the code."""
    d = json.load(open(_TABLE))
    n, k = d["n"], d["k"]
    m = n - k
    q = m // 360
    rows, cols = [], []
    t = np.arange(360)
    for g, row in enumerate(d["table"]):
        for x in row:
            rows.append((x + t * q) % m)
            cols.append(360 * g + t)
    j = np.arange(m)
    rows += [j, j[1:]]
    cols += [k + j, k + j[:-1]]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    deg_c = np.bincount(rows, minlength=m)
    dc = int(deg_c.max())
    slot = np.arange(rows.size) - np.repeat(np.cumsum(deg_c) - deg_c, deg_c)
    # check-major table (m, dc) of variables; padding points at variable n
    cv = np.full((m, dc), n, np.int64)
    cv[rows, slot] = cols
    # variable-major table (n, dv) of edge positions in the (m * dc) layout;
    # padding points at position m * dc (a zero message)
    pos = rows * dc + slot
    ov = np.argsort(cols, kind="stable")
    deg_v = np.bincount(cols, minlength=n)
    dv = int(deg_v.max())
    vslot = np.arange(cols.size) - np.repeat(np.cumsum(deg_v) - deg_v, deg_v)
    vc = np.full((n, dv), m * dc, np.int64)
    vc[cols[ov], vslot] = pos[ov]
    return dict(n=n, k=k, m=m, dc=dc, dv=dv, cv=cv, vc=vc, rows=rows, cols=cols)


def encode(info, c):
    """(k, B) 0/1 information bits -> (n, B) int8 codewords."""
    k, m = c["k"], c["m"]
    dev = info.device
    sel = c["cols"] < k
    r = torch.as_tensor(c["rows"][sel], device=dev)
    v = torch.as_tensor(c["cols"][sel], device=dev)
    acc = torch.zeros((m, info.shape[1]), dtype=torch.int64, device=dev)
    acc.index_add_(0, r, info[v].to(torch.int64))
    parity = torch.cumsum(acc % 2, dim=0) % 2
    return torch.cat([info.to(torch.int8), parity.to(torch.int8)])


def storage(msg):
    """The rounding of a stored message: 'bf16' as the cell states; 'fp8'
    (e4m3, saturating), the control's next precision below."""
    if msg == "bf16":
        return lambda x: x.to(torch.bfloat16).float()
    if msg == "fp8":
        return lambda x: torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn).float()
    if msg == "f32":
        return lambda x: x
    raise ValueError(msg)


def decode(llr, c, max_iter=20, alpha=0.75, msg="bf16", clip=200.0):
    """Flooding normalized min-sum on (n, B) float32 LLRs.

    Returns (output totals (n, B) float32, iterations (B,), done (B,) bool).
    """
    q = storage(msg)
    n, m, dc = c["n"], c["m"], c["dc"]
    dev = llr.device
    b = llr.shape[1]
    llr = torch.clamp(llr.float(), -clip, clip)
    cv = torch.as_tensor(c["cv"], device=dev)
    vc = torch.as_tensor(c["vc"], device=dev)
    pad = (cv == n)[:, :, None]  # (m, dc, 1)
    llr_x = torch.cat([llr, torch.zeros((1, b), device=dev)])
    x = q(llr_x[cv])  # (m, dc, B) variable-to-check messages
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    out = llr.clone()
    iters = torch.zeros(b, dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        mag = torch.where(pad, torch.full_like(x, float("inf")), torch.abs(x))
        min1, arg1 = torch.min(mag, dim=1, keepdim=True)
        mag2 = mag.scatter(1, arg1, float("inf"))
        min2 = torch.min(mag2, dim=1, keepdim=True).values
        slot = torch.arange(dc, device=dev)[None, :, None]
        ex = torch.where(slot == arg1, min2, min1)
        neg = (x < 0) & ~pad
        par = torch.sum(neg, dim=1, keepdim=True, dtype=torch.int32) & 1
        flip = torch.where(neg, 1 - par, par)
        cm = q(alpha * torch.where(flip == 1, -ex, ex))  # check-to-variable
        cm = torch.where(pad, torch.zeros_like(cm), cm)
        flat = torch.cat([cm.reshape(m * dc, b), torch.zeros((1, b), device=dev)])
        tot = llr + flat[vc].sum(dim=1)  # (n, B) float32
        tot_e = q(torch.cat([tot, torch.zeros((1, b), device=dev)])[cv])
        x = q(tot_e - cm)
        odd = torch.sum((tot_e < 0) & ~pad, dim=1, dtype=torch.int32) & 1
        ok = ~torch.any(odd.bool(), dim=0)
        out = torch.where(done, out, tot)
        iters = torch.where(done, iters, iters + 1)
        done = done | ok
    return out, iters, done
