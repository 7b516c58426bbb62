"""LDPC forward error correction (port of ``opticommpy_tpu/comm/fec.py``).

- GF(2) preprocessing (Gaussian elimination, triangularization, inversion,
  H -> G) and the decoding graphs are host-side NumPy, run once per code.
  A graph is a dict of NumPy arrays with the JAX package's keys, so a graph
  built by either package decodes in both.
- Encoding runs on the bits' device: GF(2) matrix-vector products as
  padded-gather sums mod 2 over the sparse rows, and the DVB-S2 parity
  recursion as an integer prefix sum mod 2 (exact on CUDA).
- Decoding (sum-product / min-sum belief propagation) batches the B
  codeword columns natively where the JAX package uses ``vmap``: every
  message array carries a trailing B axis, and each column keeps its own
  convergence flag, iteration count and frozen totals. DVB-S2 graphs go to
  the quasi-cyclic decoder of :mod:`.fec_qc` (the Hopper kernels on CUDA);
  802.11n / AR4JA graphs to the lifted-circulant decoder of :mod:`.fec_lift`;
  other graphs to the degree-bucketed decoder, or to the uniformly padded
  one when the graph has no buckets.
- Hamming codes, ALIST I/O and the Gallager ensemble are host-side NumPy
  helpers around the same encoder and decoder.

Not ported yet (``ROADMAP.md`` queue 1, item 3): ``plot_binary_matrix``.
"""

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from opticommpy_torch.utils.profiling import count
from opticommpy_torch.utils.rng import default_device

__all__ = [
    "LDPCConfig",
    "gauss_elim_gf2",
    "inverse_matrix_gf2",
    "triangularize_gf2",
    "par2gen",
    "triang_p1p2",
    "ldpc_graph",
    "ldpc_graph_from_edges",
    "standard_ldpc",
    "encode_ldpc",
    "decode_ldpc",
    "read_alist",
    "read_alist_edges",
    "write_alist",
    "parse_alist",
    "summarize_alist_folder",
    "plot_binary_matrix",
    "hamming_parity_check_matrix",
    "encode_hamming",
    "decode_hamming",
    "gallager_ldpc",
]


# ---------------------------------------------------------------------------
# GF(2) linear algebra (host-side, offline preprocessing)
# ---------------------------------------------------------------------------


def gauss_elim_gf2(M):
    """Reduced row echelon form over GF(2), vectorized NumPy (the JAX
    package's pivot policy; it takes a native path for large matrices with
    bit-identical output)."""
    M = np.array(M, dtype=np.uint8) % 2
    rows, cols = M.shape
    lead = 0
    for r in range(rows):
        if lead >= cols:
            break
        pivot_rows = np.nonzero(M[r:, lead])[0]
        while pivot_rows.size == 0:
            lead += 1
            if lead == cols:
                return M
            pivot_rows = np.nonzero(M[r:, lead])[0]
        i = r + pivot_rows[0]
        if i != r:
            M[[r, i]] = M[[i, r]]
        # eliminate the lead column everywhere else (XOR rows at once)
        mask = M[:, lead].copy()
        mask[r] = 0
        M[mask == 1] ^= M[r]
        lead += 1
    return M


def inverse_matrix_gf2(A):
    """Inverse of a square binary matrix over GF(2): (Ainv, success)."""
    A = np.array(A, dtype=np.uint8) % 2
    n = A.shape[0]
    aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
    for i in range(n):
        pivots = np.nonzero(aug[i:, i])[0]
        if pivots.size == 0:
            return np.eye(n, dtype=np.uint8), False
        j = i + pivots[0]
        if j != i:
            aug[[i, j]] = aug[[j, i]]
        mask = aug[:, i].copy()
        mask[i] = 0
        aug[mask == 1] ^= aug[i]
    return aug[:, n:], True


def triangularize_gf2(H):
    """Lower-triangularize H with row/column permutations:
    (triangH, rowPerm, colPerm)."""
    H = np.array(H, dtype=np.uint8) % 2
    m, n = H.shape
    row_perm = np.arange(m)
    col_perm = np.arange(n)
    T = H.copy()
    for i in range(m):
        sub = T[i:, i:]
        nz = np.argwhere(sub == 1)
        if nz.size == 0:
            continue
        r, c = nz[0]
        r += i
        c += i
        if r != i:
            T[[i, r]] = T[[r, i]]
            row_perm[[i, r]] = row_perm[[r, i]]
        if c != i:
            T[:, [i, c]] = T[:, [c, i]]
            col_perm[[i, c]] = col_perm[[c, i]]
        below = np.nonzero(T[i + 1:, i])[0] + i + 1
        T[below] ^= T[i]
    return T, row_perm, col_perm


def par2gen(H):
    """Systematic generator matrix G = [I_k | P] from H: (G, colSwaps, Hm),
    with Hm the column-permuted original H (so G @ Hm^T = 0 over GF(2)).
    Pivot columns come from the reduced row echelon form, so a
    rank-deficient H gives k = n - rank."""
    H = _dense(H)
    n = H.shape[1]
    E = gauss_elim_gf2(H)
    E = E[np.nonzero(E.any(axis=1))[0]]
    r = E.shape[0]  # rank
    k = n - r
    pivot_cols = np.array([np.nonzero(E[i])[0][0] for i in range(r)])
    nonpivot_cols = np.setdiff1d(np.arange(n), pivot_cols)
    Em = np.concatenate([E[:, nonpivot_cols], E[:, pivot_cols]], axis=1)
    col_swaps = np.concatenate([nonpivot_cols, pivot_cols])
    G = np.concatenate([np.eye(k, dtype=np.uint8), Em[:, :k].T], axis=1)
    # the sparse original H, column-permuted: BP needs the low-degree graph
    return G, col_swaps, H[:, col_swaps]


def triang_p1p2(H):
    """Richardson-Urbanke triangular encoder matrices: (P1, P2, Hm) with
    parities p1 = P1@u, p2 = P2@u over GF(2), or (None, None, None) if the
    required submatrices are singular."""
    H = _dense(H)
    T, _, col_swaps = triangularize_gf2(H)
    m, n = T.shape
    k = n - m
    idx = np.where(T[:, -1] == 1)[0]
    g = m - idx.min() - 1
    E = T[m - g:, n - (m - g):]
    Tm = T[:m - g, n - (m - g):]
    A = T[:m - g, :k]
    B = T[:m - g, k:k + g]
    C = T[m - g:, :k]
    D = T[m - g:, k:k + g]
    T_inv, ok = inverse_matrix_gf2(Tm)
    if not ok:
        return None, None, None
    X = (E @ T_inv) % 2
    C_t = (X @ A + C) % 2
    D_t = (X @ B + D) % 2
    D_t_inv, ok = inverse_matrix_gf2(D_t)
    if not ok:
        return None, None, None
    P1 = (D_t_inv @ C_t) % 2
    P2 = (T_inv @ ((A + (B @ P1) % 2) % 2)) % 2
    return P1.astype(np.uint8), P2.astype(np.uint8), H[:, col_swaps]


def _dense(H):
    if hasattr(H, "todense"):
        return np.asarray(H.todense(), dtype=np.uint8)
    return np.asarray(H, dtype=np.uint8)


# ---------------------------------------------------------------------------
# ALIST I/O and code constructions (host-side NumPy)
# ---------------------------------------------------------------------------


def read_alist_edges(filename):
    """Read an ALIST file into its sparse support: ``(n, m, rows, cols)``,
    the int32 nonzero coordinates of the (m, n) parity-check matrix (the
    JAX package's Python parse; its native loader returns the same)."""
    with open(filename) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n, m = map(int, lines[0].split())
    rows, cols = [], []
    for j, line in enumerate(lines[4:4 + n]):
        for entry in map(int, line.split()):
            if entry > 0:
                rows.append(entry - 1)
                cols.append(j)
    return n, m, np.asarray(rows, np.int32), np.asarray(cols, np.int32)


def read_alist(filename):
    """Read an ALIST file into a dense (m, n) uint8 parity-check matrix."""
    n, m, rows, cols = read_alist_edges(filename)
    H = np.zeros((m, n), dtype=np.uint8)
    H[rows, cols] = 1
    return H


def write_alist(H, filename):
    """Save a binary parity-check matrix to ALIST format."""
    H = _dense(H)
    m, n = H.shape
    var_deg = H.sum(axis=0)
    chk_deg = H.sum(axis=1)
    max_col = int(var_deg.max())
    max_row = int(chk_deg.max())
    with open(filename, "w") as f:
        f.write(f"{n} {m}\n{max_col} {max_row}\n")
        f.write(" ".join(map(str, var_deg)) + "\n")
        f.write(" ".join(map(str, chk_deg)) + "\n")
        for j in range(n):
            conn = list(np.nonzero(H[:, j])[0] + 1) + [0] * (max_col - var_deg[j])
            f.write(" ".join(map(str, conn)) + "\n")
        for i in range(m):
            conn = list(np.nonzero(H[i])[0] + 1) + [0] * (max_row - chk_deg[i])
            f.write(" ".join(map(str, conn)) + "\n")


def parse_alist(path):
    """Basic parameters of an ALIST file: n, m, rate, largest column and
    row weights."""
    n, m, rows, cols = read_alist_edges(path)
    col_w = np.bincount(cols, minlength=n)
    row_w = np.bincount(rows, minlength=m)
    return {
        "n": n,
        "m": m,
        "rate": (n - m) / n if n else 0,
        "max_col_w": int(col_w.max()) if col_w.size else 0,
        "max_row_w": int(row_w.max()) if row_w.size else 0,
    }


def summarize_alist_folder(folder_path):
    """Summarize every ``.alist`` / ``.txt`` file of a folder as a text
    table (:func:`parse_alist` on each; a file that fails to parse is
    reported and skipped); prints and returns the table."""
    import os

    header = ("File", "n (length)", "m (checks)", "Rate", "Max Var Deg", "Max Check Deg")
    rows = []
    for filename in sorted(os.listdir(folder_path)):
        if not (filename.endswith(".alist") or filename.endswith(".txt")):
            continue
        try:
            info = parse_alist(os.path.join(folder_path, filename))
        except Exception as exc:  # noqa: BLE001 - the JAX package's tolerance
            print(f"Failed to parse {filename}: {exc}")
            continue
        rows.append((filename, str(info["n"]), str(info["m"]), f"{info['rate']:.3f}",
                     str(info["max_col_w"]), str(info["max_row_w"])))
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(header)]
    fmt = " | ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), "-+-".join("-" * w for w in widths)]
    lines += [fmt.format(*r) for r in rows]
    table = "\n".join(lines)
    print(table)
    return table


def plot_binary_matrix(H, ax=None):
    """Scatter-plot the support of a binary matrix (reference fec.py:1075).
    ``H`` may be a tensor (pulled to the host once), an array or a sparse
    matrix; matplotlib is imported only here."""
    import matplotlib.pyplot as plt

    if isinstance(H, torch.Tensor):
        H = H.detach().cpu().numpy()
    H = _dense(H)
    rows, cols = np.where(H == 1)
    if ax is None:
        ax = plt.gca()
    ax.scatter(cols, rows, s=10 / max(H.shape[0], 1), color="blue")
    ax.set_xlabel("Column indexes")
    ax.set_ylabel("Row indexes")
    ax.set_title(f"Matrix: {H.shape[0]} x {H.shape[1]}")
    ax.set_xlim(0, H.shape[1])
    ax.set_ylim(H.shape[0], 0)
    ax.grid(True)
    return ax


def hamming_parity_check_matrix(m, extended=False):
    """Hamming (or extended Hamming) parity-check matrix: column j of the
    standard code is the binary representation of j + 1, LSB at the top."""
    if m < 1:
        raise ValueError("m must be a positive integer.")
    n_std = 2**m - 1
    cols = np.arange(1, n_std + 1)
    H_std = ((cols[None, :] >> np.arange(m)[:, None]) & 1).astype(np.uint8)
    if not extended:
        return H_std
    H_ext = np.zeros((m + 1, n_std + 1), dtype=np.uint8)
    H_ext[:m, :n_std] = H_std
    H_ext[m, :] = 1
    return H_ext


def gallager_ldpc(n, dv, dc, seed=0):
    """Random regular (dv, dc) LDPC parity-check matrix (Gallager ensemble,
    NumPy generator from ``seed``: the JAX package's matrix)."""
    if (n * dv) % dc != 0:
        raise ValueError("n*dv must be divisible by dc")
    m = n * dv // dc
    rng = np.random.default_rng(seed)
    rows_per_block = m // dv
    if rows_per_block * dc != n:
        raise ValueError("inconsistent (n, dv, dc)")
    H = np.zeros((m, n), dtype=np.uint8)
    for b in range(dv):
        perm = rng.permutation(n)
        for r in range(rows_per_block):
            H[b * rows_per_block + r, perm[r * dc:(r + 1) * dc]] = 1
    return H


def _on_device(x, dtype):
    """A tensor keeps its device; anything else goes to the default device
    (CUDA, or raise: see :func:`opticommpy_torch.utils.rng.default_device`)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x)).to(default_device(), dtype)


# ---------------------------------------------------------------------------
# Encoding (on the bits' device, batched over codewords)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LDPCConfig:
    """LDPC code configuration (the JAX package's fields and defaults).

    ``mode`` selects the encoder: 'DVBS2' (sparse A + prefix-XOR recursion),
    'triang' (Richardson-Urbanke P1/P2), or 'G' (systematic generator).
    ``alg``: 'SPA' | 'MSA' | 'NMSA' (min-sum with check messages scaled by
    0.75). ``msgDtype``: message storage, 'f32' or 'bf16' (totals always
    accumulate in float32). ``earlyExit``: stop once every codeword of the
    batch converged (QC and lift decoders; identical outputs). ``schedule``:
    'flooding', or 'layered' (DVB-S2 on the whole-decode kernel K11 only).
    """

    mode: str = "DVBS2"
    maxIter: int = 25
    alg: str = "SPA"
    clipLLR: float = 200.0
    msgDtype: str = "f32"
    earlyExit: bool = False
    schedule: str = "flooding"


def _padded_rows(rows, cols, m, dmax=None, fill=0):
    """(m, dmax) padded row arrays from sorted-by-row edge coordinates."""
    counts = np.bincount(rows, minlength=m)
    if dmax is None:
        dmax = max(int(counts.max()) if counts.size else 1, 1)
    # position of each edge within its row (edges already row-major sorted)
    pos = np.arange(rows.size) - np.repeat(np.cumsum(counts) - counts, counts)
    idx = np.full((m, dmax), fill, dtype=np.int32)
    mask = np.zeros((m, dmax), dtype=bool)
    idx[rows, pos] = cols
    mask[rows, pos] = True
    return idx, mask


def _sparse_rows(M, pad_to=None):
    """Row-sparse representation: (indices (m, dmax), mask (m, dmax))."""
    M = _dense(M)
    rows, cols = np.nonzero(M)  # C-order scan: already row-major sorted
    return _padded_rows(rows, cols, M.shape[0], dmax=pad_to)


def _gf2_matvec_sparse(idx, mask, bits):
    """Sum mod 2 of bits gathered along sparse rows: (m, dmax) x (n, N) ->
    (m, N), on the bits' device."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=bits.device)
    mask = torch.as_tensor(mask, device=bits.device)
    gathered = torch.where(mask[..., None], bits[idx], 0)  # (m, dmax, N)
    return torch.sum(gathered, dim=1, dtype=torch.int32) % 2


def _dvbs2_encoder_support(n, m, rows, cols):
    """Row-sparse (idx, mask) of the info part A = H[:, :k] from edges."""
    k = n - m
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    sel = cols < k
    r, c = rows[sel], cols[sel]
    order = np.lexsort((c, r))
    return _padded_rows(r[order], c[order], m)


def encode_ldpc(bits, H=None, config: LDPCConfig = LDPCConfig(), G=None,
                P1=None, P2=None, edges=None):
    """Encode (k, N) bit columns into (n, N) int8 codewords on the bits'
    device (a NumPy array goes to the default device).

    - mode 'DVBS2': parity = prefix-XOR of A@u with A = H[:, :k], as an
      integer ``cumsum`` mod 2. Pass ``edges=(n, m, rows, cols)`` (from
      :func:`standard_ldpc`) to skip the dense H.
    - mode 'triang': codeword = [u, P1@u, P2@u].
    - mode 'G': codeword = G^T u (systematic).
    """
    bits = _on_device(bits, torch.int32)
    if config.mode == "DVBS2":
        if edges is not None:
            idx, mask = _dvbs2_encoder_support(*edges)
        else:
            H = _dense(H)
            k = H.shape[1] - H.shape[0]
            idx, mask = _sparse_rows(H[:, :k])
        parity = torch.cumsum(_gf2_matvec_sparse(idx, mask, bits), dim=0) % 2
        parts = [bits, parity]
    elif config.mode == "triang":
        if P1 is None or P2 is None:
            P1, P2, _ = triang_p1p2(H)
            if P1 is None:
                raise ValueError("H cannot be triangularized; use mode='G'.")
        parts = [bits, _gf2_matvec_sparse(*_sparse_rows(P1), bits),
                 _gf2_matvec_sparse(*_sparse_rows(P2), bits)]
    elif config.mode == "G":
        if G is None:
            G, _, _ = par2gen(H)
        G = _dense(G)
        k = G.shape[0]
        parts = [bits, _gf2_matvec_sparse(*_sparse_rows(G[:, k:].T), bits)]
    else:
        raise ValueError(f"Unsupported mode: {config.mode}")
    return torch.cat([p.to(torch.int8) for p in parts], dim=0)


def encode_hamming(bits, m=3, extended=False):
    """Hamming encoding of (k, N) bit columns: (codewords (n, N) int8, Hm),
    with Hm the column-permuted H of the systematic generator."""
    H = hamming_parity_check_matrix(m, extended)
    G, _, Hm = par2gen(H)
    if bits.shape[0] != G.shape[0]:
        raise ValueError(f"Input bits have {bits.shape[0]} rows, expected {G.shape[0]}.")
    cw = encode_ldpc(bits, H=Hm, config=LDPCConfig(mode="G"), G=G)
    return cw, Hm


# ---------------------------------------------------------------------------
# Decoding graphs (host-side NumPy)
# ---------------------------------------------------------------------------


def ldpc_graph(H):
    """The padded edge-array graph of H for BP decoding: a dict of NumPy
    arrays (``cn_idx``, ``cn_mask``, ``edge_var``, ``vn_edge``, ``bk``) and
    ``n``, ``m``, ``dc_max``."""
    H = _dense(H)
    m, n = H.shape
    rows, cols = np.nonzero(H)  # C-order: row-major sorted
    return ldpc_graph_from_edges(n, m, rows, cols)


def ldpc_graph_from_edges(n, m, rows, cols):
    """:func:`ldpc_graph` from the sparse support, without a dense H."""
    order = np.lexsort((cols, rows))  # row-major edge order
    rows = np.asarray(rows, dtype=np.int64)[order]
    cols = np.asarray(cols, dtype=np.int64)[order]
    cn_idx, cn_mask = _padded_rows(rows, cols, m)
    edge_var = cn_idx.reshape(-1)
    # variable side: the flat edge ids incident to each variable, padded
    # with E (which indexes a zero appended to the flat message array)
    E = edge_var.size
    flat_e = np.flatnonzero(cn_mask.reshape(-1))
    v = edge_var[flat_e]
    vo = np.argsort(v, kind="stable")  # stable: keeps edge ids ascending
    vn_edge, _ = _padded_rows(v[vo], flat_e[vo], n, fill=E)
    return {
        "cn_idx": cn_idx,
        "cn_mask": cn_mask,
        "edge_var": edge_var,
        "vn_edge": vn_edge,
        "n": n,
        "m": m,
        "dc_max": cn_idx.shape[1],
        "bk": _bucketize(n, m, rows, cols),
    }


def standard_ldpc(mode="DVBS2", n=64800, R="4/5"):
    """Decoding graph and sparse support of a built-in standard code:
    ``(graph, edges)``. Pass ``graph=`` to :func:`decode_ldpc` and
    ``edges=`` to :func:`encode_ldpc` (DVBS2 mode). DVB-S2 graphs carry the
    ``qc`` entry (the quasi-cyclic decoder), 802.11n / AR4JA the ``lift``
    entry."""
    from opticommpy_torch.comm.codes import ldpc_edges

    edges = ldpc_edges(mode=mode, n=n, R=R)
    graph = ldpc_graph_from_edges(*edges)
    tag = R if isinstance(R, str) else str(R)
    if mode == "DVBS2":
        graph["qc"] = {"n": n, "R": tag}
    else:
        graph["lift"] = {"mode": mode, "n": n, "R": tag}
    return graph, edges


def _bucketize(n, m, rows, cols):
    """Degree-bucketed, padding-free BP graph layout.

    Flat edge order = check buckets ascending by (degree, check id), each
    check's edges ascending by variable. Returns ``cn_var`` ((m_b, d_b)
    variable ids per check bucket), ``vn_edge`` ((n_b, d_b) flat edge
    positions per variable bucket; degree-0 variables form an (n_0, 0)
    bucket), ``vn_var`` ((n_b,) variable ids) and ``var_pos`` ((n,)
    position of each variable in bucket order).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    dc = np.bincount(rows, minlength=m)
    eorder = np.lexsort((cols, rows, dc[rows]))
    c = cols[eorder]
    cn_var = []
    start = 0
    for d in np.unique(dc):
        if d == 0:
            continue  # empty checks are trivially satisfied
        n_b = int(np.count_nonzero(dc == d))
        cnt = n_b * int(d)
        cn_var.append(c[start:start + cnt].reshape(n_b, int(d)).astype(np.int32))
        start += cnt
    dv = np.bincount(c, minlength=n)
    pos = np.arange(c.size, dtype=np.int64)
    vorder = np.lexsort((pos, c, dv[c]))
    vs, ps = c[vorder], pos[vorder]
    vn_edge, vn_var = [], []
    start = 0
    for d in np.unique(dv):
        ids = np.flatnonzero(dv == d).astype(np.int32)
        if d == 0:
            vn_edge.append(np.zeros((ids.size, 0), dtype=np.int32))
            vn_var.append(ids)
            continue
        cnt = ids.size * int(d)
        vn_edge.append(ps[start:start + cnt].reshape(ids.size, int(d)).astype(np.int32))
        vn_var.append(vs[start:start + cnt:int(d)].astype(np.int32))
        start += cnt
    var_order = np.concatenate(vn_var)
    var_pos = np.empty(n, dtype=np.int32)
    var_pos[var_order] = np.arange(n, dtype=np.int32)
    return {
        "cn_var": tuple(cn_var),
        "vn_edge": tuple(vn_edge),
        "vn_var": tuple(vn_var),
        "var_pos": var_pos,
    }


# ---------------------------------------------------------------------------
# Decoding: belief propagation, batched over the trailing codeword axis
# ---------------------------------------------------------------------------

# Normalized min-sum scaling (alg='NMSA'); 0.75 is exact in bf16.
_NMSA_ALPHA = 0.75


def _select_check_update(alg):
    """Dense-bucket check update for 'SPA' | 'MSA' | 'NMSA'."""
    if alg == "SPA":
        return _check_update_spa_dense
    if alg == "NMSA":
        return lambda x: _NMSA_ALPHA * _check_update_msa_dense(x)
    return _check_update_msa_dense


def _check_update_spa_dense(x):
    """SPA check update on one exactly-dense (m_b, d_b, ...) bucket:
    leave-one-out tanh products as prefix/suffix chains along axis 1."""
    d = x.shape[1]
    t = torch.tanh(x / 2.0)
    one = torch.ones_like(t[:, :1])
    fe = [one]
    for i in range(1, d):
        fe.append(fe[-1] * t[:, i - 1:i])
    be = [one]
    for i in range(d - 1, 0, -1):
        be.append(be[-1] * t[:, i:i + 1])
    be.reverse()
    prod = torch.cat([f * b for f, b in zip(fe, be)], dim=1)
    prod = torch.clamp(prod, -0.999999, 0.999999)
    return 2.0 * torch.atanh(prod)


def _check_update_msa_dense(x):
    """Min-sum check update on one exactly-dense (m_b, d_b, ...) bucket:
    exclusive minimum by prefix/suffix min chains along axis 1, sign by
    the parity of the other negative messages."""
    d = x.shape[1]
    mag = torch.abs(x)
    inf = torch.full_like(mag[:, :1], float("inf"))
    fe = [inf]  # fe[i] = min(mag[:, :i])
    for i in range(1, d):
        fe.append(torch.minimum(fe[-1], mag[:, i - 1:i]))
    be = [inf]  # be[i] = min(mag[:, i+1:])
    for i in range(d - 1, 0, -1):
        be.append(torch.minimum(be[-1], mag[:, i:i + 1]))
    be.reverse()
    out_mag = torch.cat([torch.minimum(f, b) for f, b in zip(fe, be)], dim=1)
    neg = x < 0
    par = torch.sum(neg, dim=1, keepdim=True, dtype=torch.int32) % 2
    flip = torch.where(neg, 1 - par, par)
    return torch.where(flip == 1, -out_mag, out_mag)


def _index(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def _bp_decode_bucketed_batch(llrs, cn_var, vn_edge, vn_var, var_pos, max_iter,
                              alg, msg_dtype=torch.float32):
    """BP decode of (n, B) LLR columns on the degree-bucketed graph.

    ``msg_dtype`` is the storage type of the (E, B) edge messages; check and
    variable math run in float32. Returns (totals (n, B), n_iters (B,),
    fail (B,))."""
    dev = llrs.device
    B = llrs.shape[1]
    check_update = _select_check_update(alg)
    sizes = [a.size for a in cn_var]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    edge_var_flat = _index(np.concatenate([a.reshape(-1) for a in cn_var]), dev)
    var_pos = _index(var_pos, dev)
    # edge -> position of its variable's total in bucket order
    edge_tot_idx = var_pos[edge_var_flat]
    llr_bucket = torch.cat([llrs[_index(vv, dev)] for vv in vn_var])
    voffs = np.concatenate([[0], np.cumsum([v.size for v in vn_var])]).astype(int).tolist()
    vn_edge = [_index(ve, dev) for ve in vn_edge]

    flat_vc = llrs[edge_var_flat].to(msg_dtype)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    final_tot = llr_bucket
    n_iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        flat_cv = torch.cat([
            check_update(flat_vc[offs[i]:offs[i + 1]].reshape(*cv.shape, B).float())
            .to(msg_dtype).reshape(-1, B)
            for i, cv in enumerate(cn_var)])
        totals = torch.cat([
            llr_bucket[voffs[i]:voffs[i + 1]] + flat_cv[ve].float().sum(dim=1)
            for i, ve in enumerate(vn_edge)])
        tot_edges = totals[edge_tot_idx]  # (E, B): also feeds the parity check
        new_vc = (tot_edges - flat_cv.float()).to(msg_dtype)
        bits_e = (tot_edges < 0).to(torch.int32)
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        for i, cv in enumerate(cn_var):
            be = bits_e[offs[i]:offs[i + 1]].reshape(*cv.shape, B)
            ok = ok & torch.all(be.sum(dim=1) % 2 == 0, dim=0)
        # freeze once converged (the reference's early exit, per codeword)
        final_tot = torch.where(done, final_tot, totals)
        flat_vc = torch.where(done, flat_vc, new_vc)
        n_iters = torch.where(done, n_iters, n_iters + 1)
        done = done | ok
    return final_tot[var_pos], n_iters, ~done


def _bp_decode_batch(llrs, cn_idx, cn_mask, vn_edge, n, max_iter, alg):
    """BP decode of (n, B) LLR columns on the uniformly padded graph.
    Returns (totals (n, B), n_iters (B,), fail (B,))."""
    dev = llrs.device
    B = llrs.shape[1]
    m, dc = cn_idx.shape
    cn_idx = _index(cn_idx, dev)
    mask = torch.as_tensor(np.asarray(cn_mask), device=dev)[..., None]  # (m, dc, 1)
    vn_edge = _index(vn_edge, dev)

    def check_update_spa(msg_vc):
        t = torch.where(mask, torch.tanh(msg_vc / 2.0), 1.0)
        # leave-one-out product per row: exclusive prefix x suffix products
        ones = torch.ones((m, 1, B), dtype=t.dtype, device=dev)
        fe = torch.cat([ones, torch.cumprod(t, dim=1)[:, :-1]], dim=1)
        b = torch.flip(torch.cumprod(torch.flip(t, [1]), dim=1), [1])
        be = torch.cat([b[:, 1:], ones], dim=1)
        prod = torch.clamp(fe * be, -0.999999, 0.999999)
        return torch.where(mask, 2.0 * torch.atanh(prod), 0.0)

    def check_update_msa(msg_vc):
        mag = torch.where(mask, torch.abs(msg_vc), float("inf"))
        min1 = torch.amin(mag, dim=1, keepdim=True)
        # first occurrence of the minimum: duplicate minima resolve like
        # argmin (the first copy excluded, min2 = the surviving copy)
        at_min = mag == min1
        is_min1 = at_min & (torch.cumsum(at_min.to(torch.int32), dim=1) == 1)
        min2 = torch.amin(torch.where(is_min1, float("inf"), mag), dim=1, keepdim=True)
        out_mag = torch.where(is_min1, min2, min1)
        neg = ((msg_vc < 0) & mask).to(torch.int32)
        others = torch.sum(neg, dim=1, keepdim=True) - neg
        out_sgn = (1 - 2 * (others % 2)).to(msg_vc.dtype)
        return torch.where(mask, out_sgn * out_mag, 0.0)

    if alg == "SPA":
        check_update = check_update_spa
    elif alg == "NMSA":
        def check_update(x):
            return _NMSA_ALPHA * check_update_msa(x)
    else:
        check_update = check_update_msa

    msg_vc = torch.where(mask, llrs[cn_idx], 0.0)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    final_llr = llrs
    n_iters = torch.zeros(B, dtype=torch.int32, device=dev)
    zero_row = torch.zeros((1, B), dtype=llrs.dtype, device=dev)
    for _ in range(max_iter):
        msg_cv = check_update(msg_vc)
        # variable update: gather each variable's incident edges (vn_edge
        # pads with index E -> the appended zero row), no scatter
        flat = torch.cat([msg_cv.reshape(-1, B), zero_row])
        total = llrs + flat[vn_edge].sum(dim=1)  # (n, B)
        new_vc = torch.where(mask, total[cn_idx] - msg_cv, 0.0)
        bits = (total < 0).to(torch.int32)
        par = torch.where(mask, bits[cn_idx], 0).sum(dim=1) % 2
        ok = torch.all(par == 0, dim=0)
        final_llr = torch.where(done, final_llr, total)
        msg_vc = torch.where(done, msg_vc, new_vc)
        n_iters = torch.where(done, n_iters, n_iters + 1)
        done = done | ok
    return final_llr, n_iters, ~done


def decode_ldpc(llrs, H=None, config: LDPCConfig = LDPCConfig(), graph=None):
    """Decode (n, N) LLR columns with belief propagation on the LLRs'
    device (a NumPy array goes to the default device).

    Returns (decodedBits (n, N) int8, outputLLRs (n, N), frameErrors (N,)
    int8). Punctured inputs (fewer rows than n) are zero-padded. Routing, as
    in the JAX package:

    - DVB-S2 graphs (``graph["qc"]``) decode on
      :func:`.fec_qc.make_qc_decoder` with ``backend="auto"`` and
      ``config.schedule``: MSA/NMSA on CUDA on the whole-decode kernel K11
      (every rate, both message types; the JAX package sends float32 at
      rates 3/5 and above to its fused kernels, whose bits K11's flooding
      schedule equals); SPA and CPU tensors on the plain roll route
      (``schedule="layered"`` needs K11 and raises on the CPU);
    - 802.11n and AR4JA graphs (``graph["lift"]``) on
      :func:`.fec_lift.make_lift_decoder` with ``backend="auto"``: the
      iteration kernel K12 on CUDA for MSA/NMSA (every shipped code, both
      message types), SPA and CPU tensors on the plain roll route;
    - other graphs on the degree-bucketed decoder, or on the uniformly
      padded one when the graph has no buckets.

    Counters (:func:`opticommpy_torch.utils.profiling.count`):
    ``fec.codewords`` and ``fec.codeword_iters`` (the iterations each
    codeword ran, summed).
    """
    if graph is None:
        graph = ldpc_graph(H)
    n = graph["n"]
    llrs = torch.clamp(_on_device(llrs, torch.float32), -config.clipLLR, config.clipLLR)
    n_in = llrs.shape[0]
    if n_in < n:
        llrs = torch.nn.functional.pad(llrs, (0, 0, 0, n - n_in))

    qc = graph.get("qc")
    lift = graph.get("lift")
    if config.schedule == "layered" and qc is None:
        raise ValueError(
            "LDPCConfig.schedule='layered' is implemented for DVB-S2 "
            "quasi-cyclic graphs only (the megakernel); use 'flooding'")
    if config.earlyExit and qc is None and lift is None:
        warnings.warn(
            "LDPCConfig.earlyExit is only implemented for lifted-circulant "
            "graphs (DVB-S2 / 802.11n / AR4JA); this code decodes with "
            "fixed maxIter trips.", stacklevel=2)
    if qc is not None:
        from opticommpy_torch.comm import fec_qc

        dec = fec_qc.make_qc_decoder(
            qc["n"], qc["R"], int(config.maxIter), config.alg, config.msgDtype,
            bool(config.earlyExit), schedule=config.schedule)
        out_llr, n_iters, fail = dec(llrs)
    elif lift is not None:
        from opticommpy_torch.comm import fec_lift

        dec = fec_lift.make_lift_decoder(
            lift["mode"], lift["n"], lift["R"], int(config.maxIter), config.alg,
            config.msgDtype, bool(config.earlyExit))
        out_llr, n_iters, fail = dec(llrs)
    elif graph.get("bk") is not None:
        bk = graph["bk"]
        mdt = torch.bfloat16 if config.msgDtype == "bf16" else torch.float32
        out_llr, n_iters, fail = _bp_decode_bucketed_batch(
            llrs, bk["cn_var"], bk["vn_edge"], bk["vn_var"], bk["var_pos"],
            int(config.maxIter), config.alg, mdt)
    else:
        out_llr, n_iters, fail = _bp_decode_batch(
            llrs, graph["cn_idx"], graph["cn_mask"], graph["vn_edge"], n,
            int(config.maxIter), config.alg)
    if n_in < n:
        out_llr = out_llr[:n_in]
    decoded = (out_llr < 0).to(torch.int8)
    count("fec.codewords", decoded.shape[1])
    count("fec.codeword_iters", n_iters)
    return decoded, out_llr, fail.to(torch.int8)


def decode_hamming(llrs, m=3, extended=False, max_iter=25):
    """Soft-decision Hamming decoding: belief propagation (SPA) on the
    graph of the column-permuted H that :func:`encode_hamming` returns."""
    H = hamming_parity_check_matrix(m, extended)
    _, _, Hm = par2gen(H)
    return decode_ldpc(llrs, H=Hm, config=LDPCConfig(maxIter=max_iter))
