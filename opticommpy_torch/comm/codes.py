"""Standard LDPC code constructors (port of ``opticommpy_tpu/comm/codes.py``).

NumPy only: each code is constructed from its standard's compact defining
tables (:mod:`._code_tables`, the port's own copy), never from ALIST files.

- **DVB-S2** (ETSI EN 302 307-1 Annex B/C): info bit ``i = 360 g + t``
  connects to checks ``(x + t q) mod M`` for each accumulator address ``x``
  in table row ``g`` (``q = M/360``); the parity part is the staircase
  (column ``k+j`` hits checks ``j`` and ``j+1``).
- **IEEE 802.11n** (IEEE 802.11-2012 Annex F): block-circulant lift of a
  ``(mb, 24)`` shift base matrix with ``Z = n/24``.
- **AR4JA** (CCSDS 131.0-B-2 §7.4): base matrix of M x M blocks, each a GF(2)
  sum of quarter-block permutations
  ``pi(i) = (M/4) tq[j] + (off[j] + i) mod (M/4)``, ``j = i // (M/4)``.
  The stored H includes the M punctured columns at the end.

Constructors return the sparse support ``(n_cols, m, rows, cols)`` that
:func:`opticommpy_torch.comm.fec.ldpc_graph_from_edges` takes, with the same
names, arguments and results as the JAX package's.
"""

from fractions import Fraction

import numpy as np

from . import _code_tables

__all__ = [
    "available_ldpc_codes",
    "ldpc_edges",
    "ldpc_parity_matrix",
    "dvbs2_edges",
    "ieee80211_edges",
    "ar4ja_edges",
]


def _rate_tag(R):
    """'4/5' -> '45' (the reference OptiCommPy's file-name rate tag)."""
    if isinstance(R, str):
        num, den = R.split("/")
        return f"{num}{den}"
    fr = Fraction(R).limit_denominator(10)
    return f"{fr.numerator}{fr.denominator}"


def available_ldpc_codes():
    """The built-in standard codes as ``(mode, n, R)`` tuples."""

    def _untag(tag):
        # '910' is 9/10; every other tag is one digit / one digit
        return "9/10" if tag == "910" else f"{tag[0]}/{tag[1]}"

    out = []
    for key in _code_tables.DVBS2:
        nbits, tag = key.split("_")
        out.append(("DVBS2", int(nbits), _untag(tag)))
    for key in _code_tables.IEEE80211:
        nbits, tag = key.split("_")
        out.append(("IEEE_802.11nD2", int(nbits), _untag(tag)))
    for key in _code_tables.AR4JA:
        nbits, tag = key.split("_")
        out.append(("AR4JA", int(nbits), _untag(tag)))
    return out


def dvbs2_edges(R="4/5", n=64800):
    """DVB-S2 long-frame parity-check support for rate ``R``:
    ``(n, m, rows, cols)`` with int32 edge arrays."""
    key = f"{n}_{_rate_tag(R)}"
    try:
        data = _code_tables.DVBS2[key]
    except KeyError:
        raise ValueError(
            f"no DVB-S2 table for n={n}, R={R}; available: "
            f"{sorted(_code_tables.DVBS2)}") from None
    k = data["k"]
    m = n - k
    q = m // 360
    flat = [(g, x) for g, row in enumerate(data["table"]) for x in row]
    g_arr = np.array([g for g, _ in flat], dtype=np.int64)
    x_arr = np.array([x for _, x in flat], dtype=np.int64)
    t = np.arange(360, dtype=np.int64)
    info_rows = (x_arr[:, None] + t[None, :] * q) % m
    info_cols = 360 * g_arr[:, None] + t[None, :]
    # staircase: col k+j -> checks {j, j+1 (if j < m-1)}
    j = np.arange(m, dtype=np.int64)
    par_rows = np.concatenate([j, j[:-1] + 1])
    par_cols = np.concatenate([k + j, k + j[:-1]])
    rows = np.concatenate([info_rows.ravel(), par_rows]).astype(np.int32)
    cols = np.concatenate([info_cols.ravel(), par_cols]).astype(np.int32)
    return n, m, rows, cols


def ieee80211_edges(n=648, R="1/2"):
    """IEEE 802.11n parity-check support (Annex F block-circulant lift)."""
    key = f"{n}_{_rate_tag(R)}"
    try:
        data = _code_tables.IEEE80211[key]
    except KeyError:
        raise ValueError(
            f"no 802.11n table for n={n}, R={R}; available: "
            f"{sorted(_code_tables.IEEE80211)}") from None
    shifts = np.asarray(data["shifts"], dtype=np.int64)
    Z = n // 24
    rb, cb = np.nonzero(shifts >= 0)
    sh = shifts[rb, cb]
    i = np.arange(Z, dtype=np.int64)
    rows = (rb[:, None] * Z + i[None, :]).ravel().astype(np.int32)
    cols = (cb[:, None] * Z + (i[None, :] + sh[:, None]) % Z).ravel()
    m = shifts.shape[0] * Z
    return n, m, rows.astype(np.int32), cols.astype(np.int32)


def ar4ja_edges(n=2048, R="1/2"):
    """AR4JA (CCSDS 131.0-B-2) parity-check support.

    ``n`` is the transmitted block length; the returned support has
    ``n_cols = n + M`` columns, the last M being the punctured block.
    """
    key = f"{n}_{_rate_tag(R)}"
    try:
        data = _code_tables.AR4JA[key]
    except KeyError:
        raise ValueError(
            f"no AR4JA table for n={n}, R={R}; available: "
            f"{sorted(_code_tables.AR4JA)}") from None
    M, nb, m = data["M"], data["nb"], data["m"]
    Q = M // 4
    i = np.arange(M, dtype=np.int64)
    j = i // Q
    rows_l, cols_l = [], []
    for key2, perms in data["blocks"].items():
        rb, cb = (int(v) for v in key2.split(","))
        for p in perms:
            tq = np.asarray([p[jj][0] for jj in range(4)], dtype=np.int64)
            off = np.asarray([p[jj][1] for jj in range(4)], dtype=np.int64)
            rows_l.append(rb * M + i)
            cols_l.append(cb * M + tq[j] * Q + (off[j] + i) % Q)
    rows = np.concatenate(rows_l).astype(np.int32)
    cols = np.concatenate(cols_l).astype(np.int32)
    # GF(2): duplicate edges cancel
    eid = rows.astype(np.int64) * (nb * M) + cols
    uniq, counts = np.unique(eid, return_counts=True)
    keep = uniq[counts % 2 == 1]
    rows = (keep // (nb * M)).astype(np.int32)
    cols = (keep % (nb * M)).astype(np.int32)
    return nb * M, m, rows, cols


_FAMILIES = {
    "DVBS2": dvbs2_edges,
    "IEEE_802.11nD2": lambda R, n: ieee80211_edges(n=n, R=R),
    "AR4JA": lambda R, n: ar4ja_edges(n=n, R=R),
}


def ldpc_edges(mode="DVBS2", n=64800, R="4/5"):
    """Sparse parity-check support for a standard code (``mode``, ``n``
    transmitted bits, ``R`` as '4/5')."""
    if mode == "DVBS2":
        return dvbs2_edges(R=R, n=n)
    try:
        fn = _FAMILIES[mode]
    except KeyError:
        raise ValueError(f"unknown code family {mode!r}; "
                         f"expected one of {sorted(_FAMILIES)}") from None
    return fn(R, n)


def ldpc_parity_matrix(mode="DVBS2", n=64800, R="4/5"):
    """Dense uint8 (m, n_cols) parity-check matrix for a standard code."""
    n_cols, m, rows, cols = ldpc_edges(mode=mode, n=n, R=R)
    H = np.zeros((m, n_cols), dtype=np.uint8)
    H[rows, cols] = 1
    return H
