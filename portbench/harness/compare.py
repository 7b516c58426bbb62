"""Comparison arithmetic shared by the mixes."""

import torch


def rel_gap(a, r):
    """Per column of (N, C): the RMS of ``a - r`` over the RMS of ``r``."""
    return torch.sqrt(torch.mean(torch.abs(a - r) ** 2, dim=0)
                      / torch.mean(torch.abs(r) ** 2, dim=0))


def quarter_turn_gap(y, y_ref, block):
    """Per column of (N, C) symbol streams: the relative RMS gap after each
    block of ``block`` symbols of ``y`` is given the quarter turn that
    matches ``y_ref`` best (carrier recovery's slips are quarter turns)."""
    n, cols = y.shape
    nb = n // block
    yb = y[:nb * block].reshape(nb, block, cols)
    rb = y_ref[:nb * block].reshape(nb, block, cols)
    turns = torch.tensor([1, 1j, -1, -1j], dtype=torch.complex64, device=y.device)
    err = torch.stack([(torch.abs(yb * t - rb) ** 2).sum(dim=1) for t in turns])
    ya = (yb * turns[torch.argmin(err, dim=0)][:, None, :]).reshape(nb * block, cols)
    return rel_gap(ya, rb.reshape(nb * block, cols))


def receiver_gaps(y, ph, y_ref, y_eq_ref, block, n_train):
    """The program's chain output ``y`` (B, N, modes) with its carrier phases
    ``ph`` (N, B * modes) against the reference's output and equalizer
    output: (per column, the gap of the equalizer's output ``y e^{-j ph}``
    over the data-aided training symbols; per column, the quarter-turn
    aligned gap of ``y`` over all symbols). Before carrier recovery the
    training trajectory is fixed by the reference symbols; after it, blind
    phase search and unwrapping can slip a quarter turn at another symbol
    on a rounding tie."""
    yc = columns(y)
    eq = yc * torch.exp(-1j * ph)
    return (rel_gap(eq[:n_train], columns(y_eq_ref)[:n_train]),
            quarter_turn_gap(yc, columns(y_ref), block))


def columns(y):
    """(B, N, modes) -> (N, B * modes)."""
    b, n, m = y.shape
    return y.transpose(0, 1).reshape(n, b * m)
