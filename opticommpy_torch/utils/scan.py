"""A cumulative sum whose result on a GPU does not change from run to run.

``torch.cumsum`` over a whole tensor on CUDA (a 1-D tensor, or any tensor
whose scanned dimension holds all its elements) runs one device-wide scan
whose partial sums are combined in an order that depends on timing, so the
float32 result can differ in the last bits between two runs on the same
input. A scan along one dimension of a tensor with several rows or columns
sums each of them in a fixed order. :func:`cumsum` turns the first case
into the second: it cuts the tensor into rows of ``block`` elements, scans
the rows, then scans the row totals.
"""

import torch

__all__ = ["cumsum"]


def cumsum(x, dim=0, block=1024):
    """``torch.cumsum(x, dim)`` with a run-independent summation order."""
    x = torch.as_tensor(x)
    n = x.shape[dim] if x.ndim else 1
    if x.ndim == 0 or x.numel() != n or n <= block:
        return torch.cumsum(x, dim=dim)
    shape = x.shape
    flat = x.reshape(-1)
    rows = -(-n // block)
    padded = torch.zeros(rows * block, dtype=x.dtype, device=x.device)
    padded[:n] = flat
    within = padded.reshape(rows, block).cumsum(dim=1)
    # the row totals, scanned with a second (zero) column so that this scan
    # is per column too
    totals = torch.stack([within[:, -1], torch.zeros_like(within[:, -1])], dim=1)
    carry = totals.cumsum(dim=0)[:, 0]
    offsets = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]])
    return (within + offsets[:, None]).reshape(-1)[:n].reshape(shape)
