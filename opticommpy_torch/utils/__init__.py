"""General utilities: unit conversions and random-generator helpers."""

from opticommpy_torch.utils.rng import ensure_generator
from opticommpy_torch.utils.units import db2lin, dbm2w, lin2db, w2dbm

__all__ = ["db2lin", "dbm2w", "lin2db", "w2dbm", "ensure_generator"]
