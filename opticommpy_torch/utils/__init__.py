"""General utilities: unit conversions, random-generator helpers and a
run-independent cumulative sum (:mod:`.scan`)."""

from opticommpy_torch.utils.rng import ensure_generator
from opticommpy_torch.utils.units import db2lin, dbm2w, lin2db, w2dbm

__all__ = ["db2lin", "dbm2w", "lin2db", "w2dbm", "ensure_generator"]
