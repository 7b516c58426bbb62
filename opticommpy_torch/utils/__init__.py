"""General utilities: unit conversions, bit arrays, random-generator
helpers and a run-independent cumulative sum (:mod:`.scan`)."""

from opticommpy_torch.utils.bits import bitarray2dec, dec2bitarray
from opticommpy_torch.utils.rng import ensure_generator
from opticommpy_torch.utils.units import (
    ber2qfactor,
    db2lin,
    dbm2w,
    lin2db,
    llr2bit_prob,
    w2dbm,
)

__all__ = ["bitarray2dec", "dec2bitarray", "db2lin", "dbm2w", "lin2db", "w2dbm", "ber2qfactor", "llr2bit_prob",
           "ensure_generator"]
