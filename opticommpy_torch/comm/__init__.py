"""Communication-layer algorithms: modulation, sources, metrics, LDPC codes
and FEC (port of ``opticommpy_tpu/comm``)."""

from opticommpy_torch.comm import codes, fec, metrics, modulation, sources  # noqa: F401
from opticommpy_torch.comm.metrics import bert, qfunc, theory_ber  # noqa: F401
from opticommpy_torch.comm.modulation import (  # noqa: F401
    bit_map,
    demap,
    demodulate_gray,
    gray_code,
    gray_mapping,
    min_euclid,
    modulate_gray,
)
from opticommpy_torch.comm.sources import bit_source, prbs_generator  # noqa: F401
