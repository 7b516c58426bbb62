"""Communication-layer algorithms: modulation, sources, metrics, OFDM, LDPC
codes and FEC (port of ``opticommpy_tpu/comm``)."""

from opticommpy_torch.comm import codes, fec, metrics, modulation, ofdm, sources  # noqa: F401
from opticommpy_torch.comm.metrics import bert, qfunc, theory_ber  # noqa: F401
from opticommpy_torch.comm.modulation import (  # noqa: F401
    bit_map,
    demap,
    demodulate_gray,
    detector,
    gray_code,
    gray_mapping,
    min_euclid,
    mlse,
    modulate_gray,
    soft_estimator,
    soft_mapper,
)
from opticommpy_torch.comm.sources import (  # noqa: F401
    bit_source,
    cazac_sequence,
    prbs_generator,
    symbol_source,
)
