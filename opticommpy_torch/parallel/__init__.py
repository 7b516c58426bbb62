"""Multi-device scaling on ``torch.distributed``: device meshes,
data-, pipeline- and sequence-parallel SSFM, time-sharded filtering.

Port of ``opticommpy_tpu/parallel/``: where the JAX package shards global
arrays over a ``jax.sharding.Mesh`` and exchanges halos by ``ppermute``,
the port splits tensors over a ``DeviceMesh`` of process-group ranks and
exchanges halos by point-to-point messages (NCCL on the card, gloo on the
CPU when asked for).
"""

from opticommpy_torch.parallel.mesh import (  # noqa: F401
    NamedSharding,
    P,
    data_sharding,
    make_mesh,
)
from opticommpy_torch.parallel.distributed import (  # noqa: F401
    init_distributed,
    is_multihost,
    local_device_count,
)
from opticommpy_torch.parallel.sharded import (  # noqa: F401
    default_sp_halo,
    manakov_ssf_dp,
    manakov_ssf_pp,
    manakov_ssf_sp,
    shard_batch,
    sharded_edc,
    sharded_fir,
)
