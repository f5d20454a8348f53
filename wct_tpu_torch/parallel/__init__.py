"""Device-mesh parallelism: sharded batched inference and training."""

from wct_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Sharded,
    batch_sharding,
    create_mesh,
    encode_spatial,
    gather,
    replicated,
    shard_batch,
    shard_spatial,
    sharded_covariance,
    stylize_sharded,
    stylize_spatial,
)
