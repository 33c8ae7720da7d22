"""Data parallelism and sharded training state on torch.distributed process
groups (the port's copy of diffnorm_tpu/parallel/, its data axis)."""

from diffnorm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    prefetch_to_device,
    replicate,
    row_split,
    shard_batch,
)
