"""Data, tensor, sequence and pipeline parallelism and sharded training state
on torch.distributed process groups (the port's copy of
diffnorm_tpu/parallel/)."""

from diffnorm_tpu_torch.parallel.mesh import (  # noqa: F401
    Axis,
    Mesh,
    init_distributed,
    make_mesh,
    make_seq_mesh,
    make_stage_mesh,
    prefetch_to_device,
    replicate,
    row_split,
    shard_batch,
)
