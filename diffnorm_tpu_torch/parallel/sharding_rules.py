"""Parameter layouts over the mesh (the port's copy of
diffnorm_tpu/parallel/sharding_rules.py), as pure spec functions.

A spec is a tuple with one entry per leading axis of a parameter: "model",
"data" or None (JAX's PartitionSpec, whose entries it holds). Paths are the
flax paths of `weights.to_jax_params` ("layer_0", "q_proj", "kernel"), so a
tree of the port's weights and a tree of JAX's get the same layouts.

* `param_spec`: Megatron's tensor-parallel rules over "model" (column
  parallel: q/k/v and FFN up-projections split their output axis; row
  parallel: the output projections split their input axis; experts split
  their leading axis; everything else replicated). The port does not run
  the model axis (ROADMAP Queue 1 item 8b): the rules are here so the
  layouts are fixed where that work starts.
* `fsdp_spec`: FSDP / ZeRO-3 adds "data" on the largest axis still
  unsplit whose size the data degree divides. The trainer's --fsdp splits
  each trainable parameter on that axis (`data_axis`).
* `shard_params`: the spec tree of a params tree.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

COLUMN_PARALLEL = (
    "to_q", "to_kv", "q_proj", "k_proj", "v_proj", "linear_q", "linear_k",
    "linear_v", "fc1", "w_1", "proj_in", "time_proj", "pointwise_conv1",
)
ROW_PARALLEL = (
    "to_out", "out_proj", "linear_out", "fc2", "w_2", "proj_out",
    "pointwise_conv2",
)

Spec = Tuple[Optional[str], ...]


def param_spec(path: Sequence, value) -> Spec:
    """The tensor-parallel spec of one parameter by its flax path."""
    names = [p if isinstance(p, str) else getattr(p, "key", str(p)) for p in path]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    ndim = len(getattr(value, "shape", ()))
    if leaf.startswith("experts_") and ndim >= 2:
        return ("model",) + (None,) * (ndim - 1)
    if leaf == "kernel" and ndim >= 2:
        if parent in COLUMN_PARALLEL:
            return (None,) * (ndim - 1) + ("model",)
        if parent in ROW_PARALLEL:
            # Dense kernels [in, out]; conv kernels [k, in, out]
            spec = [None] * ndim
            spec[-2] = "model"
            return tuple(spec)
    if leaf == "bias" and parent in COLUMN_PARALLEL:
        return ("model",)
    return ()


def fsdp_spec(spec: Spec, value, mesh) -> Spec:
    """`spec` with "data" on the largest unsplit axis the data degree
    divides (the first of equal sizes); `spec` itself where none does, at
    data degree 1, and for a 0-d value."""
    dp = mesh.shape.get("data", 1)
    shape = tuple(getattr(value, "shape", ()))
    if dp == 1 or not shape:
        return tuple(spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for a in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if entries[a] is None and shape[a] % dp == 0 and shape[a] >= dp:
            entries[a] = "data"
            return tuple(entries)
    return tuple(spec)


def data_axis(spec: Spec) -> Optional[int]:
    """The axis a spec splits over "data", or None."""
    return spec.index("data") if "data" in spec else None


def shard_params(params, mesh, fsdp: bool = False):
    """The spec of every leaf of a nested dict of arrays (JAX's shard_params
    without the placement): the tensor-parallel spec where the mesh has a
    model axis above 1, else replicated; `fsdp` adds the data axis."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        spec = param_spec(path, node) if mesh.shape.get("model", 1) > 1 else ()
        return fsdp_spec(spec, node, mesh) if fsdp else spec

    return walk(params, ())
