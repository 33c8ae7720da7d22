"""Parameter layouts over the mesh (the port's copy of
diffnorm_tpu/parallel/sharding_rules.py), as pure spec functions.

A spec is a tuple with one entry per leading axis of a parameter: "model",
"data" or None (JAX's PartitionSpec, whose entries it holds). Paths are the
flax paths of `weights.to_jax_params` ("layer_0", "q_proj", "kernel"), so a
tree of the port's weights and a tree of JAX's get the same layouts.

* `param_spec`: Megatron's tensor-parallel rules over "model" (column
  parallel: q/k/v and FFN up-projections split their output axis; row
  parallel: the output projections split their input axis; experts split
  their leading axis; everything else replicated).
* `shard_model` executes them on a module: each rank keeps its slice of
  every split parameter (in place), and the modules that own or hold split
  parameters get the model axis (`tp_axis`) their forwards read. A kernel
  that is two tensors side by side on its output axis (`PAIRED`: to_kv's k
  and v, proj_in's GEGLU x and gate, pointwise_conv1's GLU a and b) splits
  each half by itself, so rank m holds heads or channels m of each, as
  GSPMD keeps their meaning. `whole_params` gathers the slices back for
  the duration (checkpoints, `weights.to_jax_params`).
* `fsdp_spec`: FSDP / ZeRO-3 adds "data" on the largest axis still
  unsplit whose size the data degree divides. The trainer's --fsdp splits
  each trainable parameter on that axis (`data_axis`).
* `shard_params`: the spec tree of a params tree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

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


# kernels that are two tensors side by side on their output axis
PAIRED = {"to_kv": 2, "proj_in": 2, "pointwise_conv1": 2}
# column-parallel outputs that replicated code consumes: gathered after
GATHERED = ("time_proj",)


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """A split parameter's torch axis over "model", and its parts (each
    part of the axis split by itself into the ranks' contiguous blocks, the
    first ranks one more where the model degree does not divide it, as
    GSPMD splits an uneven axis: the released FF's inner width 1365)."""

    axis: int
    parts: int = 1
    whole: int = 0  # the split axis's whole length


def tp_spec(model: nn.Module, name: str, shape: Sequence[int]) -> Optional[TPSpec]:
    """The tensor-parallel split of the parameter `name` of `model` (of
    torch `shape`), by `param_spec` on its flax path and layout; None where
    it is replicated."""
    from diffnorm_tpu_torch.weights import jax_param_path, kernel_axes

    path, kernel = jax_param_path(model, name)
    shape = tuple(shape)
    flax_axes = kernel_axes(len(shape)) if kernel else tuple(range(len(shape)))
    flax_shape = [0] * len(shape)
    for a, f in enumerate(flax_axes):
        flax_shape[f] = shape[a]
    spec = param_spec(path, types.SimpleNamespace(shape=tuple(flax_shape)))
    if "model" not in spec:
        return None
    axis = flax_axes.index(spec.index("model"))
    parent = path[-2] if len(path) > 1 else ""
    column = parent in COLUMN_PARALLEL and axis == 0
    return TPSpec(axis, PAIRED.get(parent, 1) if column else 1, shape[axis])


def tp_slice(t: torch.Tensor, spec: TPSpec, index: int, size: int) -> torch.Tensor:
    """Rank `index`'s slice of the whole `t` (a view)."""
    from diffnorm_tpu_torch.parallel.mesh import row_block

    n = t.shape[spec.axis]
    if n % spec.parts or n // spec.parts < size:
        raise ValueError(f"an axis of {n} does not split into {spec.parts} part(s) over "
                         f"--model-parallel {size}")
    lo, hi = row_block(n // spec.parts, size, index)
    parts = t.unflatten(spec.axis, (spec.parts, n // spec.parts))
    return parts.narrow(spec.axis + 1, lo, hi - lo).flatten(spec.axis, spec.axis + 1)


def tp_gather(t: torch.Tensor, spec: TPSpec, axis, n: int) -> torch.Tensor:
    """The whole tensor (its split axis n long) from every model rank's
    slice `t`."""
    local = t.shape[spec.axis] // spec.parts
    parts = t.contiguous().unflatten(spec.axis, (spec.parts, local))
    whole = axis.all_gather_blocks(parts, n // spec.parts, spec.axis + 1)
    return whole.flatten(spec.axis, spec.axis + 1)


def shard_model(model: nn.Module, axis) -> Dict[str, TPSpec]:
    """Split `model`'s parameters over the model axis `axis` in place (each
    rank keeps its slice, `tp_slice`) and give the modules their axis; the
    split parameters' specs by name. Every module that owns a split
    parameter must have a tensor-parallel forward (`tp_ready` on it or its
    parent); an int8 site refuses."""
    specs: Dict[str, TPSpec] = {}
    if not (axis.active and axis.size > 1):
        return specs
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        spec = tp_spec(model, name, p.shape)
        if spec is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = modules[owner_name]
        parent = modules[owner_name.rpartition(".")[0]] if owner_name else None
        ready = owner if getattr(owner, "tp_ready", False) else parent
        if not getattr(ready, "tp_ready", False):
            raise NotImplementedError(
                f"--model-parallel: {name} splits over the model axis, and "
                f"{type(parent).__name__} has no tensor-parallel forward")
        if getattr(owner, "quant", False):
            raise NotImplementedError(f"--model-parallel with int8 sites ({name}): the int8 "
                                      f"routes (fused_layer, ffpipe_layer, ffpipe_layer2 and "
                                      f"the int8 module path) take whole-layer weights")
        with torch.no_grad():
            p.data = tp_slice(p.data, spec, axis.index, axis.size).contiguous()
        specs[name] = spec
        ready.tp_axis = axis
        if ready is not owner:
            owner.tp_axis = axis
            column = spec.axis == 0 if leaf == "weight" else True
            if owner_name.rpartition(".")[2] in GATHERED:
                owner.tp_kind = "gather"
            elif leaf == "weight":
                owner.tp_kind = "column" if column else "row"
    for m in model.modules():
        if getattr(m, "tp_axis", None) is not None and hasattr(m, "shard_heads"):
            m.shard_heads(axis.size)
    return specs


@contextlib.contextmanager
def whole_params(model: nn.Module, specs: Dict[str, TPSpec], axis) -> Iterator[nn.Module]:
    """`model` with its split parameters whole for the duration (gathered
    from the model ranks; every rank takes part), its slices again after."""
    if not specs:
        yield model
        return
    params = dict(model.named_parameters())
    local = {name: params[name].data for name in specs}
    try:
        with torch.no_grad():
            for name, spec in specs.items():
                params[name].data = tp_gather(local[name], spec, axis, spec.whole)
        yield model
    finally:
        for name, t in local.items():
            params[name].data = t
