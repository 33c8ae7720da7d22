"""Carry weights between the JAX variables tree and the port's modules.

The JAX tree (`{"params": ..., "batch_stats": ...}`, nested dicts of numpy
arrays) and the port's `state_dict()` share their paths. Leaf names map as
  params       flax `kernel` (Dense, Conv, ConvTranspose)  -> torch `weight`
               flax `scale` (LayerNorm, GroupNorm, BatchNorm) -> torch `weight`
               flax `embedding` (nn.Embed)                 -> torch `weight`
               any other leaf keeps its name and layout (the
                 MoE layer's experts_w1 [E, dim, ffn], experts_w2 and
                 expert_centroids are plain params, not Dense kernels)
  batch_stats  `mean` / `var`          -> the `running_mean` / `running_var` buffers
  quant_stats  `act_amax`               -> the calibrated `act_amax` of the int8
                                           site at that path (ops/quant.py QuantSite)
A Dense kernel [in, out] is the transpose of a Linear weight; a conv kernel
[k, in, out] becomes torch's [out, in, k] (a grouped one [k, in / groups,
out] torch's [out, in / groups, k]), and a
`ConvTranspose(transpose_kernel=True)` kernel [k, out, in] torch
ConvTranspose1d's [in, out, k], both by `permute(2, 1, 0)` with no flip; a
2-D conv kernel [kh, kw, in, out] becomes torch's [out, in, kh, kw].
Names are checked both ways, buffers included, so a missing or extra key
raises; `quant_stats` is optional and names int8 sites only.

`save_npz` / `load_npz` store such a tree as one .npz with '/'-joined keys,
the weight files the CLIs read (`--params-npz`, `--vocoder-npz`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from diffnorm_tpu_torch.ops.quant import quant_sites


Path = Tuple[str, ...]

_TO_WEIGHT = ("kernel", "scale", "embedding")
# flax kernel <-> torch weight by rank: Dense [in, out] <-> [out, in]; a 1-D
# conv [k, in, out] <-> [out, in, k]; a 2-D conv [kh, kw, in, out] <->
# [out, in, kh, kw]
_KERNEL_TO_TORCH = {2: lambda t: t.T, 3: lambda t: t.permute(2, 1, 0),
                    4: lambda t: t.permute(3, 2, 0, 1)}
_KERNEL_TO_JAX = {2: lambda t: t.T, 3: lambda t: t.permute(2, 1, 0),
                  4: lambda t: t.permute(2, 3, 1, 0)}
_STATS = {"mean": "running_mean", "var": "running_var"}


def flatten_tree(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    """{path tuple: leaf} of a nested mapping."""
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat: Mapping[Path, np.ndarray]) -> dict:
    """The inverse of `flatten_tree`."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _torch_name(collection: str, path: Path) -> str:
    leaf = path[-1]
    if collection == "batch_stats":
        leaf = _STATS.get(leaf, leaf)
    elif leaf in _TO_WEIGHT:
        leaf = "weight"
    return ".".join(path[:-1] + (leaf,))


def _check_names(have, want) -> None:
    missing, extra = sorted(set(have) - set(want)), sorted(set(want) - set(have))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing from the JAX tree "
                       f"{missing[:10]}, not in the model {extra[:10]}")


def pack_all(model: nn.Module) -> nn.Module:
    """Rebuild the packed weight copies of every module that has them
    (`pack_weights`: WaveNet chains, FeedForward, and with int8 the QDense,
    conv and fused-kernel packs). Int8 packs are built from float32
    parameters, as JAX quantizes its float32 masters: call this, like
    `from_jax_params`, before casting the model to bf16; the packs keep
    their types through the cast."""
    for m in list(model.modules()):
        if hasattr(m, "pack_weights"):
            m.pack_weights()
    return model


def _load_quant_stats(model: nn.Module, tree: Mapping) -> None:
    sites = dict(quant_sites(model))
    for path, value in flatten_tree(tree).items():
        site = sites.get(".".join(path[:-1]))
        if site is None or path[-1] != "act_amax":
            raise KeyError(f"quant_stats/{'/'.join(path)} names no int8 site of the model")
        device = next(site.parameters()).device
        site.act_amax = torch.tensor(np.asarray(value, np.float32).reshape(()),
                                     device=device)


def from_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a JAX variables tree ({"params"} and, where the model has
    BatchNorm state, {"batch_stats"}; calibrated int8 scales, where given,
    as {"quant_stats"}) into `model` in place, on the model's device and
    dtype, and rebuild its packed weight copies (`pack_all`). Every
    parameter and persistent buffer must be covered. Returns `model`."""
    flat = {}
    for collection, tree in variables.items():
        if collection == "quant_stats":
            _load_quant_stats(model, tree)
            continue
        for path, value in flatten_tree(tree).items():
            flat[_torch_name(collection, path)] = (path, value)
    named = model.state_dict(keep_vars=True)
    _check_names(named, flat)
    with torch.no_grad():
        for name, (path, value) in flat.items():
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            if path[-1] == "kernel":
                t = _KERNEL_TO_TORCH[t.dim()](t)
            p = named[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {tuple(t.shape)} does not "
                                 f"map onto {tuple(p.shape)}")
            p.copy_(t)
    return pack_all(model)


def from_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """`from_jax_variables` for a model without buffers: the JAX `params`
    tree alone."""
    return from_jax_variables(model, {"params": params})


def _jax_leaf(module: nn.Module) -> str:
    if isinstance(module, nn.Embedding):
        return "embedding"
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)) or hasattr(module, "running_mean"):
        return "scale"
    return "kernel"


def jax_param_path(model: nn.Module, name: str) -> Tuple[Path, bool]:
    """The flax path of the parameter `name` ("a.b.weight") and whether it is
    a kernel (whose layout `leaf_to_torch` converts)."""
    path = tuple(name.split("."))
    if path[-1] != "weight":
        return path, False
    leaf = _jax_leaf(model.get_submodule(".".join(path[:-1])))
    return path[:-1] + (leaf,), leaf == "kernel"


def kernel_axes(ndim: int) -> Tuple[int, ...]:
    """The flax axis of each axis of a converted kernel of rank `ndim`."""
    return {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[ndim]


def leaf_to_torch(value, kernel: bool) -> torch.Tensor:
    """A JAX leaf as the port's float32 tensor (a kernel in torch's layout)."""
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    return _KERNEL_TO_TORCH[t.dim()](t) if kernel else t


def to_jax_variables(model: nn.Module) -> dict:
    """The inverse of `from_jax_variables`: {"params": ...} and, where the
    model has running statistics, {"batch_stats": ...}, and where an int8
    site holds a calibrated amax, {"quant_stats": ...}; float32 numpy."""
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        path = tuple(name.split("."))
        t = t.detach().float().cpu()
        owner = model.get_submodule(".".join(path[:-1]))
        if path[-1] in ("running_mean", "running_var"):
            stats[path[:-1] + (path[-1][len("running_"):],)] = t.contiguous().numpy()
            continue
        if path[-1] == "weight":
            leaf = _jax_leaf(owner)
            if leaf == "kernel":
                t = _KERNEL_TO_JAX[t.dim()](t)
            path = path[:-1] + (leaf,)
        params[path] = t.contiguous().numpy()
    out = {"params": unflatten_tree(params)}
    if stats:
        out["batch_stats"] = unflatten_tree(stats)
    amax = {tuple(name.split(".")) + ("act_amax",): site.act_amax.float().cpu().numpy()
            for name, site in quant_sites(model) if site.act_amax is not None}
    if amax:
        out["quant_stats"] = unflatten_tree(amax)
    return out


def to_jax_params(model: nn.Module) -> dict:
    """The model's parameters as a JAX `params` tree (float32 numpy)."""
    return to_jax_variables(model)["params"]


COLLECTIONS = ("params", "batch_stats", "quant_stats")


def as_variables(tree: Mapping) -> dict:
    """A variables tree as it is; a params tree alone (whose top level names
    modules, not collections) as {"params": tree}."""
    if "params" in tree and set(tree) <= set(COLLECTIONS):
        return dict(tree)
    return {"params": tree}


def save_npz(path: str, tree: Mapping) -> None:
    """Write a params or variables tree as one .npz with '/'-joined keys."""
    np.savez(path, **{"/".join(p): np.asarray(v, dtype=np.float32)
                      for p, v in flatten_tree(tree).items()})


def load_npz(path: str) -> dict:
    """Read a file written by `save_npz` back into its tree."""
    with np.load(path) as data:
        return unflatten_tree({tuple(k.split("/")): data[k] for k in data.files})
