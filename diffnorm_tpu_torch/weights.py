"""Carry weights between the JAX parameter tree and the port's modules.

The JAX tree (`variables["params"]`, nested dicts of numpy arrays) and the
port's `named_parameters()` share their paths: flax `a/b/kernel` is torch
`a.b.weight`, every other leaf keeps its name. A Dense kernel [in, out] is the
transpose of a Linear weight; a conv kernel [k, in, out] becomes torch's
[out, in, k]. Names are checked both ways, so a missing or extra key raises.

`save_npz` / `load_npz` store such a tree as one .npz with '/'-joined keys,
the weight file the CLI reads (`--params-npz`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


Path = Tuple[str, ...]


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def _unflatten(flat: Mapping[Path, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _torch_name(path: Path) -> str:
    leaf = "weight" if path[-1] == "kernel" else path[-1]
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


def from_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load the JAX `params` tree into `model` in place (on the model's
    device and dtype) and rebuild its packed weight copies (`pack_all`).
    Returns `model`."""
    flat = {_torch_name(p): (p, v) for p, v in _flatten(params).items()}
    named = dict(model.named_parameters())
    _check_names(named, flat)
    with torch.no_grad():
        for name, (path, value) in flat.items():
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            if path[-1] == "kernel":
                t = t.T if t.dim() == 2 else t.permute(2, 1, 0)
            p = named[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {tuple(t.shape)} does not "
                                 f"map onto {tuple(p.shape)}")
            p.copy_(t)
    return pack_all(model)


def to_jax_params(model: nn.Module) -> dict:
    """The inverse of `from_jax_params`: the model's parameters as a JAX
    `params` tree of float32 numpy arrays."""
    flat = {}
    for name, p in model.named_parameters():
        path = tuple(name.split("."))
        t = p.detach().float().cpu()
        if path[-1] == "weight":
            path = path[:-1] + ("kernel",)
            t = t.T if t.dim() == 2 else t.permute(2, 1, 0)
        flat[path] = t.contiguous().numpy()
    return _unflatten(flat)


def save_npz(path: str, params: Mapping) -> None:
    """Write a params tree as one .npz with '/'-joined keys."""
    np.savez(path, **{"/".join(p): np.asarray(v, dtype=np.float32)
                      for p, v in _flatten(params).items()})


def load_npz(path: str) -> dict:
    """Read a file written by `save_npz` back into a params tree."""
    with np.load(path) as data:
        return _unflatten({tuple(k.split("/")): data[k] for k in data.files})
