"""A JAX TrainState's optimizer state, loaded into the port's transforms.

`scripts/orbax_to_npz.py` writes a TrainState's `opt_state` (optax's state
tree: tuples for chains, dicts for the transforms' named states, None for
a state that is empty), `step` and `ema_params` beside its weights
(`train.checkpoint.OPTAX_STATE`). `load_transform` walks that tree against
the port's chain, which `optimizers.build_optimizer` built from the same
flags as JAX's build_optimizer (train/optimizers.py:297-349), position by
position, and copies each moment into the transform that holds it; a state
of another shape (another --optimizer, clipping or loss scale, other
composite groups) is refused. Moments of a kernel are converted as the
kernel is (`weights.leaf_to_torch`); adafactor's factored moments follow
the axes each side reduces.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence

import torch

from diffnorm_tpu_torch.train import optimizers as opt
from diffnorm_tpu_torch.weights import Path, kernel_axes, leaf_to_torch

# optax's state fields of each stateful transform -> the port's lists
_MOMENTS = {opt.ScaleByFairseqAdam: {"mu": "exp_avg", "nu": "exp_avg_sq"},
            opt.ScaleByFairseqAdamax: {"mu": "exp_avg", "nu": "exp_inf"},
            opt.ScaleByAdam: {"mu": "mu", "nu": "nu"},
            opt.ScaleByAdadelta: {"e_g": "e_g", "e_x": "e_x"},
            opt.ScaleByRss: {"sum_of_squares": "sum_of_squares"},
            opt.Trace: {"trace": "trace"},
            opt.FairseqNag: {"buf": "buf"}}
_STATELESS = (opt.Scale, opt.AddDecayedWeights, opt.ClipByGlobalNorm, opt.ScaleByTrustRatio,
              opt.ClipByBlockRms, opt.ScaleByParamBlockRms)


class Refused(ValueError):
    """The JAX optimizer state is not the chain the flags build."""


class ParamPaths:
    """The flax path of each parameter a transform updates, in its order,
    and whether the leaf is a kernel."""

    def __init__(self, paths: Sequence[Path], kernels: Sequence[bool]):
        self.paths, self.kernels = list(paths), list(kernels)

    def subset(self, index: Sequence[int]) -> "ParamPaths":
        return ParamPaths([self.paths[i] for i in index], [self.kernels[i] for i in index])

    def leaf(self, tree: Mapping, i: int, where: str):
        node = tree
        for key in self.paths[i]:
            if not isinstance(node, Mapping) or key not in node:
                raise Refused(f"{where}: no entry for parameter {'/'.join(self.paths[i])}")
            node = node[key]
        if node is None:
            raise Refused(f"{where}: parameter {'/'.join(self.paths[i])} is masked out")
        return node

    def copy_into(self, mine: List[torch.Tensor], tree: Mapping, where: str) -> None:
        """Each parameter's entry of `tree` (a params-shaped tree) into `mine`."""
        with torch.no_grad():
            for i, t in enumerate(mine):
                value = leaf_to_torch(self.leaf(tree, i, where), self.kernels[i])
                if tuple(value.shape) != tuple(t.shape):
                    raise Refused(f"{where}/{'/'.join(self.paths[i])}: shape "
                                  f"{tuple(value.shape)}, the model's {tuple(t.shape)}")
                t.copy_(value)


def _fields(node: Any, keys: Sequence[str], where: str) -> Mapping:
    if not isinstance(node, Mapping) or not set(keys) <= set(node):
        got = sorted(node) if isinstance(node, Mapping) else type(node).__name__
        raise Refused(f"{where}: expected a state with {sorted(keys)}, got {got}")
    return node


def _count(value) -> int:
    return int(torch.as_tensor(value).reshape(()).item())


def _factored_state(t: opt.ScaleByFactoredRms, node: Mapping, params: ParamPaths,
                    where: str) -> None:
    """optax's FactoredState: v for an unfactored parameter, else v_row and
    v_col, each the mean over one of the two largest axes; the port picks
    its axes on the torch layout, so a moment may be the other's, its axes
    permuted."""
    for i, dims in enumerate(t.dims):
        kernel, path = params.kernels[i], "/".join(params.paths[i])
        v, v_row, v_col = (torch.as_tensor(params.leaf(node[k], i, f"{where}/{k}")).float()
                           for k in ("v", "v_row", "v_col"))
        if dims is None:
            t.v[i] = leaf_to_torch(v.numpy(), kernel).to(t.v[i].device)
            continue
        ndim = len(t.shapes[i])
        axes = kernel_axes(ndim) if kernel else tuple(range(ndim))  # flax axis of each
        jax_shape = [0] * ndim
        for j, ax in enumerate(axes):
            jax_shape[ax] = t.shapes[i][j]
        jax_dims = opt._factored_dims(tuple(jax_shape), t.min_dim)
        if jax_dims is None:
            raise Refused(f"{where}/{path}: factored in the port, not in JAX")
        by_reduced = {jax_dims[1]: v_row, jax_dims[0]: v_col}  # flax axis reduced -> moment
        for name, reduced in (("v_row", dims[1]), ("v_col", dims[0])):
            src = by_reduced.get(axes[reduced])
            if src is None:
                raise Refused(f"{where}/{path}: the factored axes differ from JAX's")
            kept = [ax for ax in range(ndim) if ax != axes[reduced]]  # src's axes
            want = [axes[j] for j in range(ndim) if j != reduced]
            getattr(t, name)[i] = src.permute([kept.index(ax) for ax in want]).contiguous().to(
                getattr(t, name)[i].device)


def load_transform(t: opt.Transform, node: Any, params: ParamPaths, where: str = "opt_state"
                   ) -> None:
    """Load the optax state `node` into transform `t` (over `params`)."""
    if isinstance(t, opt.Chain):
        if not t.transforms:  # optax.identity
            if node is not None:
                raise Refused(f"{where}: expected an empty state, got {type(node).__name__}")
            return
        if not isinstance(node, (list, tuple)) or len(node) != len(t.transforms):
            n = len(node) if isinstance(node, (list, tuple)) else type(node).__name__
            raise Refused(f"{where}: expected a chain of {len(t.transforms)} states, got {n}")
        for k, (sub, sub_node) in enumerate(zip(t.transforms, node)):
            load_transform(sub, sub_node, params, f"{where}[{k}]")
    elif isinstance(t, _STATELESS):
        if node is not None:
            raise Refused(f"{where}: {type(t).__name__} keeps no state, got "
                          f"{type(node).__name__}")
    elif isinstance(t, opt.ScaleBySchedule):
        t.count = _count(_fields(node, ("count",), where)["count"])
    elif isinstance(t, opt.FreezeFinetune):
        if not isinstance(node, (list, tuple)) or len(node) != 2:
            raise Refused(f"{where}: expected freeze_finetune's (count, inner state)")
        t.count = _count(node[0])
        load_transform(t.inner, node[1], params, f"{where}[1]")
    elif isinstance(t, opt.Composite):
        inner = _fields(node, ("inner_states",), where)["inner_states"]
        if not isinstance(inner, Mapping) or set(inner) != set(t.transforms):
            got = sorted(inner) if isinstance(inner, Mapping) else type(inner).__name__
            raise Refused(f"{where}: composite groups {got}, the flags build "
                          f"{sorted(t.transforms)}")
        for label, sub in t.transforms.items():
            sub_node = _fields(inner[label], ("inner_state",), f"{where}/{label}")["inner_state"]
            load_transform(sub, sub_node, params.subset(t.index[label]), f"{where}/{label}")
    elif isinstance(t, opt.ScaleByFactoredRms):
        node = _fields(node, ("count", "v_row", "v_col", "v"), where)
        _factored_state(t, node, params, where)
        t.count = _count(node["count"])
    elif type(t) in _MOMENTS:
        fields = _MOMENTS[type(t)]
        scalars = [k for k in ("count", "lr_old") if k in t._scalars]
        node = _fields(node, tuple(fields) + tuple(scalars), where)
        for key, name in fields.items():
            params.copy_into(getattr(t, name), node[key], f"{where}/{key}")
        if "count" in scalars:
            t.count = _count(node["count"])
        if "lr_old" in scalars:
            t.lr_old = float(torch.as_tensor(node["lr_old"]).reshape(()).item())
    else:
        raise Refused(f"{where}: {type(t).__name__} has no JAX state map")


def load_ema(ema: Optional[opt.EMA], tree: Optional[Mapping], params: ParamPaths) -> None:
    """The EMA of the trainable parameters from JAX's `ema_params`."""
    if ema is None:
        return
    if tree is None:
        raise Refused("--ema-decay: the JAX checkpoint holds no EMA (ema_params)")
    params.copy_into(ema.params, tree, "ema_params")
