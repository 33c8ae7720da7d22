"""Serialized model export for serving (torch.export).

Counterpart of diffnorm_tpu/utils/export.py, with its names and modes. A
function is traced once by `torch.export.export` and its program written by
`torch.export.save`; the artifact reloads and runs without model code. The
hand-written kernels are `torch.library` custom ops (`diffnorm::*`, one per
kernel, registered by the `ops` modules), so the program holds each kernel as
one node and runs it on the card, or its plain version on the CPU.

Two modes:
  * bake_params=True  - the parameters and buffers are closed over and held
    in the program as constants: one self-contained file.
  * bake_params=False - the exported callable takes them as its first
    argument, a state dict (`module_fn` runs a module's method on one through
    `torch.func.functional_call`). Packed copies of the weights (the float
    packs of `FeedForward` and the WaveNet chains) are then built from the
    parameters given, inside the program; an int8 pack, which is built from
    float32 masters that a bf16 state dict does not hold, cannot be, and such
    a model raises: export it with bake_params=True.

`batch_poly=True` marks dim 0 of every input tensor with one shared
`torch.export.Dim("b")`, so one artifact serves any batch of 2 or more (the
traced batch must be 2 or more: torch.export specializes 0 and 1). The
int8 route ffpipe2 needs no batch decision at trace time: the
`diffnorm::ffpipe_layer` op carries rows=2 and the kernel takes it at each
call where that call's batch is even and >= 4, as it does eagerly.

The artifact is a zip holding MAGIC, the program (`program.pt2`) and the
custom ops it calls (`OPS`); `load_exported` imports the ops' registrations
alone and refuses an artifact whose op is not registered. The port's magic
is its own: JAX's artifact (StableHLO) is refused.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import zipfile
from typing import Callable, Dict

import torch

MAGIC = "diffnorm-torch-export-v1"
OP_NAMESPACE = "diffnorm"
# the modules whose import registers the diffnorm:: custom ops
OP_MODULES = tuple(f"diffnorm_tpu_torch.ops.{name}" for name in
                   ("norm", "wavenet_chain", "ffpipe", "fused_layer", "flash_attention"))

_params_as_input = False


def params_as_input() -> bool:
    """Whether a trace that takes the parameters as input is running
    (bake_params=False): packs must then come from the parameters given."""
    return _params_as_input


@contextlib.contextmanager
def _taking_params():
    global _params_as_input
    _params_as_input = True
    try:
        yield
    finally:
        _params_as_input = False


def register_ops() -> None:
    """Import the modules that register the diffnorm:: custom ops."""
    for name in OP_MODULES:
        importlib.import_module(name)


class _Method(torch.nn.Module):
    def __init__(self, module: torch.nn.Module, method: str):
        super().__init__()
        self.module, self.method = module, method

    def forward(self, *args):
        return getattr(self.module, self.method)(*args)


def module_fn(module: torch.nn.Module, method: str = "forward") -> Callable:
    """fn(params, *args): `module.<method>(*args)` on the parameters and
    buffers of the state dict `params` (torch.func.functional_call), for
    `export_fn(fn, args, params=module.state_dict(), ...)`."""
    call = _Method(module, method)

    def fn(params: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(call, {f"module.{k}": v for k, v in params.items()},
                                          args)

    return fn


class _Call(torch.nn.Module):
    """fn(*args), or fn(params, *args) with `params` closed over."""

    def __init__(self, fn: Callable, params=None):
        super().__init__()
        self.fn, self.params = fn, params

    def forward(self, *args):
        return self.fn(*args) if self.params is None else self.fn(self.params, *args)


def _batch_dims(args, batch):
    """dynamic_shapes for `args`: dim 0 of every tensor of 1 or more dims is
    `batch` (None: every shape static)."""
    def spec(x):
        if batch is not None and isinstance(x, torch.Tensor) and x.dim() >= 1:
            return {0: batch}
        return None

    return torch.utils._pytree.tree_map(spec, args)


def export_program(fn: Callable, example_args, params=None, bake_params: bool = True,
                   batch_poly: bool = False) -> torch.export.ExportedProgram:
    """The ExportedProgram of `fn` traced at `example_args` (`export_fn`'s
    arguments), traced without autograd: the program serves inference. It
    keeps no example inputs."""
    args = tuple(example_args)
    batch = torch.export.Dim("b") if batch_poly else None
    shapes = _batch_dims(args, batch)
    taking = contextlib.nullcontext()
    if params is None or bake_params:
        root = _Call(fn, params)
    else:
        root = _Call(fn)
        args = (params,) + args
        shapes = (_batch_dims(params, None),) + shapes
        taking = _taking_params()
    with torch.no_grad(), taking:
        ep = torch.export.export(root, args, dynamic_shapes=(shapes,) if batch_poly else None)
    # torch.export keeps the example inputs and would save them: under
    # bake_params=False the whole state dict
    ep.example_inputs = None
    return ep


def export_fn(fn: Callable, example_args, params=None, bake_params: bool = True,
              batch_poly: bool = False) -> bytes:
    """Export `fn` traced at `example_args` to the serialized program's bytes
    (`torch.export.save`).

    fn: callable - `fn(*example_args)` when params is None, otherwise
        `fn(params, *example_args)` (`module_fn` makes one of a module).
    params: optional state dict (parameters and buffers).
    bake_params: close over `params` (constants in the program) instead of
        taking them as a runtime argument. Ignored when params is None.
    batch_poly: export with a shared symbolic leading ("batch") dimension
        on every example arg.
    """
    return _serialize(export_program(fn, example_args, params, bake_params, batch_poly))


def _serialize(ep: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def program_ops(ep: torch.export.ExportedProgram):
    """The diffnorm:: custom ops a program calls ("diffnorm::<op>"), sorted."""
    return sorted({f"{OP_NAMESPACE}::{node.target._opname}" for node in ep.graph.nodes
                   if node.op == "call_function"
                   and isinstance(node.target, torch._ops.OpOverload)
                   and node.target.namespace == OP_NAMESPACE})


def save_exported(path, fn: Callable, example_args, params=None, bake_params: bool = True,
                  batch_poly: bool = False) -> int:
    """export_fn + write a self-describing zip artifact to `path`. Returns the
    program's size in bytes."""
    ep = export_program(fn, example_args, params, bake_params, batch_poly)
    blob = _serialize(ep)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("MAGIC", MAGIC)
        z.writestr("OPS", json.dumps(program_ops(ep)))
        z.writestr("program.pt2", blob)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return len(blob)


def deserialize(blob: bytes) -> Callable:
    """A callable that runs the program of `export_fn`'s bytes (without
    autograd), with the signature the export traced."""
    register_ops()
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(*args):
        with torch.no_grad():
            return module(*args)

    return call


def load_exported(path) -> Callable:
    """Load an artifact written by save_exported; returns a callable with the
    signature the export traced. Needs no model code: the ops' registrations
    are imported here, and an op the program calls that is not registered
    raises."""
    with zipfile.ZipFile(path) as z:
        magic = z.read("MAGIC").decode()
        if magic != MAGIC:
            raise ValueError(f"not a diffnorm export artifact: {magic!r}")
        ops = json.loads(z.read("OPS").decode())
        blob = z.read("program.pt2")
    register_ops()
    missing = [op for op in ops if not _registered(op)]
    if missing:
        raise RuntimeError(f"export artifact calls custom ops that are not registered: "
                           f"{missing}")
    return deserialize(blob)


def _registered(op: str) -> bool:
    namespace, _, name = op.partition("::")
    try:
        getattr(getattr(torch.ops, namespace), name)
    except (AttributeError, RuntimeError):
        return False
    return True
