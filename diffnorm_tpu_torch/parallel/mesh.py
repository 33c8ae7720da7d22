"""Process groups and the data axis (the port's copy of
diffnorm_tpu/parallel/mesh.py).

JAX runs one SPMD program over a ("data", "model") device mesh: a batch is
put on the mesh split into contiguous row blocks (`shard_batch`), XLA
inserts the collectives, and a run at N devices gives the one-device run's
result on the same global batch by construction. The port runs one process
a rank on a `torch.distributed` process group (NCCL on the card, gloo under
--cpu) and makes the same promise by hand:

* every rank builds the same global batch, then keeps its contiguous rows
  (`shard_batch`; an uneven split gives the first n % N ranks one row more);
* a per-row draw is made for the global batch from the generator every rank
  holds in the same state, and each rank keeps its rows (`draw_rows`);
* a criterion that divides by a count of the batch (a mean) divides by the
  count over every rank (`global_sum`), so the ranks' losses add up to the
  global batch's loss, and the sum of their gradients is its gradient;
* BatchNorm's training statistics are sums over every rank
  (`all_reduce_grad`, differentiable).

The model axis (tensor parallelism) is not executed: `make_mesh` refuses a
model degree above 1.

Collectives are `Mesh` methods; on a mesh without a process group (one
process, no torchrun) each is the identity, and the port's one-process path
runs as before. A process group of one rank runs them all, and the whole
data-parallel path with them. gloo takes host tensors only: under gloo a
collective on CUDA tensors (two ranks sharing one card) is staged through
host memory. That is chosen by the group's backend, never by catching a
failure; NCCL takes the CUDA tensors themselves (a count made on the host
goes to the card first).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from diffnorm_tpu_torch.device import resolve_device

# a rank that dies fails its peers' next collective after this long, rather
# than hanging them
DEFAULT_TIMEOUT_S = 600.0
MODEL_PARALLEL_ITEM = "ROADMAP Queue 1 item 8b (tensor, pipeline and sequence parallelism)"


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if os.environ.get(name) else None


def init_distributed(cpu: bool = False, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group the environment describes and return this
    rank's device (JAX's init_distributed, mesh.py:22-42).

    torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT,
    or JAX's DIFFNORM_MULTIHOST=1 with DIFFNORM_COORDINATOR=host:port,
    DIFFNORM_NUM_PROCESSES and DIFFNORM_PROCESS_ID. The backend is NCCL on
    cuda:LOCAL_RANK, gloo on the CPU (`cpu`); without CUDA and without `cpu`
    this raises, as every entry point does. No environment (or a world of
    one) is a single process and joins nothing; a group already joined (by
    the caller) is kept."""
    device = resolve_device("cpu" if cpu else "cuda")
    if dist.is_available() and dist.is_initialized():
        return _rank_device(device)
    world = _env_int("WORLD_SIZE")
    rank = _env_int("RANK")
    addr = port = None
    if world is not None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
    elif int(os.environ.get("DIFFNORM_MULTIHOST", "0") or 0):
        coord = os.environ.get("DIFFNORM_COORDINATOR")
        if not coord:
            raise ValueError("DIFFNORM_MULTIHOST=1: the port needs DIFFNORM_COORDINATOR="
                             "host:port, DIFFNORM_NUM_PROCESSES and DIFFNORM_PROCESS_ID (or "
                             "torchrun's environment); nothing detects a cluster")
        addr, port = coord.rsplit(":", 1)
        world = int(os.environ["DIFFNORM_NUM_PROCESSES"])
        rank = int(os.environ["DIFFNORM_PROCESS_ID"])
    if world is None or world == 1:
        return device
    if port is None or rank is None:
        raise ValueError("WORLD_SIZE > 1 needs RANK and MASTER_PORT (torchrun sets them)")
    device = _rank_device(device)
    dist.init_process_group(
        backend="gloo" if device.type == "cpu" else "nccl",
        init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": device} if device.type == "cuda" else {}))
    return device


def _rank_device(device: torch.device) -> torch.device:
    """cuda:LOCAL_RANK on the card (set as the current device)."""
    if device.type != "cuda":
        return device
    local = _env_int("LOCAL_RANK")
    if local is None:
        return device
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def row_block(n: int, data: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of rank `index`'s contiguous rows of n split over `data`
    ranks; the first n % data ranks take one row more."""
    base, extra = divmod(n, data)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis over the process group: `data` ranks, this one
    `index`. `shape` reads as JAX's mesh.shape ({"data": .., "model": 1})."""

    data: int = 1
    index: int = 0
    backend: Optional[str] = None  # None: one process, no group, no collectives

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": 1}

    @property
    def active(self) -> bool:
        """A process group under it (its collectives run, at one rank too)."""
        return self.backend is not None

    @property
    def staged(self) -> bool:
        """gloo: collectives on CUDA tensors go through host memory."""
        return self.backend == "gloo"

    def rows(self, n: int) -> Tuple[int, int]:
        return row_block(n, self.data, self.index)

    # -- collectives (each the identity without a process group)

    def _placed(self, tensor: torch.Tensor) -> torch.Tensor:
        """`tensor` where the backend takes it: a host copy of a CUDA tensor
        under gloo, a copy on the current card of a host tensor under NCCL
        (a count made on the host), else itself."""
        if self.staged and tensor.is_cuda:
            return tensor.detach().cpu()
        if self.backend == "nccl" and not tensor.is_cuda:
            return tensor.detach().to(torch.device("cuda", torch.cuda.current_device()))
        return tensor

    @contextlib.contextmanager
    def _host(self, tensor: torch.Tensor) -> Iterator[torch.Tensor]:
        """The tensor an in-place collective runs on (`_placed`), copied
        back into `tensor` after."""
        placed = self._placed(tensor)
        yield placed
        if placed is not tensor:
            tensor.copy_(placed)

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place over the ranks (op "sum" or "max"); returns `tensor`."""
        if self.active:
            with self._host(tensor) as t:
                dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return tensor

    def all_reduce_many(self, tensors, op: str = "sum") -> None:
        """`all_reduce` of a list of tensors of one dtype, as one flat
        collective."""
        tensors = list(tensors)
        if not self.active or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce(flat, op)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def all_gather(self, tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `tensor` (of one shape) concatenated along `dim`,
        rank 0's first."""
        if not self.active:
            return tensor
        src = self._placed(tensor.detach().contiguous())
        parts = [torch.empty_like(src) for _ in range(self.data)]
        dist.all_gather(parts, src)
        return torch.cat(parts, dim=dim).to(tensor.device)

    def all_gather_rows(self, tensor: torch.Tensor, n: int) -> torch.Tensor:
        """The n rows of a row-split tensor (this rank's `rows(n)`) back in
        order on every rank: the blocks are padded to the largest, gathered
        and cut."""
        if not self.active:
            return tensor
        most = row_block(n, self.data, 0)[1]
        pad = most - tensor.shape[0]
        if pad:
            tensor = torch.cat([tensor, tensor.new_zeros((pad,) + tuple(tensor.shape[1:]))])
        full = self.all_gather(tensor)
        return torch.cat([full[i * most:i * most + (hi - lo)] for i in range(self.data)
                          for lo, hi in [row_block(n, self.data, i)]])

    def reduce_scatter(self, tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum over the ranks of `tensor`, this rank's block of `dim`
        (divisible by `data`). NCCL reduce-scatters; gloo all-reduces a host
        copy and keeps the block."""
        if not self.active:
            return tensor
        size = tensor.shape[dim] // self.data
        if self.staged:
            total = self.all_reduce(tensor.detach().clone())
            return total.narrow(dim, self.index * size, size).contiguous()
        parts = [self._placed(p.contiguous()) for p in tensor.detach().split(size, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts)
        return out.to(tensor.device)

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place from rank `src`; returns `tensor`."""
        if self.active:
            with self._host(tensor) as t:
                dist.broadcast(t, src)
        return tensor

    def barrier(self) -> None:
        if self.active:
            dist.barrier()


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The data axis over the process group (JAX's make_mesh): `data` -1 is
    every rank. The model axis is not executed here: `model` above 1
    raises."""
    if model != 1:
        raise NotImplementedError(f"--model-parallel {model}: tensor parallelism is not "
                                  f"ported ({MODEL_PARALLEL_ITEM})")
    world = world_size()
    if data == -1:
        data = world
    if data != world:
        raise ValueError(f"--data-parallel {data} needs {data} processes, this group has "
                         f"{world}: launch with torchrun --nproc-per-node {data} (and --cpu "
                         f"for gloo on the CPU)")
    backend = dist.get_backend() if dist.is_available() and dist.is_initialized() else None
    return Mesh(data=data, index=rank(), backend=backend)


def shard_batch(batch: Dict[str, Any], mesh: Mesh,
                n: Optional[int] = None) -> Tuple[Dict[str, Any], Tuple[int, int, int]]:
    """This rank's contiguous rows of a global batch (JAX's shard_batch),
    and (n, lo, hi): the global row count and this rank's block. Every
    tensor or array entry of at least one axis whose leading axis is n rows
    is cut (nested dicts too, the aux tasks' entries); the others (0-d
    draws, a scalar temperature) are kept whole. `n` is the leading axis of
    the first such entry unless given. Each rank needs a row: a batch of
    fewer rows than ranks raises."""
    if n is None:
        n = _leading_rows(batch)
    lo, hi = mesh.rows(n) if n is not None else (0, 0)
    if n is None or mesh.data == 1:
        return batch, (n or 0, 0, n or 0)
    if hi == lo:
        raise ValueError(f"a batch of {n} rows cannot split over {mesh.data} data-parallel "
                         f"ranks (each needs a row): raise --batch-size / --max-tokens or "
                         f"--required-batch-size-multiple")

    def cut(value):
        if isinstance(value, dict):
            return {k: cut(v) for k, v in value.items()}
        shape = getattr(value, "shape", None)
        if shape is not None and len(shape) >= 1 and shape[0] == n:
            return value[lo:hi]
        return value

    return {k: cut(v) for k, v in batch.items()}, (n, lo, hi)


def _leading_rows(batch: Dict[str, Any]) -> Optional[int]:
    for value in batch.values():
        if isinstance(value, dict):
            inner = _leading_rows(value)
            if inner is not None:
                return inner
            continue
        shape = getattr(value, "shape", None)
        if shape is not None and len(shape) >= 1:
            return int(shape[0])
    return None


def prefetch_to_device(groups, prepare: Callable[[Any], Any], depth: int = 2,
                       device: Optional[torch.device] = None):
    """`prepare(group)` for each group of micro-batches, `depth` groups
    ahead of the consumer (JAX's prefetch_to_device). On the card the
    preparation, whose uploads are non-blocking, runs on a side stream, and
    the consumer's stream waits for it before it takes the group (each
    tensor recorded on the consumer's stream, so its memory is not reused
    while that stream reads it)."""
    from diffnorm_tpu_torch.data.iterators import read_ahead

    if device is None or device.type != "cuda":
        yield from read_ahead(groups, prepare, depth=depth)
        return
    side = torch.cuda.Stream(device=device)

    def on_side(group):
        with torch.cuda.stream(side):
            out = prepare(group)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    main = torch.cuda.current_stream(device)

    def record(value):
        if isinstance(value, torch.Tensor):
            if value.is_cuda:
                value.record_stream(main)
        elif isinstance(value, dict):
            for v in value.values():
                record(v)
        elif isinstance(value, (list, tuple)):
            for v in value:
                record(v)

    for out, ready in read_ahead(groups, on_side, depth=depth):
        main.wait_event(ready)
        record(out)
        yield out


def split_rows(mesh: Mesh, fn: Callable, rows: Dict[str, Any],
               axes: Optional[Tuple[int, ...]] = None):
    """`fn(**rows)` with the rows split over the data ranks, its outputs (a
    tuple of tensors, rows on axis 0 or on `axes`' entry) gathered back in
    order on every rank: the row inputs (None entries kept) are padded to a
    multiple of the degree with copies of the last row, so every rank
    decodes an equal block, and the outputs are cut back. Each row's result
    is its own, so the outputs are the one-process call's (JAX's decodes
    under a "data" mesh)."""
    if not mesh.active:
        return fn(**rows)
    n = next(int(v.shape[0]) for v in rows.values() if v is not None)
    pad = (-n) % mesh.data
    lo, hi = mesh.rows(n + pad)

    def cut(v):
        if v is None:
            return None
        if pad:
            v = torch.cat([v, v[-1:].expand((pad,) + tuple(v.shape[1:]))])
        return v[lo:hi]

    out = fn(**{k: cut(v) for k, v in rows.items()})
    axes = axes or (0,) * len(out)
    return tuple(mesh.all_gather(t.contiguous(), dim=a).narrow(a, 0, n)
                 for t, a in zip(out, axes))


def replicate(module_or_tensors, mesh: Mesh, src: int = 0):
    """Rank `src`'s parameters and buffers (a module's, or a list of
    tensors) on every rank, in place (JAX's replicate)."""
    if not mesh.active:
        return module_or_tensors
    tensors = (list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
               if isinstance(module_or_tensors, torch.nn.Module) else list(module_or_tensors))
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast(t.data, src)
    return module_or_tensors


# -- the split a forward runs under: the criterions' counts, the per-row
# draws and BatchNorm's statistics read it

@dataclasses.dataclass(frozen=True)
class RowSplit:
    mesh: Mesh
    n: int   # the global batch's rows
    lo: int  # this rank's block [lo, hi)
    hi: int


_SPLIT: Optional[RowSplit] = None


@contextlib.contextmanager
def row_split(mesh: Mesh, n: int, lo: int, hi: int) -> Iterator[None]:
    """Run a forward on rows [lo, hi) of an n-row global batch: inside,
    `global_sum`, `draw_rows` and `all_reduce_grad` act over the ranks. A
    mesh without a process group sets nothing."""
    global _SPLIT
    saved = _SPLIT
    _SPLIT = RowSplit(mesh, n, lo, hi) if mesh.active else None
    try:
        yield
    finally:
        _SPLIT = saved


def active_split() -> Optional[RowSplit]:
    return _SPLIT


def global_sum(count):
    """A count of the batch (no gradient) summed over the ranks of the
    active split, for the division a mean makes; the count itself outside
    one. A Python number comes back as a 0-d float32 tensor under a split."""
    split = _SPLIT
    if split is None:
        return count
    t = torch.as_tensor(count).detach()
    device = t.device
    total = split.mesh.all_reduce(t.to(torch.float32).reshape(1).clone())
    return total.reshape(()).to(device)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() over the global batch (x holds this rank's rows): the
    ranks' sums over the count of every rank's elements under a split,
    `x.mean()` itself outside one."""
    if _SPLIT is None:
        return x.mean()
    return x.sum() / global_sum(x.numel())


def draw_rows(draw: Callable[[int], torch.Tensor], n_local: int) -> torch.Tensor:
    """`draw(rows)`, a per-row draw over `rows` leading rows: under a split
    it draws for the global batch and returns this rank's rows, so the
    generator moves as the one-process run's does."""
    split = _SPLIT
    if split is None:
        return draw(n_local)
    if split.hi - split.lo != n_local:
        raise ValueError(f"draw_rows: {n_local} local rows under a split of "
                         f"[{split.lo}, {split.hi}) of {split.n}")
    return draw(split.n)[split.lo:split.hi]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone()), None


def all_reduce_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks of the active split, differentiable
    (the backward sums the ranks' gradients); `x` outside one."""
    split = _SPLIT
    if split is None:
        return x
    return _AllReduceSum.apply(x, split.mesh)
