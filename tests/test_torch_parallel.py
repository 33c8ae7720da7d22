"""The port's parallel package in one process (diffnorm_tpu_torch/parallel/,
train/optimizers.py's BMUF and ZeRO rule) against the JAX package on the
CPU: the sharding rules' layouts on the same trees, shard_batch's row
blocks (an uneven split included), the optimizer-state axis of
--zero-sharding os, BMUF over 2 x global_sync_iter updates on shared weights
(float32, within 1e-6 relative), and the CLI's parallel flags."""

import jax
import numpy as np
import optax
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffnorm_tpu.parallel.sharding_rules import fsdp_spec as jax_fsdp_spec
from diffnorm_tpu.parallel.sharding_rules import param_spec as jax_param_spec
from diffnorm_tpu.parallel.sharding_rules import shard_params as jax_shard_params
from diffnorm_tpu.train.optimizers import shard_optimizer_state as jax_shard_optimizer_state
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.parallel import mesh as pmesh
from diffnorm_tpu_torch.parallel.mesh import Mesh, row_block, shard_batch
from diffnorm_tpu_torch.parallel.sharding_rules import (
    data_axis,
    fsdp_spec,
    param_spec,
    shard_params,
)
from diffnorm_tpu_torch.train.lr_schedules import build_lr_schedule
from diffnorm_tpu_torch.train.optimizers import build_optimizer, shard_optimizer_state, zero_axis
from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
from diffnorm_tpu_torch.weights import flatten_tree, to_jax_params
from tests.test_torch_optim import STEPS, _close, _run_jax, _run_port, _setup
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


class FakeMesh:
    """What the spec functions read of a mesh: its shape."""

    def __init__(self, data, model=1):
        self.shape = {"data": data, "model": model}


def _norm(spec):
    """A spec without its trailing Nones (JAX's P and the port's tuples)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


# a tree of the rules' cases: column / row parallel kernels and biases, a
# conv kernel, experts, embeddings, scalars and a size no degree divides
TREE = {
    "layer_0": {"q_proj": {"kernel": np.zeros((64, 128)), "bias": np.zeros((128,))},
                "out_proj": {"kernel": np.zeros((128, 64)), "bias": np.zeros((64,))},
                "fc1": {"kernel": np.zeros((64, 256))}, "fc2": {"kernel": np.zeros((256, 64))},
                "pointwise_conv2": {"kernel": np.zeros((1, 96, 48))},
                "moe": {"experts_w1": np.zeros((4, 64, 32))}},
    "embed": {"embedding": np.zeros((1004, 512))},
    "norm": {"scale": np.zeros((7,)), "count": np.zeros(())},
    "conv": {"kernel": np.zeros((3, 5, 9))},
}


@pytest.mark.parametrize("data,model", [(4, 2), (2, 1), (8, 1), (1, 1)])
def test_sharding_rules_match_jax(data, model):
    fake = FakeMesh(data, model)
    for path, value in flatten_tree(TREE).items():
        spec = param_spec(path, value)
        assert _norm(spec) == _norm(jax_param_spec(path, value)), path
        assert _norm(fsdp_spec(spec, value, fake)) == _norm(
            jax_fsdp_spec(jax_param_spec(path, value), value, fake)), path
        assert _norm(fsdp_spec((), value, fake)) == _norm(
            jax_fsdp_spec(jax.sharding.PartitionSpec(), value, fake)), path
    if data * model == 8:  # JAX's shard_params places on the 8 CPU devices
        mesh = jax_make_mesh(data=data, model=model)
        for fsdp in (False, True):
            placed = flatten_tree(jax.device_get(jax.tree_util.tree_map(
                lambda x: x.sharding.spec,
                jax_shard_params(TREE, mesh, fsdp=fsdp))))
            mine = flatten_tree(shard_params(TREE, fake, fsdp=fsdp))
            assert sorted(mine) == sorted(placed)
            for k in mine:
                assert _norm(mine[k]) == _norm(placed[k]), (k, fsdp)


def test_fsdp_axis_of_the_port_names():
    """data_axis reads fsdp_spec's pick: the largest axis the degree
    divides (the first of equal sizes), none where no axis divides."""
    fake = FakeMesh(4)
    assert data_axis(fsdp_spec((), torch.zeros(12, 40), fake)) == 1
    assert data_axis(fsdp_spec((), torch.zeros(8, 8), fake)) == 0
    assert data_axis(fsdp_spec((), torch.zeros(7, 6), fake)) is None
    assert data_axis(fsdp_spec((), torch.zeros(()), fake)) is None


@pytest.mark.parametrize("n,data", [(8, 4), (5, 2), (7, 3), (3, 3)])
def test_shard_batch_row_blocks(n, data):
    """Contiguous blocks, the first n % data ranks one row longer; nested
    entries cut, 0-d and other-length entries kept whole; the blocks in
    order are the batch."""
    rng = np.random.default_rng(n)
    batch = {"src_tokens": rng.normal(size=(n, 4, 2)), "src_lengths": np.arange(n),
             "inject_use_prompt": np.asarray(True), "gumbel_temp": np.float32(0.5),
             "multitask": {"aux": {"target": torch.arange(n * 3).reshape(n, 3)}},
             "codebook": np.zeros((n + 1, 2))}
    blocks = [shard_batch(batch, Mesh(data=data, index=i)) for i in range(data)]
    sizes = [hi - lo for _, (_, lo, hi) in blocks]
    assert sizes == [n // data + (i < n % data) for i in range(data)]
    assert [b[1] for b in blocks] == [(n, *row_block(n, data, i)) for i in range(data)]
    np.testing.assert_array_equal(np.concatenate([b["src_tokens"] for b, _ in blocks]),
                                  batch["src_tokens"])
    assert torch.equal(torch.cat([b["multitask"]["aux"]["target"] for b, _ in blocks]),
                       batch["multitask"]["aux"]["target"])
    for b, _ in blocks:
        assert b["inject_use_prompt"] is batch["inject_use_prompt"]
        assert b["codebook"] is batch["codebook"]
    if n % data == 0:  # JAX's shard_batch: rank i's block is device i's
        mesh = jax_make_mesh(data=data, model=8 // data) if 8 % data == 0 else None
        if mesh is not None:
            x = jax.numpy.asarray(batch["src_tokens"])
            placed = jax.device_put(x, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("data")))
            rows = sorted({(idx[0].start or 0, idx[0].stop or n)
                           for idx in placed.sharding.devices_indices_map(x.shape).values()})
            assert rows == [row_block(n, data, i) for i in range(data)]


def test_shard_batch_needs_a_row_a_rank():
    with pytest.raises(ValueError, match="cannot split"):
        shard_batch({"x": np.zeros((2, 3))}, Mesh(data=3, index=2))


def test_outside_a_split_the_helpers_are_the_plain_ops():
    x = torch.arange(6.0).reshape(2, 3)
    assert pmesh.active_split() is None
    assert pmesh.global_sum(5) == 5
    assert torch.equal(pmesh.global_mean(x), x.mean())
    assert pmesh.all_reduce_grad(x) is x
    g = torch.Generator().manual_seed(0)
    want = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(pmesh.draw_rows(lambda n: torch.randn(n, 3, generator=g), 4), want)


def test_shard_optimizer_state_axis_matches_jax():
    """--zero-sharding os's axis of each state tensor: JAX places adam's
    state on its 8 CPU devices at data 4; the port's rule reads the same
    tree."""
    params = {"a": np.zeros((8, 3), np.float32), "b": np.zeros((3, 8), np.float32),
              "c": np.zeros((6,), np.float32), "d": np.zeros((5, 7), np.float32),
              "e": np.zeros((2, 12), np.float32)}
    state = optax.adam(1e-3).init(params)
    placed = jax_shard_optimizer_state(state, jax_make_mesh(data=4, model=2))
    fake = FakeMesh(4)
    want = [_norm(x.sharding.spec) if hasattr(x, "sharding") and x.ndim else ()
            for x in jax.tree_util.tree_leaves(placed)]
    mine = jax.tree_util.tree_leaves(
        shard_optimizer_state(jax.device_get(state), fake),
        is_leaf=lambda x: isinstance(x, tuple) and not hasattr(x, "_fields")
        and all(e is None or isinstance(e, str) for e in x))
    assert [_norm(s) for s in mine] == want
    assert [zero_axis(s, 4) for s in [(8, 3), (3, 8), (6,), (5, 7), (2, 12), ()]] == \
        [0, 1, None, None, 1, None]


BMUF_CASES = {
    "adam_nesterov": dict(optimizer="adam", lr_scheduler="inverse_sqrt", warmup_updates=3,
                          use_bmuf=True, global_sync_iter=STEPS // 2, block_momentum=0.8,
                          block_lr=0.7),
    "sgd_slowmo_plain": dict(optimizer="sgd", momentum=0.9, lr=1e-2, lr_scheduler="fixed",
                             ddp_backend="slowmo", global_sync_iter=STEPS // 2,
                             use_nbm=False),
}


@pytest.mark.parametrize("case", sorted(BMUF_CASES))
def test_bmuf_matches_jax(case):
    """2 x global_sync_iter updates through JAX's optimizers.bmuf and the
    port's Bmuf on shared weights and gradients: both syncs land alike."""
    cfg = dict(BMUF_CASES[case], lr=BMUF_CASES[case].get("lr", 1e-3))
    params, grads, model = _setup()
    want, _, _ = _run_jax(Config(**cfg), params, grads, 1.0)
    opt, _, _ = _run_port(cfg, model, grads, 1.0)
    _close(to_jax_params(model), want)
    assert opt.transform.step == STEPS


def test_bmuf_refuses_a_host_driven_schedule():
    cfg = {"optimizer": "adam", "lr_scheduler": "reduce_lr_on_plateau", "use_bmuf": True}
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="BMUF"):
        build_optimizer(cfg, build_lr_schedule(cfg), [p], ["w"])


def test_sharding_refuses_non_elementwise_optimizers():
    """lamb's trust ratio and adafactor's factored moments read whole
    parameters: --zero-sharding os and --fsdp refuse them."""
    model = torch.nn.Linear(4, 6)
    for opt in ("lamb", "adafactor"):
        for extra in ({"zero_sharding": "os"}, {"fsdp": True}):
            cfg = TrainerConfig(optimizer=opt, **extra)
            with pytest.raises(NotImplementedError, match="whole parameters"):
                Trainer(cfg, model, _MeanLoss(), mesh=Mesh(data=2, index=0, backend="gloo"))


class _MeanLoss:
    grad_accum = "mean_loss"
    data_parallel = True

    def __call__(self, model, batch, generator=None):
        loss = model(batch["src_tokens"]).square().mean()
        return loss, {"loss": loss, "sample_size": batch["src_tokens"].shape[0]}


def test_data_parallel_refuses_a_criterion_without_global_counts():
    class Local(_MeanLoss):
        data_parallel = False

    with pytest.raises(NotImplementedError, match="global batch"):
        Trainer(TrainerConfig(), torch.nn.Linear(4, 6), Local(),
                mesh=Mesh(data=2, index=0, backend="gloo"))


def test_one_rank_sharding_is_the_plain_update():
    """At one rank --zero-sharding os and --fsdp split nothing: the updates
    are the plain trainer's, bit for bit."""
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(3))
    out = []
    for extra in ({}, {"zero_sharding": "os"}, {"fsdp": True}):
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 6)
        trainer = Trainer(TrainerConfig(lr=1e-2, warmup_updates=1, **extra), model,
                          _MeanLoss())
        for _ in range(3):
            trainer.train_step([{"src_tokens": x}])
        out.append(torch.cat([p.detach().reshape(-1) for p in model.parameters()]))
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])


def test_cli_train_lists_and_checks_the_parallel_flags(tmp_path):
    text = train_cli.build_parser("x").format_help()
    for flag in ("--data-parallel", "--model-parallel", "--fsdp", "--ddp-backend",
                 "--zero-sharding", "--use-bmuf", "--global-sync-iter", "--block-momentum",
                 "--block-lr", "--use-nbm"):
        assert flag in text, flag
    base = ["--task", "dummy_vae", "--cpu", "--max-update", "1", "--save-dir",
            str(tmp_path / "ckpt")]
    with pytest.raises(NotImplementedError, match="8b"):
        train_cli.main(base + ["--model-parallel", "2"])
    with pytest.raises(ValueError, match="needs 2 processes"):
        train_cli.main(base + ["--data-parallel", "2"])
    args = train_cli.parse_args(base + ["--use-bmuf", "--use-nbm", "false",
                                        "--ddp-backend", "fully_sharded"])
    cfg = train_cli.trainer_config(args)
    assert cfg.fsdp and cfg.options["use_bmuf"] and cfg.options["use_nbm"] is False
