"""A JAX TrainState's optimizer state across the bridge
(scripts/orbax_to_npz.py -> train/checkpoint.py:load_optax_state ->
train/optax_bridge.py) against the JAX package on the CPU: JAX trains 3
updates and saves with its own CheckpointManager (orbax), the bridge
writes the step directory, the port resumes it for 2 updates, and the
result equals JAX's 5 within 1e-5 of each leaf's scale. Through cli.train
for fairseq Adam with an EMA and a loss scale; in-process for every other
optimizer the port has, composite groups and freeze_finetune's count. A
state of another chain is refused."""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from diffnorm_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from diffnorm_tpu.train.checkpoint import load_checkpoint_params
from diffnorm_tpu.train.lr_schedules import build_lr_schedule as jbuild_lr_schedule
from diffnorm_tpu.train.optimizers import build_optimizer as jbuild_optimizer
from diffnorm_tpu.train.trainer import TrainState
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.models.layers import CausalConv1d, Dense
from diffnorm_tpu_torch.tasks.diffusion_task import SpeechDiffusionHubertTask
from diffnorm_tpu_torch.train import optax_bridge
from diffnorm_tpu_torch.train.checkpoint import load_optax_state, load_params
from diffnorm_tpu_torch.train.lr_schedules import build_lr_schedule
from diffnorm_tpu_torch.train.optimizers import build_optimizer
from diffnorm_tpu_torch.weights import jax_param_path, leaf_to_torch, to_jax_params
from tests.test_torch_continuous_tasks import STAGES, _inject_draws, _Injected
from tests.test_torch_train import CODES, FEAT, _write_corpus
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
# float32 on both sides, the same update rules in other orders: measured
# within 4.2e-7 of each leaf's scale in-process, 2.2e-6 through cli.train
# (its EMA 1.7e-6)
TOL = 1e-5


def _bridge(ckpt, out):
    spec = importlib.util.spec_from_file_location("orbax_to_npz", REPO / "scripts" / "orbax_to_npz.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.main([str(ckpt), str(out)]) == 0


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _assert_close(got, want, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k, ref in want.items():
        scale = max(np.abs(ref).max(), 1e-3)
        assert np.abs(got[k] - ref).max() <= TOL * scale, f"{what} {k}"


# ---- through cli.train: adam with an EMA and a loss scale ----

def test_cli_resumes_a_jax_run_with_its_optimizer_state(tmp_path, monkeypatch, capsys):
    """speech_diffusion_hubert, fairseq Adam, --ema-decay, --loss-scale,
    dropout 0 and each batch's draws injected in both: JAX's cli.train for
    5 updates (its step-3 checkpoint bridged), the port's cli.train
    --restore-file on the bridged step 3 without --reset-optimizer for 2:
    the weights and the EMA equal JAX's step 5; another --optimizer is
    refused; the generators are seeded from --seed, as logged."""
    from diffnorm_tpu.cli import train as jtrain_cli
    from diffnorm_tpu.cli.args import parse_args as jparse_args
    from diffnorm_tpu.criterions.ddpm_loss import DDPMLatentLoss as JLatentLoss
    from diffnorm_tpu.tasks.diffusion_task import SpeechDiffusionHubertTask as JTask

    feat_dir = _write_corpus(tmp_path, n=6)
    arch, criterion, widths = STAGES["speech_diffusion_hubert"]
    flags = [str(tmp_path), "--tgt-feat-dir", str(feat_dir), "--task", "speech_diffusion_hubert",
             "--arch", arch, "--criterion", criterion, "--target-code-size", str(CODES),
             *widths, "--optimizer", "adam", "--weight-decay", "0.01", "--lr", "2e-3",
             "--warmup-updates", "2", "--ema-decay", "0.9", "--loss-scale", "8",
             "--clip-norm", "1.0", "--max-tokens", "1000", "--seed", "42",
             "--log-interval", "1", "--cpu", "--dropout", "0.0", "--keep-last-epochs", "10"]
    jcall = JLatentLoss.__call__
    monkeypatch.setattr(JLatentLoss, "__call__", lambda self, model, variables, batch, rng,
                        train=True: jcall(self, _Injected(model, batch), variables, batch,
                                          rng, False))
    for cls in (SpeechDiffusionHubertTask, JTask):
        monkeypatch.setattr(cls, "prepare_batch",
                            lambda self, batch, np_rng: _inject_draws(batch, FEAT))
    assert jtrain_cli.main(jparse_args(flags + ["--max-update", "5",
                                                "--save-dir", str(tmp_path / "jax")])) == 0
    _bridge(tmp_path / "jax" / "step_000000003", tmp_path / "bridged")
    bridged = load_optax_state(str(tmp_path / "bridged"))
    assert bridged["step"] == 3 and bridged["ema_params"] is not None
    assert json.loads((tmp_path / "bridged.json").read_text())["epoch"] == 4

    capsys.readouterr()
    assert train_cli.main(flags + ["--max-update", "5", "--save-dir", str(tmp_path / "port"),
                                   "--restore-file", str(tmp_path / "bridged")]) == 0
    log = capsys.readouterr().err
    assert "loaded the JAX optimizer state" in log and "seeded from --seed 42" in log
    assert "epoch 4 | step 4 |" in log and "epoch 5 | step 5 |" in log
    want = load_checkpoint_params(str(tmp_path / "jax" / "step_000000005"))
    _assert_close(load_params(str(tmp_path / "port" / "step_000000005")),
                  jax.device_get(want["params"]), "params")
    state = torch.load(tmp_path / "port" / "step_000000005" / "trainer.pt")
    assert state["num_updates"] == 5 and state["optimizer"]["count"] == 5
    model = SpeechDiffusionHubertTask(train_cli.parse_args(flags + ["--max-update", "5"]))
    model = model.build_model()
    with torch.no_grad():
        trained = [p for p in model.parameters() if p.requires_grad]
        for p, e in zip(trained, state["ema"]["params"]):
            p.copy_(e)
    _assert_close(to_jax_params(model), jax.device_get(want["ema_params"]), "ema")

    with pytest.raises(optax_bridge.Refused, match="chain"):
        train_cli.main(flags + ["--max-update", "5", "--optimizer", "lamb", "--save-dir",
                                str(tmp_path / "refused"), "--restore-file",
                                str(tmp_path / "bridged")])


# ---- in-process: every other optimizer ----

class Tiny(nn.Module):
    """Parameters of each layout the bridge converts: a Dense kernel large
    enough for adafactor's factored moments, a conv kernel, biases."""

    def __init__(self):
        super().__init__()
        self.dense = Dense(130, 160)
        self.conv = CausalConv1d(4, 6, 3)


OPTIMIZERS = {
    "adamax": dict(optimizer="adamax", weight_decay=0.01),
    "adadelta": dict(optimizer="adadelta", lr=1.0),
    "adadelta_wd": dict(optimizer="adadelta", lr=1.0, weight_decay=0.01),
    "lamb": dict(optimizer="lamb", weight_decay=0.01),
    "nag": dict(optimizer="nag", momentum=0.9),
    "adafactor": dict(optimizer="adafactor"),
    "adagrad": dict(optimizer="adagrad", initial_accumulator_value=0.1),
    "sgd": dict(optimizer="sgd"),
    "sgd_nesterov": dict(optimizer="sgd", momentum=0.9, nesterov=True),
    "composite_freeze": dict(optimizer="composite", composite_groups={"conv": "sgd"},
                             composite_default="adam", freeze_finetune_updates=4,
                             freeze_finetune_subtrees=("conv",)),
}


def _jax_run(cfg, params, grads, n, save_at, ckpt_dir):
    """n JAX updates of build_optimizer's chain over `params` (clipping at
    1.0, loss scale 2); the TrainState after `save_at` saved by JAX's
    CheckpointManager. Returns the final params."""
    schedule = jbuild_lr_schedule(cfg)
    tx = jbuild_optimizer(cfg, schedule, clip_norm=1.0)
    state = tx.init(params)
    for step in range(n):
        updates, state = tx.update(grads[step], state, params)
        params = optax.apply_updates(params, updates)
        if step + 1 == save_at:
            manager = JCheckpointManager(str(ckpt_dir))
            manager.save(save_at, TrainState(step=jnp.asarray(save_at, jnp.int32), params=params,
                                             frozen_params={}, model_state={},
                                             opt_state=state), blocking=True)
    return jax.device_get(params)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_every_optimizer_continues_across_the_bridge(name, tmp_path):
    """3 JAX updates, saved and bridged, then 2 of the port's transforms
    loaded with the state, equal JAX's 5 updates on the same gradients."""
    cfg = {"lr": 0.05, "lr_scheduler": "inverse_sqrt", "warmup_updates": 2,
           "warmup_init_lr": 1e-3, "adam_betas": (0.9, 0.98), "loss_scale": 2.0,
           **OPTIMIZERS[name]}
    torch.manual_seed(0)
    model = Tiny()
    names = [n for n, _ in model.named_parameters()]
    params0 = to_jax_params(model)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                    params0) for _ in range(5)]
    want = _jax_run(cfg, params0, grads, 5, 3, tmp_path / "jax")
    at3 = load_checkpoint_params(str(tmp_path / "jax" / "step_000000003"))["params"]
    _bridge(tmp_path / "jax" / "step_000000003", tmp_path / "bridged")

    with torch.no_grad():
        for n, p in model.named_parameters():
            path, kernel = jax_param_path(model, n)
            p.copy_(leaf_to_torch(_get(at3, path), kernel))
    opt = build_optimizer(cfg, build_lr_schedule(cfg), list(model.parameters()), names,
                          clip_norm=1.0)
    paths = [jax_param_path(model, n) for n in names]
    bridged = load_optax_state(str(tmp_path / "bridged"))
    optax_bridge.load_transform(opt.transform, bridged["opt_state"], optax_bridge.ParamPaths(
        [p for p, _ in paths], [k for _, k in paths]))
    opt.count = bridged["step"]
    for step in (3, 4):
        opt.step([leaf_to_torch(_get(grads[step], path), kernel) for path, kernel in paths])
    _assert_close(to_jax_params(model), want, name)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_a_state_of_another_chain_is_refused(tmp_path):
    """Adam's state into lamb's chain, into a chain without clipping's
    slot, and composite groups of other labels: each refused by name."""
    torch.manual_seed(0)
    model = Tiny()
    names = [n for n, _ in model.named_parameters()]
    params0 = to_jax_params(model)
    grads = [jax.tree_util.tree_map(np.ones_like, params0)] * 2
    cfg = {"lr": 0.05, "lr_scheduler": "fixed", "optimizer": "adam"}
    _jax_run(cfg, params0, grads, 2, 2, tmp_path / "jax")
    _bridge(tmp_path / "jax" / "step_000000002", tmp_path / "bridged")
    tree = load_optax_state(str(tmp_path / "bridged"))["opt_state"]
    paths = [jax_param_path(model, n) for n in names]
    pp = optax_bridge.ParamPaths([p for p, _ in paths], [k for _, k in paths])
    for other, clip, match in (({"optimizer": "lamb"}, 1.0, "chain of 4"),
                               ({}, 0.0, "chain of 1"),
                               ({"optimizer": "composite", "composite_groups": {"conv": "sgd"}},
                                1.0, "composite|inner_states")):
        opt = build_optimizer({**cfg, **other}, build_lr_schedule(cfg),
                              list(model.parameters()), names, clip_norm=clip)
        with pytest.raises(optax_bridge.Refused, match=match):
            optax_bridge.load_transform(opt.transform, tree, pp)
