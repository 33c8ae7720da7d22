"""The normalizer's training remainder in the port: the continuous
`speech_diffusion` (diff_latent) and `speech_diffusion_hubert` (diff_hubert,
no VAE) tasks, `hubert_vae`, the `diffusion_transformer` architecture, the
trainer's other optimizers, schedules and EMA through cli.train, and the
`mean_loss_per_batch` accumulation. Against the JAX package on shared
weights and injected draws, in float32 on the CPU."""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.registry import CRITERIONS as JCRITERIONS
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.registry import _import_all
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
from diffnorm_tpu_torch.weights import from_jax_params
from tests.test_torch_train import CODES, FEAT, LATENT, _write_corpus
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

_import_all()
B, T = 2, 9
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4  # tests/test_torch_train.py's criterion and trajectory
WIDTHS = ["--feature-dim", str(FEAT), "--chan-mults", "[4]", "--vae-decoder-depth", "1",
          "--vae-decoder-dim-head", "8", "--vae-decoder-heads", "2", "--hidden-dim", "16",
          "--timesteps", "20", "--wavenet-layers", "2", "--wavenet-stacks", "1",
          "--denoiser-depth", "1"]
# task: (arch, criterion, the width flags)
STAGES = {
    "speech_diffusion": ("diff_latent", "ddpm_latent_loss", WIDTHS + ["--latent-dim", str(LATENT)]),
    "speech_diffusion_hubert": ("diff_hubert", "ddpm_latent_loss",
                                WIDTHS + ["--latent-dim", str(FEAT)]),
    "hubert_vae": ("speech_vae_decoder", "hubert_vae_loss",
                   WIDTHS[:10] + ["--latent-dim", str(LATENT), "--kl-beta", "0.01"]),
    "speech_diffusion_discrete": ("diffusion_transformer", "ddpm_discrete_loss",
                                  WIDTHS[:-6] + ["--latent-dim", str(LATENT)]),
}


def _args(task, extra=(), data="data"):
    arch, criterion, widths = STAGES[task]
    return train_cli.parse_args([data, "--tgt-feat-dir", "feat", "--task", task, "--arch", arch,
                                 "--criterion", criterion, "--target-code-size", str(CODES),
                                 "--max-update", "1", "--cpu", *widths, *extra])


def _jax_cfg(args):
    """JAX's config of the port's parsed arguments (the same widths)."""
    keys = ("feature_dim", "latent_dim", "chan_mults", "vae_decoder_depth",
            "vae_decoder_dim_head", "vae_decoder_heads", "hidden_dim", "timesteps",
            "wavenet_layers", "wavenet_stacks", "denoiser_depth", "kl_beta")
    given = {k: getattr(args, k) for k in keys if getattr(args, k) is not None}
    return Config(arch=args.arch, criterion=args.criterion, target_code_size=CODES, **given)


def _batch(latent, seed=1):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([T, T - 3], np.int32)
    mask = np.arange(T)[None, :] < lengths[:, None]
    batch = {"reduce_target": (rng.normal(size=(B, T, FEAT)) * mask[..., None]).astype(np.float32),
             "reduce_target_unit": np.where(mask, rng.integers(4, CODES + 4, size=(B, T)),
                                            0).astype(np.int32),
             "reduce_target_lengths": lengths,
             "posterior_noise": rng.normal(size=(B, T, LATENT)).astype(np.float32),
             "inject_times": np.asarray([3, 17], np.int32)}
    for key in ("enc_noise", "x1_noise", "q_noise"):
        batch[f"inject_{key}"] = rng.normal(size=(B, T, latent)).astype(np.float32)
    return batch


class _Injected:
    """A JAX model whose training forward takes the batch's injected draws
    (JAX's ddpm_latent_loss passes none)."""

    def __init__(self, model, batch):
        self.model, self.module = model, model.module
        self.draws = {k: batch[f"inject_{k}"] for k in ("times", "enc_noise", "x1_noise",
                                                        "q_noise")}

    def apply(self, variables, *args, **kw):
        return self.model.apply(variables, *args, **self.draws, **kw)


@pytest.mark.parametrize("task", sorted(STAGES))
def test_criterion_loss_and_gradient_norm_match_jax(task):
    """Each continuous task's criterion (and diffusion_transformer under the
    discrete one) on shared perturbed weights and injected draws,
    deterministic: the loss and every metric within 1e-5, the gradient norm
    over the trainable subtrees within 1e-4."""
    args = _args(task)
    if task == "speech_diffusion_discrete":  # the architecture's own widths, then 2 layers
        assert (args.wavenet_stacks, args.wavenet_layers, args.denoiser_depth) == (1, 1, 16)
        args = _args(task, ["--denoiser-depth", "2"])
    jtask = JTASKS.get(task).setup_task(_jax_cfg(args))
    jmodel, jcrit = jtask.build_model(), JCRITERIONS.get(args.criterion)(jtask.cfg, jtask)
    latent = FEAT if task == "speech_diffusion_hubert" else LATENT
    batch = _batch(latent)
    mask = np.arange(T)[None, :] < batch["reduce_target_lengths"][:, None]
    keys = dict(zip(("params", "dropout", "sample"), jax.random.split(jax.random.PRNGKey(0), 3)))
    variables = jax.jit(lambda r: jmodel.module.init(keys, batch["reduce_target"], mask, r,
                                                     deterministic=True))(keys["sample"])
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        variables["params"])
    frozen = jtask.frozen_param_keys
    wrapped = jmodel if task in ("hubert_vae", "speech_diffusion_discrete") else \
        _Injected(jmodel, batch)

    def loss_fn(trainable):
        loss, mets, _ = jcrit(wrapped, {"params": {**trainable, **{k: params[k] for k in frozen}}},
                              batch, jax.random.PRNGKey(3), train=False)
        return loss, mets

    trainable = {k: v for k, v in params.items() if k not in frozen}
    (ref_loss, ref_mets), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    ref_gnorm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))))

    port_task = TASKS[task](args)
    model = from_jax_params(port_task.build_model(), params).eval()
    if task.startswith("speech_diffusion"):
        assert (not hasattr(model, "vae")) == (task == "speech_diffusion_hubert")
    assert port_task.frozen_param_keys == frozen
    loss, mets = port_task.build_criterion()(model, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
    assert set(mets) == set(ref_mets)
    for k, v in ref_mets.items():
        np.testing.assert_allclose(float(mets[k]), float(v), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    trained = [p for n, p in model.named_parameters() if n.split(".")[0] not in frozen]
    grads = torch.autograd.grad(loss, trained, allow_unused=True)
    gnorm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads if g is not None]))
    np.testing.assert_allclose(float(gnorm), ref_gnorm, rtol=GNORM_RTOL)


def test_mean_loss_per_batch_divides_by_the_micro_batch_count():
    """grad_accum "mean_loss_per_batch" (JAX trainer.py:303-308): the summed
    micro-batch gradients over their count, not over the sample sizes."""
    args = _args("speech_diffusion_hubert", ["--dropout", "0"])
    task = TASKS["speech_diffusion_hubert"](args)
    torch.manual_seed(0)
    batches = [_batch(FEAT, seed) for seed in (4, 5)]
    batches[1] = {k: v[:1] for k, v in batches[1].items()}  # sample sizes 2 and 1

    class PerBatch:
        grad_accum = "mean_loss_per_batch"

        def __init__(self):
            self.inner = task.build_criterion()

        def __call__(self, model, batch, generator=None):
            return self.inner(model, batch, generator)

    models = [task.build_model() for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    cfg = TrainerConfig(optimizer="sgd", lr_scheduler="fixed", lr=0.1, clip_norm=0.0,
                        warmup_updates=None, warmup_init_lr=None)
    trainer = Trainer(cfg, models[0], PerBatch())
    before = [p.detach().clone() for p in models[1].parameters()]
    trainer.train_step(batches)
    crit = task.build_criterion()
    grads = None
    for b in batches:
        loss, _ = crit(models[1], {k: torch.from_numpy(v) for k, v in b.items()})
        g = torch.autograd.grad(loss, list(models[1].parameters()))
        grads = g if grads is None else [a + c for a, c in zip(grads, g)]
    for p, p0, g in zip(models[0].parameters(), before, grads):
        torch.testing.assert_close(p.detach(), p0 - 0.1 * g / 2, rtol=1e-5, atol=1e-7)


def _inject_draws(batch, latent):
    """Times and noises for a batch, drawn from a generator seeded by its
    ids (the same in both CLIs whatever order they prepare batches in)."""
    rng = np.random.default_rng(int(np.asarray(batch["id"]).sum()) * 131 + len(batch["id"]))
    b, t = batch["reduce_target"].shape[:2]
    batch["inject_times"] = rng.integers(1, 20, size=b).astype(np.int32)
    for key in ("enc_noise", "x1_noise", "q_noise"):
        batch[f"inject_{key}"] = rng.normal(size=(b, t, latent)).astype(np.float32)
    return batch


def test_cli_train_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """cli.train --task speech_diffusion_hubert --optimizer adamax
    --lr-scheduler cosine --ema-decay 0.99 (--log-format json) against JAX's
    cli.train with the same flags, from the same initial weights and with
    each batch's draws injected into both, deterministic: the loss, gradient
    norm and lr of every update (one batch an epoch: one JAX compile)."""
    from diffnorm_tpu.cli import train as jtrain_cli
    from diffnorm_tpu.cli.args import parse_args as jparse_args
    from diffnorm_tpu.criterions.ddpm_loss import DDPMLatentLoss as JLatentLoss
    from diffnorm_tpu.tasks.diffusion_task import SpeechDiffusionHubertTask as JTask
    from diffnorm_tpu.train.trainer import Trainer as JTrainer
    from diffnorm_tpu_torch.tasks.diffusion_task import SpeechDiffusionHubertTask

    feat_dir = _write_corpus(tmp_path, n=6)
    arch, criterion, widths = STAGES["speech_diffusion_hubert"]
    flags = [str(tmp_path), "--tgt-feat-dir", str(feat_dir), "--task", "speech_diffusion_hubert",
             "--arch", arch, "--criterion", criterion, "--target-code-size", str(CODES),
             *widths, "--optimizer", "adamax", "--adamax-betas", "(0.9,0.98)",
             "--weight-decay", "0.01", "--lr-scheduler", "cosine", "--lr", "2e-3",
             "--warmup-updates", "2", "--min-lr", "1e-5", "--ema-decay", "0.99",
             "--clip-norm", "1.0", "--max-update", "4", "--max-tokens", "1000", "--seed", "42",
             "--log-interval", "1", "--save-interval", "4", "--cpu", "--dropout", "0.0"]
    jtask = JTask(jparse_args(flags))
    example = _inject_draws(jtask.dataset("train").collater([jtask.dataset("train")[0]]), FEAT)
    jmodel = jtask.build_model()
    mask = np.arange(example["reduce_target"].shape[1])[None] < \
        example["reduce_target_lengths"][:, None]
    keys = dict(zip(("params", "dropout"), jax.random.split(jax.random.PRNGKey(0))))
    init = jax.jit(lambda r: jmodel.module.init(keys, example["reduce_target"], mask, r,
                                                deterministic=True))(keys["dropout"])
    rng = np.random.default_rng(7)
    shared = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        init["params"])
    seen = {"port": [], "jax": []}
    port_step, jax_step = Trainer.train_step, JTrainer.train_step
    port_build = SpeechDiffusionHubertTask.build_model
    jcall = JLatentLoss.__call__

    def record_port(self, batches):
        out = port_step(self, batches)
        seen["port"].append(out)
        return out

    def record_jax(self, state, batches, rng):
        state, out = jax_step(self, state, batches, rng)
        seen["jax"].append(out)
        return state, out

    def jax_loss(self, model, variables, batch, rng, train=True):
        # JAX's denoiser keeps attention dropout 0.1 whatever --dropout says,
        # and its ddpm_latent_loss takes no injected draws: deterministic,
        # with the batch's draws, as the port runs at --dropout 0
        return jcall(self, _Injected(model, batch), variables, batch, rng, False)

    monkeypatch.setattr(Trainer, "train_step", record_port)
    monkeypatch.setattr(JTrainer, "train_step", record_jax)
    monkeypatch.setattr(SpeechDiffusionHubertTask, "build_model",
                        lambda self: from_jax_params(port_build(self), shared))
    monkeypatch.setattr(JTask, "init_variables", lambda self, model, r, b: {"params": shared})
    monkeypatch.setattr(JLatentLoss, "__call__", jax_loss)
    for cls in (SpeechDiffusionHubertTask, JTask):
        monkeypatch.setattr(cls, "prepare_batch",
                            lambda self, batch, np_rng: _inject_draws(batch, FEAT))
    capsys.readouterr()
    assert train_cli.main(flags + ["--save-dir", str(tmp_path / "port"), "--log-format",
                                   "json"]) == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [p["step"] for p in printed] == [1, 2, 3, 4]
    assert jtrain_cli.main(jparse_args(flags + ["--save-dir", str(tmp_path / "jax")])) == 0
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for mine, theirs in zip(seen["port"], seen["jax"]):
        np.testing.assert_allclose(mine["loss"], theirs["loss"], rtol=GNORM_RTOL)
        np.testing.assert_allclose(mine["gnorm"], theirs["gnorm"], rtol=GNORM_RTOL)
        # JAX computes the schedule in float32
        np.testing.assert_allclose(mine["lr"], theirs["lr"], rtol=1e-6, atol=2e-9)
    assert len({round(m["lr"], 9) for m in seen["port"]}) == 4
    state = torch.load(tmp_path / "port" / "step_000000004" / "trainer.pt")
    assert state["ema"]["decay"] == 0.99 and state["optimizer"]["count"] == 4


def _ckpt(save_dir, step):
    path = save_dir / f"step_{step:09d}"
    return (torch.load(path / "trainer.pt"), np.load(path / "params.npz"),
            json.loads((save_dir / f"step_{step:09d}.json").read_text()))


def test_restore_file_with_ema_and_plateau_equals_an_uninterrupted_run(tmp_path, capsys):
    """speech_diffusion_hubert with reduce_lr_on_plateau (each epoch's
    validation loss) and an EMA: 4 updates straight, and 2 then
    --restore-file for 2 more in another directory, end equal bit for bit:
    weights, EMA, optimizer moments, and the schedule's state."""
    feat_dir = _write_corpus(tmp_path, n=4)
    arch, criterion, widths = STAGES["speech_diffusion_hubert"]

    def run(save_dir, max_update, extra=()):
        assert train_cli.main([str(tmp_path), "--tgt-feat-dir", str(feat_dir), "--task",
                               "speech_diffusion_hubert", "--arch", arch, "--criterion",
                               criterion, "--target-code-size", str(CODES), *widths, "--cpu",
                               "--optimizer", "adam", "--lr-scheduler", "reduce_lr_on_plateau",
                               "--lr", "5e-3", "--lr-shrink", "0.5", "--lr-patience", "0",
                               "--lr-threshold", "0.5", "--ema-decay", "0.9", "--max-tokens",
                               "1000", "--max-update", str(max_update), "--seed", "3",
                               "--log-interval", "1", "--save-dir", str(save_dir),
                               *extra]) == 0

    run(tmp_path / "straight", 4)
    run(tmp_path / "first", 2)
    run(tmp_path / "resumed", 4, ["--restore-file", str(tmp_path / "first" / "step_000000002")])
    log = capsys.readouterr().err
    assert "restored" in log and len(re.findall(r"valid \|", log)) == 8
    (s1, p1, j1), (s2, p2, j2) = _ckpt(tmp_path / "straight", 4), _ckpt(tmp_path / "resumed", 4)
    assert sorted(p1.files) == sorted(p2.files) and "params/denoiser/final_proj/kernel" in p1.files
    assert not any(k.startswith("params/vae/") for k in p1.files)
    for k in p1.files:
        np.testing.assert_array_equal(p1[k], p2[k], err_msg=k)
    for a, b in zip(s1["ema"]["params"], s2["ema"]["params"]):
        assert torch.equal(a, b)
    for a, b in zip(s1["optimizer"]["transform"]["chain"][1]["chain"][0]["exp_avg_sq"],
                    s2["optimizer"]["transform"]["chain"][1]["chain"][0]["exp_avg_sq"]):
        assert torch.equal(a, b)
    assert j1["lr_scheduler"] == j2["lr_scheduler"] and j1["lr_scheduler"]["lr"] < 5e-3
