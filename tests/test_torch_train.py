"""The port's main-path training (diffnorm_tpu_torch/{criterions,train,tasks,
data,cli/train.py}) against the JAX package on the CPU: the two criterions
on shared weights and injected draws, 12-update float32 trajectories of both
stages against the JAX Trainer, the frozen VAE, resume, the batching, the
optimizer and schedule, and the CLI chain VAE -> normalizer ->
diff_norm_synthesis."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config, make_trainer_config
from diffnorm_tpu.criterions.ddpm_loss import DDPMDiscreteLoss as JDDPMLoss
from diffnorm_tpu.criterions.vae_loss import SpeechVAELoss as JVAELoss
from diffnorm_tpu.data.batching import _batch_by_size_py as jax_batch_by_size
from diffnorm_tpu.data.dictionary import Dictionary as JDictionary
from diffnorm_tpu.data.repr_unit_dataset import ReprToReprUnitDataset as JDataset
from diffnorm_tpu.parallel.mesh import make_mesh
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.train.lr_schedules import inverse_sqrt as jax_inverse_sqrt
from diffnorm_tpu.train.optimizers import scale_by_fairseq_adam
from diffnorm_tpu.train.trainer import Trainer as JTrainer
from diffnorm_tpu_torch.cli import diff_norm_synthesis
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
from diffnorm_tpu_torch.criterions.vae_loss import SpeechVAELoss
from diffnorm_tpu_torch.data.batching import batch_by_size
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.data.repr_unit_dataset import ReprToReprUnitDataset
from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, safe_div
from diffnorm_tpu_torch.models.layers import set_dropout_generator
from diffnorm_tpu_torch.models.vae import SpeechVAEModule
from diffnorm_tpu_torch.train.checkpoint import CheckpointManager, load_params
from diffnorm_tpu_torch.train.lr_schedules import inverse_sqrt
from diffnorm_tpu_torch.train.optimizers import build_optimizer
from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
from diffnorm_tpu_torch.weights import from_jax_params, from_jax_variables, to_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

B, T, FEAT, LATENT, CODES = 2, 9, 24, 3, 16
VAE = dict(feature_dim=FEAT, latent_dim=LATENT, chan_mults=[4], vae_decoder_depth=1,
           vae_decoder_dim_head=8, vae_decoder_heads=2, target_code_size=CODES)
DIFF = dict(VAE, hidden_dim=16, timesteps=50, denoiser_depth=1, wavenet_layers=2,
            wavenet_stacks=1)
N_UPDATES, UPDATE_FREQ, CLIP = 12, 2, 2.0
LR, WARMUP, WARMUP_INIT, BETAS, EPS = 5e-4, 4, 1e-7, (0.9, 0.98), 1e-8
# measured on the CPU: losses agree within 5e-7 relative, gradient norms
# within 9e-6 (the normalizer's; the VAE's 5e-7)
TRAJ_RTOL, PARAM_TOL = 1e-4, 1e-4


def _port_vae() -> SpeechVAEModule:
    return SpeechVAEModule(FEAT, LATENT, CODES + 4, 1, 8, 2, [4])


def _port_diffusion(**kw) -> LatentDiffusionModule:
    return LatentDiffusionModule(
        dim=DIFF["hidden_dim"], latent_dim=LATENT, feature_dim=FEAT, vocab_size=CODES + 4,
        timesteps=DIFF["timesteps"], denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1,
        vae_decoder_depth=1, vae_decoder_dim_head=8, vae_decoder_heads=2, chan_mults=[4],
        **kw)


def _micro_batches(rng, stage: str, n: int):
    """n micro-batches (4 distinct contents, cycled) with ragged lengths, the
    0-padded unit convention, and fresh injected draws for each."""
    base = []
    for _ in range(4):
        lengths = np.sort(rng.integers(T // 2, T + 1, size=B))[::-1].astype(np.int32)
        mask = np.arange(T)[None, :] < lengths[:, None]
        feat = rng.normal(size=(B, T, FEAT)).astype(np.float32) * mask[..., None]
        units = np.where(mask, rng.integers(4, CODES + 4, size=(B, T)), 0).astype(np.int32)
        base.append({"reduce_target": feat, "reduce_target_unit": units,
                     "reduce_target_lengths": lengths})
    out = []
    for k in range(n):
        b = dict(base[k % 4])
        if stage == "vae":
            b["posterior_noise"] = rng.normal(size=(B, T, LATENT)).astype(np.float32)
        else:
            b["inject_times"] = rng.integers(1, DIFF["timesteps"], size=B).astype(np.int32)
            for key in ("enc_noise", "x1_noise", "q_noise"):
                b[f"inject_{key}"] = rng.normal(size=(B, T, LATENT)).astype(np.float32)
        out.append(b)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class _Deterministic:
    """A JAX criterion called with train=False (no dropout), as
    tests/test_train_trajectory_parity.py does; the port runs dropout 0."""

    def __init__(self, inner):
        self.inner, self.grad_accum = inner, inner.grad_accum

    def __call__(self, model, variables, batch, rng, train=True):
        return self.inner(model, variables, batch, rng, train=False)


def _jax_stage(stage: str):
    """(JAX task, model, trainer config) of one stage at the test's sizes."""
    common = dict(lr=LR, lr_scheduler="inverse_sqrt", warmup_updates=WARMUP,
                  warmup_init_lr=WARMUP_INIT, adam_betas=BETAS, adam_eps=EPS,
                  clip_norm=CLIP, update_freq=UPDATE_FREQ)
    if stage == "vae":
        cfg = Config(arch="speech_vae_decoder", criterion="speech_vae_decoder_loss",
                     **VAE, **common)
        task = JTASKS.get("dummy_vae").setup_task(cfg)
    else:
        cfg = Config(arch="diff_discrete", criterion="ddpm_discrete_loss", **DIFF, **common)
        task = JTASKS.get("speech_diffusion_discrete").setup_task(cfg)
    return cfg, task, task.build_model()


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("stage", ["vae", "ddpm"])
def test_criterions_match_jax(stage):
    """Loss and every metric at 1e-5 relative on shared weights and injected
    draws (float32, deterministic)."""
    cfg, task, jmodel = _jax_stage(stage)
    batch = _micro_batches(np.random.default_rng(1), stage, 1)[0]
    variables = task.init_variables(jmodel, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)
        * (a.ndim == 1), variables["params"])
    jcrit = JVAELoss(cfg, task) if stage == "vae" else JDDPMLoss(cfg, task)
    ref_loss, ref_mets, _ = jcrit(jmodel, {"params": params}, batch, jax.random.PRNGKey(0),
                                  train=False)
    model = from_jax_params(_port_vae() if stage == "vae" else _port_diffusion(), params)
    crit = SpeechVAELoss() if stage == "vae" else DDPMDiscreteLoss()
    with torch.no_grad():
        loss, mets = crit(model.eval(), _torch_batch(batch))
    assert set(mets) == set(ref_mets)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for k, v in ref_mets.items():
        np.testing.assert_allclose(float(mets[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)


def _trainer_cfg(dtype="float32", seed=1):
    return TrainerConfig(lr=LR, warmup_updates=WARMUP, warmup_init_lr=WARMUP_INIT,
                         adam_betas=BETAS, adam_eps=EPS, clip_norm=CLIP, dtype=dtype,
                         seed=seed)


@pytest.fixture
def default_threads(torch_threads_per_worker):
    """torch's default intra-op thread count for the test: the 12 updates'
    final parameters were measured against JAX at it (the thread count
    splits torch's float32 reductions; tests/torch_threads.py sets fewer
    under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(torch_threads_per_worker)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stage", ["vae", "ddpm"])
def test_trajectory_matches_jax_trainer(default_threads, stage):
    """12 float32 updates of update_freq 2 (clip 2.0, lr 5e-4, inverse_sqrt
    warmup 4 from 1e-7, betas (0.9, 0.98), dropout 0, draws injected) on
    both trainers from one initialization: per-update loss and gradient
    norm within 1e-4 relative, the final parameters within 1e-4 of each
    leaf's scale, and (normalizer) the frozen VAE bit-unchanged."""
    cfg, task, jmodel = _jax_stage(stage)
    micros = _micro_batches(np.random.default_rng(7), stage, N_UPDATES * UPDATE_FREQ)
    jcrit = _Deterministic(JVAELoss(cfg, task) if stage == "vae" else JDDPMLoss(cfg, task))
    jtrainer = JTrainer(make_trainer_config(cfg), task, jmodel, jcrit,
                        mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    state = jtrainer.init_state(jax.random.PRNGKey(0), micros[0])
    init = {**jax.device_get(state.params), **jax.device_get(state.frozen_params)}

    model = from_jax_params(_port_vae() if stage == "vae" else _port_diffusion(), init)
    frozen = ("vae",) if stage == "ddpm" else ()
    trainer = Trainer(_trainer_cfg(), model,
                      SpeechVAELoss() if stage == "vae" else DDPMDiscreteLoss(), frozen)
    vae_before = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("vae.")}

    ref_loss, ref_gnorm, loss, gnorm = [], [], [], []
    for u in range(N_UPDATES):
        chunk = micros[u * UPDATE_FREQ:(u + 1) * UPDATE_FREQ]
        state, ref = jtrainer.train_step(state, chunk, jax.random.PRNGKey(u))
        got = trainer.train_step(chunk)
        ref_loss.append(ref["loss"])
        ref_gnorm.append(ref["gnorm"])
        loss.append(got["loss"])
        gnorm.append(got["gnorm"])
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-6)
    np.testing.assert_allclose(loss, ref_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(gnorm, ref_gnorm, rtol=TRAJ_RTOL)
    assert gnorm[0] > CLIP  # the clip is exercised

    want = _flat(jax.device_get(state.params))
    got = {k: v for k, v in _flat(to_jax_params(model)).items()
           if not (stage == "ddpm" and k.startswith("vae/"))}
    assert set(got) == set(want)
    moved = 0
    for k, ref in want.items():
        scale = max(np.abs(ref).max(), 1e-3)
        assert np.abs(got[k] - ref).max() <= PARAM_TOL * scale, k
        moved += not np.array_equal(ref, _flat(init)[k])
    assert moved == len(want)
    for k, v in vae_before.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_normalizer_decodes_x1_hat_through_a_deterministic_vae():
    """At dropout 0.1 in a training forward, the denoiser drops attention
    probabilities but x1_hat goes through the frozen VAE without dropout,
    as JAX's vae.decode (deterministic=True) does: recon_feature and
    lm_logits are bit-equal to the VAE's eval-mode decode of the same
    x1_hat and agree with JAX's decode at 1e-5."""
    cfg, task, jmodel = _jax_stage("ddpm")
    batch = _micro_batches(np.random.default_rng(4), "ddpm", 1)[0]
    params = task.init_variables(jmodel, jax.random.PRNGKey(0), batch)["params"]
    model = from_jax_params(_port_diffusion(dropout=0.1), params).train()
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    tb = _torch_batch(batch)
    feat = tb["reduce_target"]
    mask = torch.arange(T)[None, :] < tb["reduce_target_lengths"][:, None]
    draws = {k: tb[f"inject_{k}"] for k in ("times", "enc_noise", "x1_noise", "q_noise")}
    with torch.no_grad():
        out = model(feat, mask, **draws)
        again = model(feat, mask, **draws)
        assert not torch.equal(out["pred_noise"], again["pred_noise"])  # denoiser dropout on
        sched, times = model.schedule, draws["times"].long()
        z = model.encode(feat, noise=draws["enc_noise"])
        sac = sched.extract("sqrt_alphas_cumprod", times, 3)
        s1mac = sched.extract("sqrt_one_minus_alphas_cumprod", times, 3)
        x_t = sac * (z + draws["x1_noise"] * float(sched.betas[0])) + s1mac * draws["q_noise"]
        x1_hat = safe_div(x_t - s1mac * out["pred_noise"], sac)
        recon, logits = model.vae.eval().decode(x1_hat, mask)
    assert torch.equal(out["recon_feature"], recon)
    assert torch.equal(out["lm_logits"], logits)
    ref_recon, ref_logits = jmodel.module.apply(
        {"params": params}, jnp.asarray(x1_hat.numpy()), jnp.asarray(mask.numpy()),
        method=lambda m, x, mk: m.decode(x, mk))
    np.testing.assert_allclose(recon.numpy(), np.asarray(ref_recon), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-5)


def test_bf16_training_keeps_float32_masters_and_the_vae_frozen():
    """--dtype bfloat16: the forward runs on a bf16 working copy, the
    masters stay float32 and take the updates, the working copy follows
    them (its WaveNet packs too), and the frozen VAE does not move in
    either copy."""
    torch.manual_seed(0)
    model = _port_diffusion(dropout=0.1)
    trainer = Trainer(_trainer_cfg("bfloat16"), model, DDPMDiscreteLoss(), ("vae",))
    assert trainer.model is not model
    assert next(trainer.model.parameters()).dtype == torch.bfloat16
    vae_before = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("vae.")}
    work_vae_before = {k: v.clone() for k, v in trainer.model.state_dict().items()
                       if k.startswith("vae.")}
    den_before = {k: v.clone() for k, v in model.state_dict().items()
                  if k.startswith("denoiser.")}
    micros = _micro_batches(np.random.default_rng(3), "ddpm", 4)
    for u in range(2):
        batch = {k: v for k, v in micros[u].items() if not k.startswith("inject_")}
        mets = trainer.train_step([batch, batch])  # draws and dropout from the generator
        assert np.isfinite(mets["loss"]) and np.isfinite(mets["gnorm"])
    for k, v in vae_before.items():
        assert torch.equal(model.state_dict()[k], v)
    for k, v in work_vae_before.items():
        assert torch.equal(trainer.model.state_dict()[k], v)
    for k, v in den_before.items():
        assert model.state_dict()[k].dtype == torch.float32
        assert not torch.equal(model.state_dict()[k], v), k
    for (n, m), (_, w) in zip(model.named_parameters(), trainer.model.named_parameters()):
        assert torch.equal(w, m.to(torch.bfloat16)), n
    wavenet = trainer.model.denoiser.wavenet
    with torch.no_grad():
        cached = wavenet.packs()
        wavenet.pack_weights()
        for a, b in zip(cached, wavenet.packs()):
            for name in a:
                assert torch.equal(a[name], b[name])


def test_resume_is_bit_equal(tmp_path):
    """6 updates, a checkpoint, a fresh trainer resumed from it, 6 more: the
    same losses, gradient norms and parameters, bit for bit, as 12 updates
    in one run (draws and dropout 0.1 from the trainer's generator)."""
    micros = [{k: v for k, v in b.items() if not k.startswith("inject_")}
              for b in _micro_batches(np.random.default_rng(5), "ddpm", 24)]

    def fresh():
        torch.manual_seed(0)
        model = _port_diffusion(dropout=0.1)
        return model, Trainer(_trainer_cfg(seed=3), model, DDPMDiscreteLoss(), ("vae",))

    model, trainer = fresh()
    straight = [trainer.train_step(micros[2 * u:2 * u + 2]) for u in range(12)]
    model2, trainer2 = fresh()
    first = [trainer2.train_step(micros[2 * u:2 * u + 2]) for u in range(6)]
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(6, model2, trainer2.state_dict(), None, {"epoch": 1})
    model3, trainer3 = fresh()
    variables, state, extra = ckpt.load(ckpt.latest_step(), "cpu")
    from_jax_variables(model3, variables)
    trainer3.load_state_dict(state)
    assert extra["epoch"] == 1 and trainer3.num_updates == 6
    resumed = first + [trainer3.train_step(micros[2 * u:2 * u + 2]) for u in range(6, 12)]
    assert [(m["loss"], m["gnorm"]) for m in resumed] == [
        (m["loss"], m["gnorm"]) for m in straight]
    for (n, a), (_, b) in zip(model.state_dict().items(), model3.state_dict().items()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("max_tokens, max_sentences, mult", [
    (60, None, 1), (None, 5, 1), (45, 7, 2), (100, 3, 4), (30, None, 8)])
def test_batch_by_size_matches_jax(max_tokens, max_sentences, mult):
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 40, size=97)
    sizes[10] = 200  # longer than max_tokens: a batch of its own
    order = np.lexsort((rng.permutation(97), -sizes))
    ref = jax_batch_by_size(order, sizes[order], max_tokens or 0, max_sentences or 0, mult)
    got = batch_by_size(order, sizes, max_tokens, max_sentences, mult)
    assert [b.tolist() for b in got] == [b.tolist() for b in ref]


def _write_corpus(root, n=10, seed=0, codes=CODES, feat_dim=FEAT):
    """`n` utterances per split in the layout ReprToReprUnitDataset reads:
    {split}.tsv manifests and feat/{split}.manifest.tsv + per-utterance .npy."""
    rng = np.random.default_rng(seed)
    feat_dir = root / "feat"
    feat_dir.mkdir(exist_ok=True)
    for split in ("train", "dev", "test"):
        rows, lines = [], [str(feat_dir)]
        for i in range(n):
            t = int(rng.integers(6, 14))
            units = np.repeat(rng.integers(0, codes, size=t), rng.integers(1, 3, size=t))
            name = f"{split}{i}"
            np.save(feat_dir / f"{name}.feat.npy",
                    rng.normal(size=(len(units), feat_dim)).astype(np.float32))
            lines.append(f"{name}.feat.npy\t{len(units)}")
            rows.append({"id": name, "src_audio": f"{name}.wav", "src_n_frames": len(units),
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        (feat_dir / f"{split}.manifest.tsv").write_text("\n".join(lines) + "\n")
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    return feat_dir


def test_dataset_collates_like_jax(tmp_path):
    feat_dir = _write_corpus(tmp_path)
    ref = JDataset.from_tsv(str(tmp_path), str(feat_dir), "train", JDictionary.unit_dictionary(CODES))
    got = ReprToReprUnitDataset.from_tsv(str(tmp_path), str(feat_dir), "train",
                                         Dictionary.unit_dictionary(CODES))
    assert got.ids == ref.ids and len(Dictionary.unit_dictionary(CODES)) == CODES + 4
    np.testing.assert_array_equal(got.ordered_indices(), ref.ordered_indices())
    idx = [3, 0, 7]
    want = ref.collater([ref[i] for i in idx])
    have = got.collater([got[i] for i in idx])
    for key in ("id", "reduce_target", "reduce_target_unit", "reduce_target_lengths"):
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)


def test_fairseq_adam_and_schedule_match_jax_not_torch_adam():
    """The port's fairseq Adam (build_optimizer's "adam", at a unit schedule
    with the lr given per step) against JAX's scale_by_fairseq_adam with
    decoupled decay (float64); without decay, against torch.optim.Adam,
    which adds eps after the bias correction: on small gradients the
    trajectories part. The inverse_sqrt schedule is JAX's at every step."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(7, 5))
    grads = [rng.normal(size=(7, 5)) * 1e-6 for _ in range(10)]
    lr, eps = 1e-3, 1e-8
    for wd in (0.01, 0.0):
        with jax.enable_x64(True):
            tx = scale_by_fairseq_adam(*BETAS, eps)
            p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
            for g in grads:
                upd, st = tx.update(jnp.asarray(g), st)
                p = p - lr * (upd + wd * p)
            want = np.asarray(p)
        mine = torch.tensor(p0)
        opt = build_optimizer(dict(optimizer="adam", adam_betas=BETAS, adam_eps=eps,
                                   weight_decay=wd), lambda step: 1.0, [mine], ["p"])
        for g in grads:
            opt.step([torch.tensor(g)], lr)
        np.testing.assert_allclose(mine.numpy(), want, rtol=1e-12, atol=1e-15)
    ref_torch = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.Adam([ref_torch], lr=lr, betas=BETAS, eps=eps)
    for g in grads:
        ref_torch.grad = torch.tensor(g)
        topt.step()
    assert np.abs(ref_torch.detach().numpy() - mine.numpy()).max() > 1e-4

    sched, jsched = inverse_sqrt(LR, WARMUP, WARMUP_INIT), jax_inverse_sqrt(Config(
        lr=LR, warmup_updates=WARMUP, warmup_init_lr=WARMUP_INIT))
    for step in range(12):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6)


def _cli_args(data, feat_dir, save_dir, task, max_update, extra=()):
    sizes = ["--feature-dim", str(FEAT), "--latent-dim", str(LATENT), "--chan-mults", "[4]",
             "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
             "--vae-decoder-heads", "2"]
    if task == "speech_diffusion_discrete":
        sizes += ["--hidden-dim", "16", "--timesteps", "20", "--denoiser-depth", "1",
                  "--wavenet-layers", "2", "--wavenet-stacks", "1", "--multitask", "true"]
    return [str(data), "--tgt-feat-dir", str(feat_dir), "--task", task, "--cpu",
            "--target-code-size", str(CODES), "--dropout", "0.1", "--save-dir", str(save_dir),
            "--keep-best-checkpoints", "1", "--best-checkpoint-metric", "loss",
            "--keep-last-epochs", "1", "--lr", "5e-4", "--lr-scheduler", "inverse_sqrt",
            "--warmup-init-lr", "1e-7", "--warmup-updates", "2", "--adam-betas", "(0.9,0.98)",
            "--clip-norm", "2.0", "--max-update", str(max_update), "--max-tokens", "60",
            "--max-target-positions", "2048", "--seed", "42", "--prng-impl", "rbg",
            "--log-interval", "1", "--dtype", "float32", *sizes, *extra]


def test_cli_chain_vae_normalizer_resume_synthesis(tmp_path, capsys):
    """cli.train for the VAE (2 updates, checkpoint), then the normalizer
    over it (--speech-decoder-ckpt; 2 updates, checkpoint, resumed to 4),
    then cli.diff_norm_synthesis --params-npz on the trained normalizer."""
    feat_dir = _write_corpus(tmp_path)
    vae_dir, diff_dir = tmp_path / "ckpt_vae", tmp_path / "ckpt_diff"
    assert train_cli.main(_cli_args(tmp_path, feat_dir, vae_dir, "speech_decoder", 2)) == 0
    log = capsys.readouterr().err
    assert "epoch 1 | step 2 |" in log and "valid |" in log
    assert "saved checkpoint at step 2" in log
    vae_step = vae_dir / "step_000000002"
    assert (vae_step / "params.npz").exists()
    assert json.loads((vae_dir / "manifest.json").read_text())["last"] == 2

    diff_args = _cli_args(tmp_path, feat_dir, diff_dir, "speech_diffusion_discrete", 2,
                          ["--speech-decoder-ckpt", str(vae_step),
                           "--criterion", "ddpm_discrete_loss", "--arch", "diff_discrete"])
    assert train_cli.main(diff_args) == 0
    log = capsys.readouterr().err
    assert "restored the frozen VAE" in log and "saved checkpoint at step 2" in log
    resume = diff_args[:diff_args.index("--max-update") + 1] + ["4"] + \
        diff_args[diff_args.index("--max-update") + 2:]
    assert train_cli.main(resume) == 0
    log = capsys.readouterr().err
    assert "resumed from step 2" in log and "saved checkpoint at step 4" in log
    # keep-last 1 and keep-best 1 leave at most the last and the best
    assert len(json.loads((diff_dir / "manifest.json").read_text())["checkpoints"]) <= 2

    trained = load_params(str(diff_dir / "step_000000004"))
    vae_trained = load_params(str(vae_step))
    for k, v in _flat(vae_trained).items():  # the frozen VAE came through unchanged
        np.testing.assert_array_equal(_flat(trained["vae"])[k], v)
    out = tmp_path / "normalized"
    assert diff_norm_synthesis.main([
        str(tmp_path), "--params-npz", str(diff_dir / "step_000000004" / "params.npz"),
        "--tgt-feat-dir", str(feat_dir), "--output-dir", str(out), "--splits", "test",
        "--cpu", "--start-step", "6", "--hidden-dim", "16", "--latent-dim", str(LATENT),
        "--feature-dim", str(FEAT), "--vocab-size", str(CODES + 4), "--timesteps", "20",
        "--denoiser-depth", "1", "--wavenet-layers", "2", "--wavenet-stacks", "1",
        "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
        "--vae-decoder-heads", "2", "--chan-mults", "[4]"]) == 0
    rows = (out / "test.tsv").read_text().splitlines()[1:]
    assert len(rows) == 10
    # --ema-decay is ported since: it parses and reaches the trainer
    args = train_cli.parse_args([str(tmp_path), "--tgt-feat-dir", "x", "--task",
                                 "speech_decoder", "--ema-decay", "0.999", "--max-update", "1"])
    assert train_cli.trainer_config(args).ema_decay == 0.999
    with pytest.raises(SystemExit):
        train_cli.parse_args([str(tmp_path), "--tgt-feat-dir", "x", "--task", "speech_decoder",
                              "--find-unused-parameters", "--max-update", "1"])  # unknown
