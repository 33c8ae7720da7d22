"""The runtime remainder of the port against the JAX package on the CPU:
the dummy tasks' batches (dummy_vae, dummy_nar, dummy_ar, dummy_mt) bit for
bit, every dummy task through cli.train and cli.validate without data on
disk, the criterion aliases' losses on shared weights within 1e-5, the
--user-dir registry (register, idempotence, a missing path, a name
collision), --config's YAML under explicit flags, cli.hydra_train's
rewrite of hydra's overrides and cli.average_checkpoints on bf16 leaves."""

import io
import math
import re
import textwrap

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions import aliases as jaliases
from diffnorm_tpu.models.hifigan import CodeGenerator as JCodeGenerator
from diffnorm_tpu.models.vae import ModelHolder
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.registry import _import_all
from diffnorm_tpu_torch import registry
from diffnorm_tpu_torch.cli import average_checkpoints, generate, hydra_train, interactive, validate
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions import aliases
from diffnorm_tpu_torch.models.hifigan import CodeGenerator
from diffnorm_tpu_torch.models.transformer_text import ARCHS as MT_ARCHS
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right
from diffnorm_tpu_torch.tasks.nar_s2ut_task import random_mask
from diffnorm_tpu_torch.weights import from_jax_params
from tests.test_torch_continuous_tasks import _Injected, _batch, _jax_cfg
from tests.test_torch_eval import WIDTH_FLAGS, generate_corpus  # noqa: F401 (fixture)
from tests.test_torch_continuous_tasks import _args as continuous_args
from tests.test_torch_multitask import _assert_batches_equal, _nested_torch
from tests.test_torch_text_mt import (  # noqa: F401 (fixtures)
    TGT_V,
    _float_text_attention,
    cmlm,
    inputs,
    levt,
    text_tasks,
    transformer,
    write_bitext,
)
from tests.test_torch_s2st import NAR_CFG
from tests.test_torch_train import LATENT, _jax_stage, _micro_batches, _port_diffusion
from tests.test_torch_vocoder_train import GEN, MEL
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

_import_all()
LOSS_RTOL = 1e-5

# ---------------------------------------------------------------- dummy tasks

DUMMY_JAX = {  # task: (the port's flags, JAX's config)
    "dummy_vae": (["--feature-dim", "24"], dict(feature_dim=24)),
    "dummy_nar": ([], {}),
    "dummy_ar": ([], {}),
    "dummy_mt": (["--src-vocab-size", "24"], dict(src_vocab_size=24)),
}


@pytest.mark.parametrize("name", sorted(DUMMY_JAX))
def test_dummy_batches_equal_jax(tmp_path, name):
    """dummy_batch at the defaults and at (3, 40), and the split's
    synthetic batches at --batch-size / --tokens-per-sample /
    --dataset-size, equal to JAX's bit for bit."""
    flags, cfg = DUMMY_JAX[name]
    args = train_cli.parse_args(["--task", name, "--max-update", "1", "--target-code-size",
                                 "20", "--batch-size", "3", "--tokens-per-sample", "40",
                                 "--dataset-size", "2", *flags])
    task = TASKS[name](args)
    jtask = JTASKS.get(name).setup_task(Config(
        data=str(tmp_path), target_code_size=20, batch_size=3, tokens_per_sample=40,
        dataset_size=2, arch=args.arch, **cfg))
    _assert_batches_equal(task.dummy_batch(), jtask.dummy_batch())
    _assert_batches_equal(task.dummy_batch(3, 40), jtask.dummy_batch(3, 40))
    ds, jds = list(task.dataset("train")), list(jtask.dataset("train"))
    assert len(ds) == len(jds) == 2
    for got, want in zip(ds, jds):
        _assert_batches_equal(got, want)


W = ["--encoder-embed-dim", "32", "--encoder-ffn-embed-dim", "64", "--encoder-layers", "2",
     "--encoder-attention-heads", "2", "--decoder-embed-dim", "32", "--decoder-ffn-embed-dim",
     "64", "--decoder-layers", "2", "--decoder-attention-heads", "2"]
S2S = ["--target-code-size", "16", "--conv-channels", "32", "--depthwise-conv-kernel-size", "5",
       "--tokens-per-sample", "40"]
TEXT = ["--src-vocab-size", "20", "--tokens-per-sample", "8"]
LM = ["--target-code-size", "12", "--decoder-embed-dim", "16", "--decoder-ffn-embed-dim", "32",
      "--decoder-layers", "2", "--decoder-attention-heads", "2", "--tokens-per-sample", "12"]
AUDIO = ["--encoder-embed-dim", "32", "--encoder-layers", "2", "--encoder-attention-heads", "2",
         "--encoder-ffn-embed-dim", "64", "--conv-feature-layers",
         "[(32,10,5),(32,3,2),(32,2,2)]", "--tokens-per-sample", "4000"]
VAE = ["--feature-dim", "24", "--latent-dim", "3", "--chan-mults", "[4]", "--vae-decoder-depth",
       "1", "--vae-decoder-dim-head", "8", "--vae-decoder-heads", "2", "--target-code-size",
       "16", "--tokens-per-sample", "10"]
DUMMY_FLAGS = {  # every dummy task at tiny widths (the model's and data's flags)
    "dummy_vae": VAE,
    "dummy_nar": W + S2S,
    "dummy_ar": W + S2S,
    "dummy_mt": W + TEXT,
    "dummy_translation": W + TEXT,
    "dummy_cmlm_cg": W + TEXT,
    "dummy_lev": W + TEXT,
    "dummy_s2spect": W + S2S[2:] + ["--prenet-dim", "8", "--postnet-conv-dim", "8",
                                    "--output-frame-dim", "6"],
    "dummy_tts": ["--arch", "fastspeech2", "--encoder-embed-dim", "16",
                  "--encoder-ffn-embed-dim", "32", "--encoder-layers", "1", "--decoder-layers",
                  "2", "--encoder-attention-heads", "2", "--output-frame-dim", "6",
                  "--max-target-positions", "32"],
    "dummy_s2t": ["--arch", "s2t_transformer_xs", "--encoder-embed-dim", "16",
                  "--encoder-ffn-embed-dim", "32", "--encoder-layers", "2",
                  "--decoder-embed-dim", "16", "--decoder-ffn-embed-dim", "32",
                  "--decoder-layers", "2", "--encoder-attention-heads", "2",
                  "--decoder-attention-heads", "2", "--conv-channels", "16"],
    "dummy_sedd": ["--target-code-size", "12", "--sedd-dim", "32", "--sedd-depth", "2",
                   "--sedd-heads", "2", "--tokens-per-sample", "16"],
    "dummy_unit_lm": LM,
    "dummy_lm": LM,
    "dummy_hubert": AUDIO + ["--final-dim", "16"],
    "dummy_wav2vec2": AUDIO + ["--final-dim", "16"],
    "dummy_ctc": AUDIO,
}
COMMON = ["--cpu", "--batch-size", "2", "--dataset-size", "2"]


def test_every_dummy_task_is_listed():
    """Every dummy_* task is synthetic and takes the checks of the task
    it derives from (the unit LM's names their own row)."""
    dummies = sorted(name for name in TASKS if TASKS[name].synthetic)
    assert sorted(DUMMY_FLAGS) == dummies == sorted(n for n in TASKS if n.startswith("dummy_"))
    bases = {name: train_cli.stage_of(name) for name in dummies}
    assert bases == {
        "dummy_vae": "speech_decoder", "dummy_nar": "speech_to_speech_fasttranslate",
        "dummy_ar": "speech_to_speech_ar", "dummy_s2spect": "speech_to_speech_spect",
        "dummy_tts": "text_to_speech", "dummy_s2t": "speech_to_text",
        "dummy_translation": "translation", "dummy_mt": "translation", "dummy_cmlm_cg": "cmlm_cg",
        "dummy_lev": "translation_lev", "dummy_sedd": "sedd", "dummy_unit_lm": "dummy_unit_lm",
        "dummy_lm": "dummy_lm", "dummy_hubert": "hubert_pretraining",
        "dummy_wav2vec2": "audio_pretraining", "dummy_ctc": "audio_finetuning"}
    assert train_cli.STAGES["dummy_lm"] == train_cli.STAGES["unit_lm"]


@pytest.mark.parametrize("name", sorted(DUMMY_FLAGS))
def test_cli_train_and_validate_run_every_dummy_task(tmp_path, name):
    """cli.train without DATA: 2 updates, a validation pass and a step
    directory; then cli.validate on it (the family's task accepted)."""
    flags = ["--task", name, *COMMON, *DUMMY_FLAGS[name]]
    assert train_cli.main(flags + ["--max-update", "2", "--log-interval", "1", "--save-dir",
                                   str(tmp_path / "ckpt")]) == 0
    step = tmp_path / "ckpt" / "step_000000002"
    assert (step / "params.npz").exists() and (step / "trainer.pt").exists()
    vals = validate.validate(validate.parse_args(flags + ["--path", str(step)]))
    assert math.isfinite(vals["loss"]) and vals["sample_size"] > 0


def test_cli_train_dummy_vae_resumes(tmp_path, capsys):
    """A second run with a higher --max-update resumes from the step
    directory (a dummy task has no iterator position to restore)."""
    flags = ["--task", "dummy_vae", *COMMON, *VAE, "--save-dir", str(tmp_path)]
    assert train_cli.main(flags + ["--max-update", "2"]) == 0
    assert train_cli.main(flags + ["--max-update", "3"]) == 0
    assert "resumed from step 2" in capsys.readouterr().err
    assert (tmp_path / "step_000000003").is_dir()


def test_data_backed_tasks_still_need_their_data():
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--task", "speech_to_speech_fasttranslate", "--max-update", "1"])
    with pytest.raises(SystemExit):  # the VAE stage still needs its features
        train_cli.parse_args(["data", "--task", "speech_decoder", "--max-update", "1"])
    args = train_cli.parse_args(["--task", "dummy_vae", "--max-update", "1"])
    assert args.data is None and args.tgt_feat_dir is None and args.latent_dim == 128

# ---------------------------------------------------------- criterion aliases


def _jax_loss(jcrit, jmodel, variables, batch):
    _, mets, _ = jax.jit(lambda v, b: jcrit(jmodel, v, b, jax.random.PRNGKey(0),
                                            train=False))(variables, batch)
    return mets


def _assert_metrics(got, want, what):
    assert sorted(got) == sorted(want), what
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("label_smoothing", [None, 0.1])
def test_cross_entropy_matches_jax(transformer, inputs, label_smoothing):
    """cross_entropy: eps 0 unless --label-smoothing, as JAX's; cli.train's
    default for it on the AR tasks is 0, not the task's 0.1."""
    jm, variables, model = transformer
    src, lens, tgt = inputs
    batch = {"src_tokens": src, "src_lengths": lens, "target": tgt,
             "prev_output_tokens": shift_right(tgt)}
    cfg = Config() if label_smoothing is None else Config(label_smoothing=label_smoothing)
    want = _jax_loss(jaliases.CrossEntropy(cfg), ModelHolder(jm, Config()), variables, batch)
    crit = aliases.CRITERIONS["cross_entropy"]({"label_smoothing": label_smoothing})
    assert crit.eps == (label_smoothing or 0.0)
    with torch.no_grad():
        _, got = crit(model, _nested_torch(batch))
    _assert_metrics(got, want, "cross_entropy")
    flags = ["--task", "dummy_mt", "--max-update", "1", "--criterion", "cross_entropy"]
    assert train_cli.parse_args(flags).label_smoothing == 0.0
    assert train_cli.parse_args(flags[:3] + ["1"]).label_smoothing == 0.1


def test_nat_loss_matches_jax(cmlm, levt, inputs, tmp_path):
    """nat_loss on the text CMLM (the masked CE) and the Levenshtein
    transformer (its canvases), each at its default smoothing."""
    src, lens, tgt = inputs
    base = {"src_tokens": src, "src_lengths": lens, "target": tgt}
    task, _ = text_tasks(write_bitext(tmp_path), "translation_lev", "levenshtein_transformer",
                         "--target-code-size", str(TGT_V - 4))
    for arch, (jm, variables, model), batch in (
            ("cmlm_transformer", cmlm,
             {**base, "prev_target": random_mask(tgt, np.random.default_rng(2))}),
            ("levenshtein_transformer", levt,
             task.prepare_batch(dict(base), np.random.default_rng(3)))):
        want = _jax_loss(jaliases.NatLoss(Config(arch=arch)), ModelHolder(jm, Config()),
                         variables, batch)
        crit = aliases.CRITERIONS["nat_loss"]({"arch": arch})
        with torch.no_grad():
            _, got = crit(model, _nested_torch(batch))
        _assert_metrics(got, want, arch)
    heads = {"target_letter": object()}  # the NAR model's aux heads reach its criterion
    task = type("Task", (), {"multitask_tasks": heads})()
    crit = aliases.CRITERIONS["nat_loss"]({"arch": "nar_s2ut_conformer"}, task)
    assert type(crit).__name__ == "NARSpeechToUnitLoss" and crit.multitask == heads


def _seeded_params(jmodel, batch):
    """Seeded weights of the names and shapes of the normalizer's traced
    (uncompiled) JAX init: normal kernels, norm scales near 1, biases near 0."""
    feature = batch["reduce_target"]
    mask = np.arange(feature.shape[1])[None, :] < batch["reduce_target_lengths"][:, None]
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.module.init(
        {"params": key, "dropout": key}, feature, mask, key, deterministic=True))
    rng = np.random.default_rng(2)

    def draw(path, leaf):
        noise = rng.normal(size=leaf.shape)
        if leaf.ndim > 1:
            return (noise / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        scale = str(getattr(path[-1], "key", "")) == "scale"
        return (float(scale) + 0.05 * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def test_ddpm_loss_matches_jax():
    """ddpm_loss, the continuous normalizer's latent noise MSE, on shared
    perturbed weights and injected draws."""
    args = continuous_args("speech_diffusion", ["--criterion", "ddpm_loss"])
    assert args.criterion == "ddpm_loss"
    jtask = JTASKS.get("speech_diffusion").setup_task(_jax_cfg(args))
    jmodel = jtask.build_model()
    batch = _batch(LATENT)
    params = _seeded_params(jmodel, batch)
    want = _jax_loss(jaliases.DDPMLossAlias(Config()), _Injected(jmodel, batch),
                     {"params": params}, batch)
    model = from_jax_params(TASKS["speech_diffusion"](args).build_model(), params).eval()
    crit = train_cli.build_criterion(TASKS["speech_diffusion"](args), args)
    assert isinstance(crit, aliases.DDPMLoss)
    with torch.no_grad():
        _, got = crit(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_metrics(got, want, "ddpm_loss")


def test_speech_decoder_loss_matches_jax():
    """speech_decoder_loss: the discrete normalizer's loss at eps 0.2."""
    cfg, jtask, jmodel = _jax_stage("ddpm")
    batch = _micro_batches(np.random.default_rng(1), "ddpm", 1)[0]
    params = _seeded_params(jmodel, batch)
    jcrit = jaliases.SpeechDecoderLossAlias(cfg, jtask)
    want = _jax_loss(jcrit, jmodel, {"params": params}, batch)
    crit = aliases.CRITERIONS["speech_decoder_loss"]()
    assert crit.eps == jcrit.eps == 0.2
    model = from_jax_params(_port_diffusion(), params).eval()
    with torch.no_grad():
        _, got = crit(model, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    _assert_metrics(got, want, "speech_decoder_loss")


@pytest.mark.parametrize("name", ["unit_to_speech", "repr_to_speech"])
def test_unit_to_speech_matches_jax(name):
    """The vocoder's generator-side loss: 45 x the log-mel L1 on the shorter
    length plus the duration MSE, durations of -100 masked."""
    rng = np.random.default_rng(8)
    code = rng.integers(0, 10, size=(2, 16)).astype(np.int32)
    durations = np.full((2, 16), -100, np.int32)
    durations[:, :11] = rng.integers(0, 4, size=(2, 11))
    batch = {"code": code, "wav": (rng.normal(size=(2, 16 * 8 - 5)) * 0.1).astype(np.float32),
             "durations": durations}
    jgen = JCodeGenerator(**GEN)

    def init_all(m, c):  # the duration predictor's weights too (JAX gan_trainer.py:76-82)
        m.predict_durations(c)
        return m(c)

    shapes = jax.eval_shape(lambda: jgen.init(jax.random.PRNGKey(0), code, method=init_all))
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.normal(size=a.shape)).astype(np.float32), shapes["params"])
    jcrit = jaliases.CRITERIONS.get(name)(Config(**MEL))
    want = jax.jit(lambda v, b: jcrit(jgen, v, b, jax.random.PRNGKey(0))[1])(
        {"params": params}, batch)
    model = from_jax_params(CodeGenerator(**GEN), params).eval()
    with torch.no_grad():
        _, got = aliases.CRITERIONS[name](MEL)(model, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
    _assert_metrics(got, want, name)
    assert "dur_mse" in got

# --------------------------------------------------------- --user-dir plugins


@pytest.fixture
def clean_registry():
    """The registries as they were before the test (a plugin's names stay
    out of the other tests of this worker)."""
    tasks, crits, users = dict(TASKS), dict(aliases.CRITERIONS), set(registry.USER_CRITERIONS)
    tables = [(t, dict(t)) for t in registry._arch_tables()]
    bases = dict(registry.ARCH_BASES)
    yield
    for live, saved in ((TASKS, tasks), (aliases.CRITERIONS, crits),
                        (registry.ARCH_BASES, bases), *tables):
        live.clear()
        live.update(saved)
    registry.USER_CRITERIONS.clear()
    registry.USER_CRITERIONS.update(users)


def _write_plugin(root, name):
    pkg = root / name
    pkg.mkdir()
    (pkg / "__init__.py").write_text(textwrap.dedent(f"""
        from diffnorm_tpu_torch.criterions.vae_loss import SpeechVAELoss
        from diffnorm_tpu_torch.registry import (register_architecture, register_criterion,
                                                 register_task)
        from diffnorm_tpu_torch.tasks.dummy import DummyVAETask


        @register_task("{name}_vae")
        class UserDummyVAETask(DummyVAETask):
            pass


        @register_criterion("{name}_loss")
        class UserLoss(SpeechVAELoss):
            def __init__(self, args=None, task=None):
                super().__init__()


        @register_architecture("transformer", "{name}_transformer")
        def shallow(widths):
            if widths.get("encoder_layers") is None:
                widths["encoder_layers"] = 1
    """))
    return pkg


def test_import_user_module_registers_once(tmp_path, clean_registry):
    pkg = _write_plugin(tmp_path, "torch_plugin_a")
    registry.import_user_module(str(pkg))
    assert "torch_plugin_a_vae" in TASKS and "torch_plugin_a_loss" in aliases.CRITERIONS
    assert "torch_plugin_a_transformer" in MT_ARCHS
    registry.import_user_module(str(pkg))  # idempotent for a path
    args = train_cli.parse_args(["--task", "dummy_mt", "--arch", "torch_plugin_a_transformer",
                                 "--max-update", "1"])
    want = dict.fromkeys(("encoder_layers", "decoder_layers", "encoder_embed_dim"))
    MT_ARCHS["transformer"](want)
    assert (args.encoder_layers, args.decoder_layers, args.encoder_embed_dim) == (
        1, want["decoder_layers"], want["encoder_embed_dim"])
    with pytest.raises(ValueError, match="already registered"):
        registry.register_task("torch_plugin_a_vae")(object)


def test_missing_user_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        registry.import_user_module(str(tmp_path / "nope"))


def test_user_dir_name_collision_raises(tmp_path):
    pkg = tmp_path / "json"  # the standard library's
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    with pytest.raises(FileExistsError):
        registry.import_user_module(str(pkg))


def test_cli_train_with_user_dir_config_and_hydra(tmp_path, clean_registry, capsys):
    """A plugin's task and criterion through cli.hydra_train: --user-dir,
    a --config YAML with hydra's groups, dotted overrides over it."""
    pkg = _write_plugin(tmp_path, "torch_plugin_b")
    cfg = {"task": "torch_plugin_b_vae", "feature_dim": 24, "latent_dim": 3,
           "chan_mults": [4], "vae_decoder_depth": 1, "vae_decoder_dim_head": 8,
           "vae_decoder_heads": 2, "target_code_size": 16,
           "optimization": {"max_update": 3, "lr": 0.002},
           "dataset": {"batch_size": 2, "dataset_size": 2, "tokens_per_sample": 10}}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    rc = hydra_train.main(["--config", str(tmp_path / "cfg.yaml"), "--user-dir", str(pkg),
                           "optimization.max_update=[2]", "criterion=torch_plugin_b_loss",
                           f"checkpoint.save_dir={tmp_path / 'ckpt'}", "--cpu"])
    assert rc == 0 and (tmp_path / "ckpt" / "step_000000002").is_dir()
    assert "training done at step 2" in capsys.readouterr().err

# ------------------------------------------------------------ --config, hydra


def test_config_yaml_under_explicit_flags(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({"lr": 0.25, "max_update": 7, "task": "dummy_mt",
                                    "model": {"encoder_layers": 3}, "clip-norm": 5.0}))
    args = train_cli.parse_args(["--config", str(path), "--lr", "0.5"])
    assert (args.lr, args.max_update, args.task, args.encoder_layers, args.clip_norm) == (
        0.5, 7, "dummy_mt", 3, 5.0)
    # --config is not an abbreviation of --config-yaml, nor the other way round
    args = train_cli.parse_args(["--task", "dummy_mt", "--max-update", "1", "--config-yaml",
                                 "data.yaml"])
    assert args.config_yaml == "data.yaml" and args.config is None
    path.write_text(yaml.safe_dump({"find_unused_parameters": True}))
    with pytest.raises(SystemExit):  # a flag the port lacks (JAX's train reads none)
        train_cli.parse_args(["--config", str(path), "--task", "dummy_mt", "--max-update", "1"])


def test_hydra_rewrite_matches_jax(monkeypatch):
    """JAX's rewrite of tests/test_aliases.py:116, with task.data as the
    port's DATA positional."""
    import sys

    from diffnorm_tpu.cli import hydra_train as jhydra
    from diffnorm_tpu.cli import train as jtrain

    argv = ["task.data=/x", "optimization.lr=[5e-4]", "--cpu", "criterion=ctc"]
    seen = {}
    monkeypatch.setattr(jtrain, "main", lambda cfg=None: seen.setdefault("argv", sys.argv[1:]))
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    jhydra.main()
    assert seen["argv"] == ["--data", "/x", "--lr", "5e-4", "--cpu", "--criterion", "ctc"]
    assert hydra_train.rewrite(argv) == ["/x", "--lr", "5e-4", "--cpu", "--criterion", "ctc"]
    monkeypatch.setattr(train_cli, "main", lambda argv: seen.setdefault("port", argv))
    hydra_train.main(argv)
    assert seen["port"] == hydra_train.rewrite(argv)

# -------------------------------------------------------- average_checkpoints


def test_average_checkpoints_averages_bf16_leaves(tmp_path, monkeypatch):
    """bf16 leaves (2-byte voids once np.load reads them back), float32 and
    integer leaves averaged as JAX's average_checkpoints does (a float64
    mean cast back to the leaf's dtype; the first input's integers), JAX's
    result widened to float32."""
    from diffnorm_tpu.cli import average_checkpoints as jax_average

    rng = np.random.default_rng(0)
    trees = [{"w": {"kernel": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16)},
              "b": rng.normal(size=(3,)).astype(np.float32), "n": np.arange(3) + k}
             for k in range(3)]
    paths = []
    for k, tree in enumerate(trees):
        paths.append(str(tmp_path / f"{k}.npz"))
        np.savez(paths[-1], **{"w/kernel": tree["w"]["kernel"], "b": tree["b"], "n": tree["n"]})
    monkeypatch.setattr(jax_average, "load_checkpoint_params",
                        lambda path: trees[paths.index(path)])
    want = jax_average.average_checkpoints(paths)
    assert want["w"]["kernel"].dtype == ml_dtypes.bfloat16
    out = average_checkpoints.average_checkpoints(paths)
    np.testing.assert_array_equal(out["w"]["kernel"], want["w"]["kernel"].astype(np.float32))
    np.testing.assert_array_equal(out["b"], want["b"])
    np.testing.assert_array_equal(out["n"], want["n"])
    assert average_checkpoints.main(["--inputs", *paths, "--output", str(tmp_path / "avg")]) == 0
    assert (tmp_path / "avg" / "params.npz").exists()


def test_dummy_tasks_refuse_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    flags = ["--task", "dummy_vae", *VAE, "--max-update", "1", "--save-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(flags)
    with pytest.raises(RuntimeError, match="CUDA"):
        hydra_train.main(flags)


# ------------------------------------------------ cli.interactive's speech


def test_interactive_speech_lines_match_jax_cli(generate_corpus, capsys, monkeypatch):
    """NAR S2UT through cli.interactive: a line names a .npy utterance, its
    H- line equal to JAX's CLI on the same weights (JAX reads its orbax
    copy); a blank line is skipped and numbered."""
    from diffnorm_tpu.cli import interactive as jax_interactive

    root = generate_corpus
    lines = "\n" + str(root / "utt0.npy") + "\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    assert interactive.main([str(root), "--cpu", "--path", str(root / "nar.npz"),
                             *WIDTH_FLAGS]) == 0
    got = re.findall(r"^H-.*$", capsys.readouterr().out, re.M)
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    assert jax_interactive.main(Config(data=str(root), cpu=True,
                                       path=str(root / "nar_ck"), **NAR_CFG)) == 0
    want = re.findall(r"^H-.*$", capsys.readouterr().out, re.M)
    assert got == want and len(got) == 1 and got[0].startswith("H-1\t")


def test_interactive_ar_speech_lines_match_in_process(tmp_path, capsys, monkeypatch):
    """AR S2UT through cli.interactive: the H- line of a .npy utterance is
    the in-process beam search's best hypothesis; UnitY refuses."""
    from diffnorm_tpu_torch.generate.beam_search import ar_generate
    from diffnorm_tpu_torch.weights import save_npz, to_jax_variables

    flags = ["--task", "speech_to_speech_ar", "--arch", "s2ut_conformer", *W,
             "--target-code-size", "16", "--conv-channels", "32", "--depthwise-conv-kernel-size",
             "5", "--max-target-positions", "12"]
    torch.manual_seed(3)
    model = TASKS["speech_to_speech_ar"](train_cli.parse_args(
        [str(tmp_path), "--max-update", "1", *flags])).build_model().eval()
    save_npz(str(tmp_path / "ar.npz"), to_jax_variables(model))
    feats = np.random.default_rng(4).normal(size=(37, 80)).astype(np.float32)
    np.save(tmp_path / "u.npy", feats)
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{tmp_path / 'u.npy'}\n"))
    argv = [str(tmp_path), "--cpu", "--path", str(tmp_path / "ar.npz"), "--beam", "3", *flags]
    assert interactive.main(argv) == 0
    got = re.findall(r"^H-0\t(.*)$", capsys.readouterr().out, re.M)
    args, _ = interactive.parse_args(argv)
    ar = generate.build_ar_model(args, str(tmp_path / "ar.npz"), torch.device("cpu"),
                                 torch.float32)
    with torch.no_grad():
        seqs, _ = ar_generate([ar], torch.from_numpy(feats)[None], torch.tensor([37]),
                              beam_size=3, max_len=12)
    want = " ".join(str(t - 4) for t in seqs[0, 0].tolist() if t not in (1, 2))
    assert got == [want]
    with pytest.raises(NotImplementedError):
        interactive.parse_args(argv[:4] + ["--task", "speech_to_speech_ar", "--arch",
                                           "unity_conformer"])
