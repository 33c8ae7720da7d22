"""The port's code-HiFi-GAN fine-tune (recipe stage 6) on the CPU against the
JAX package, float32, at tests/test_gan.py's tiny shapes (n_fft 64, hop 32,
periods (2, 3), 2 scales, disc_width 0.0625, and 0.07 for the scale
discriminator's lcm rounding): the log-mel and its gradient, the
discriminators' scores and feature maps on carried weights, the GAN losses,
the dataset's crops and run-length labels in two epochs' batch order, the
optax AdamW, three `train_step`s from JAX's `init_state`, and the
`cli.train_vocoder` entry point (save, resume, hand-over to
`cli.generate_waveform`). Inputs come from numpy seeds."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.data.code_dataset import CodeToSpeechDataset as JCodeToSpeechDataset
from diffnorm_tpu.data.iterators import EpochBatchIterator as JEpochBatchIterator
from diffnorm_tpu.models import hifigan_disc as jdisc
from diffnorm_tpu.models.hifigan import CodeGenerator as JCodeGenerator
from diffnorm_tpu.ops.mel import mel_spectrogram as jax_mel
from diffnorm_tpu.train.gan_trainer import GanTrainer as JGanTrainer
from diffnorm_tpu_torch.data.code_dataset import CodeToSpeechDataset
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
from diffnorm_tpu_torch.models import hifigan_disc as disc
from diffnorm_tpu_torch.models.hifigan import CodeGenerator
from diffnorm_tpu_torch.ops.mel import mel_spectrogram
from diffnorm_tpu_torch.train.gan_trainer import GanTrainer
from diffnorm_tpu_torch.train.optimizers import OptaxAdamW
from diffnorm_tpu_torch.weights import from_jax_params, to_jax_params
from tests.helpers import write_wav16
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

MEL = dict(n_fft=64, hop_size=32, win_size=64, num_mels=20)
DISC = dict(mpd_periods=(2, 3), msd_scales=2, disc_width=0.0625)
GEN = dict(num_embeddings=10, embedding_dim=8, upsample_rates=(4, 2),
           upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), dur_predictor=True,
           var_pred_hidden_dim=8)
VOC_CFG = dict(num_embeddings=10, embedding_dim=8, upsample_rates=[4, 2],
               upsample_kernel_sizes=[8, 4], upsample_initial_channel=16,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]],
               dur_predictor_params={"var_pred_hidden_dim": 8})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kw", [dict(n_fft=64, hop=32, win=64, num_mels=20),
                                dict(n_fft=64, hop=16, win=48, num_mels=12, fmin=60.0,
                                     fmax=6000.0)])
def test_mel_spectrogram_and_its_gradient_match_jax(kw):
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(2, 1003)) * 0.3).astype(np.float32)
    weight = rng.normal(size=jax_mel(jnp.asarray(wav), **kw).shape).astype(np.float32)
    want = np.asarray(jax_mel(jnp.asarray(wav), **kw))
    want_grad = np.asarray(jax.grad(lambda w: jnp.sum(jax_mel(w, **kw) * weight))(
        jnp.asarray(wav)))
    x = torch.from_numpy(wav).requires_grad_()
    got = mel_spectrogram(x, **kw)
    (got * torch.from_numpy(weight)).sum().backward()
    assert _rel(got.detach(), want) <= 1e-5
    assert _rel(x.grad, want_grad) <= 1e-5
    with pytest.raises(AssertionError, match="too short"):
        mel_spectrogram(torch.zeros(1, 8), n_fft=64, hop=32, win=64)


def _disc_pair(jmod, tmod, real, fake, seed):
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(real), jnp.asarray(fake))
    params = jax.device_get(variables["params"])
    from_jax_params(tmod, params)
    return params


@pytest.mark.parametrize("which", ["mpd", "msd", "msd_width_0.07"])
def test_discriminators_and_losses_match_jax(which):
    rng = np.random.default_rng(1)
    real = (rng.normal(size=(2, 1001)) * 0.3).astype(np.float32)  # not a multiple of 2 or 3
    fake = (0.5 * real + rng.normal(size=real.shape) * 0.1).astype(np.float32)
    if which == "mpd":
        jm, tm = (jdisc.MultiPeriodDiscriminator(periods=(2, 3), width=0.0625),
                  disc.MultiPeriodDiscriminator((2, 3), 0.0625))
    else:
        width = 0.07 if which.endswith("0.07") else 0.0625
        jm, tm = (jdisc.MultiScaleDiscriminator(scales=2, width=width),
                  disc.MultiScaleDiscriminator(2, width))
    params = _disc_pair(jm, tm, real, fake, 2)
    assert to_jax_params(tm).keys() == params.keys()
    want = jm.apply({"params": params}, jnp.asarray(real), jnp.asarray(fake))
    with torch.no_grad():
        got = tm(torch.from_numpy(real), torch.from_numpy(fake))
    assert len(got) == len(want) == 2
    n_maps = 0
    for g_pair, w_pair in zip(got, want):
        for (g_score, g_maps), (w_score, w_maps) in zip(g_pair, w_pair):
            assert _rel(g_score, w_score) <= 1e-5
            assert len(g_maps) == len(w_maps)
            for g, w in zip(g_maps, w_maps):
                # the port's maps are [B, C, ...], JAX's [B, ..., C]
                g = g.permute(0, *range(2, g.dim()), 1)
                assert _rel(g, w) <= 1e-5
                n_maps += 1
    assert n_maps == 2 * 2 * (6 if which == "mpd" else 8)
    for name in ("discriminator_loss", "generator_adv_loss", "feature_matching_loss"):
        w = float(getattr(jdisc, name)(want))
        g = float(getattr(disc, name)(got))
        assert abs(g - w) <= 1e-6 * max(abs(w), 1.0), (name, g, w)


def test_scale_channels_round_to_the_groups_lcm():
    for width in (0.0625, 0.07, 0.1, 0.3):
        specs = disc.scale_specs(width)
        for (ch, _, _, g), nxt in zip(specs, specs[1:] + [(1, 0, 0, 1)]):
            assert ch % g == 0 and ch % nxt[3] == 0
    assert disc.scale_specs(1.0) == list(disc.SCALE_SPECS)


def _write_corpus(root, seed=3):
    """Four utterances (units file + 16 kHz WAVs): two longer than the
    8-unit crop, one exactly 8, one short (padded); an extra units line with
    no audio, which from_files skips."""
    rng = np.random.default_rng(seed)
    lines = []
    for i, n in enumerate((13, 21, 8, 5)):
        units = np.repeat(rng.integers(0, 10, size=n), rng.integers(1, 4, size=n))[:n]
        write_wav16(root / f"u{i}.wav", rng.normal(size=n * 320 + 37) * 0.2)
        lines.append(f"u{i}|" + " ".join(map(str, units)))
    lines.append("missing|1 2 3")
    (root / "train.units").write_text("\n".join(lines) + "\n")
    (root / "voc.json").write_text(json.dumps(VOC_CFG))
    return root


def test_dataset_crops_labels_and_batch_order_match_jax(tmp_path):
    root = _write_corpus(tmp_path)
    kw = dict(crop_units=8, seed=5, dedup_dur=True)
    jds = JCodeToSpeechDataset.from_files(str(root / "train.units"), str(root), **kw)
    tds = CodeToSpeechDataset.from_files(str(root / "train.units"), str(root), **kw)
    assert tds.names == jds.names == ["u0", "u1", "u2", "u3"]
    np.testing.assert_array_equal(tds.ordered_indices(), jds.ordered_indices())
    for key in ("code", "wav", "dur_code", "durations"):  # the CLIs' example draw
        np.testing.assert_array_equal(tds[0][key], jds[0][key])
    jitr = JEpochBatchIterator(jds, max_sentences=3, seed=5)
    titr = EpochBatchIterator(tds, max_sentences=3, seed=5)
    n_batches = 0
    for _ in range(2):
        for got, want in zip(titr.next_epoch_itr(), jitr.next_epoch_itr(), strict=True):
            assert sorted(got) == sorted(want)
            for key in got:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            n_batches += 1
        titr.finish_epoch()
        jitr.finish_epoch()
    assert n_batches == 4
    item = tds[3]  # the short one: padded units and -100 past its runs
    assert item["wav"].shape == (8 * 320,) and (item["durations"] != -100).any()
    assert item["durations"][item["durations"] > 0].sum() == 8
    # a data config's transforms, ported since (tests/test_torch_augment.py
    # holds them to JAX's), reach the dataset
    from diffnorm_tpu_torch.data.augment import NoiseAugment

    with_cfg = CodeToSpeechDataset.from_files(
        str(root / "train.units"), str(root),
        data_cfg={"waveform_transforms": {"_train": ["noiseaugment"]},
                  "noiseaugment": {"samples_path": str(root)}})
    assert [type(t) for t in with_cfg.waveform_transforms] == [NoiseAugment]


def test_optax_adamw_matches_optax():
    rng = np.random.default_rng(4)
    shapes = [(3, 5), (7,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.adamw(optax.exponential_decay(1e-2, 2, 0.9), b1=0.8, b2=0.99)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = OptaxAdamW(tp, lr=1e-2, betas=(0.8, 0.99), decay_steps=2, decay_rate=0.9)
    for _ in range(5):
        grads = [rng.normal(size=s).astype(np.float32) * 10 ** rng.uniform(-3, 1)
                 for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(g) for g in grads])
        for g, w in zip(tp, jp):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert opt.count == 5


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(value)


def test_three_train_steps_follow_jax_gan_trainer():
    cfg = dict(lr=2e-4, **MEL, **DISC)
    jt = JGanTrainer(JCodeGenerator(**GEN), Config(**cfg))
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        code = rng.integers(0, 10, size=(2, 16)).astype(np.int32)
        durations = np.full((2, 16), -100, np.int32)
        durations[:, :11] = rng.integers(1, 4, size=(2, 11))
        batches.append({"code": code, "wav": (rng.normal(size=(2, 16 * 8)) * 0.1
                                              ).astype(np.float32),
                        "durations": durations, "dur_code": code})
    state = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(batches[0]["code"]),
                          jnp.asarray(batches[0]["wav"]))
    state = jax.device_get(state)
    gen = CodeGenerator(**GEN)
    tt = GanTrainer(gen, cfg, torch.device("cpu"))
    tt.load_variables({"g_params": state.g_params, "d_params": state.d_params})
    for batch in batches:
        state, want = jt.train_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = tt.train_step(batch)
        assert sorted(got) == sorted(want) == ["adv", "dur_mse", "fm", "loss_d", "loss_g",
                                               "mel"]
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (key, got, want)
    assert tt.num_updates == int(state.step) == 3 == tt.g_opt.count == tt.d_opt.count
    want_tree = dict(_flat({"g_params": jax.device_get(state.g_params),
                            "d_params": jax.device_get(state.d_params)}))
    got_tree = dict(_flat(tt.variables()))
    assert sorted(got_tree) == sorted(want_tree)
    for path, want in want_tree.items():
        assert _rel(got_tree[path], want) <= 1e-4, path


VOCODER_ARGS = ["--crop-units", "8", "--batch-size", "2", "--n-fft", "64", "--hop-size",
                "32", "--win-size", "64", "--num-mels", "20", "--mpd-periods", "2,3",
                "--msd-scales", "2", "--disc-width", "0.0625", "--log-interval", "1"]


def test_cli_train_vocoder_saves_resumes_and_vocodes(tmp_path, capsys):
    from diffnorm_tpu_torch.cli import generate_waveform, train, train_vocoder
    from diffnorm_tpu_torch.data.audio import read_audio

    root = _write_corpus(tmp_path)
    base = ["--cpu", "--units-file", str(root / "train.units"), "--audio-dir", str(root),
            "--vocoder-cfg", str(root / "voc.json"), "--save-dir", str(root / "ckpt"),
            *VOCODER_ARGS]
    assert train_vocoder.main(base + ["--max-update", "2", "--save-interval-updates", "1"]) == 0
    log = capsys.readouterr().err
    for line in ("step 1 | loss_d ", "dur_mse", "saved checkpoint at step 2",
                 "vocoder training done at step 2"):
        assert line in log, (line, log)
    assert "resumed" not in log
    step2 = root / "ckpt" / "step_000000002"
    assert (step2 / "params.npz").exists() and (step2 / "trainer.pt").exists()
    # the fairseq-train entry point reaches it, and it continues from step 2
    assert train.main(["--task", "unit_to_speech", *base, "--max-update", "3"]) == 0
    log = capsys.readouterr().err
    assert "resumed from step 2" in log and "vocoder training done at step 3" in log
    state = torch.load(root / "ckpt" / "step_000000003" / "trainer.pt")
    assert state["num_updates"] == 3 and state["g_opt"]["count"] == 3

    (root / "hyp.unit").write_text("1 1 2 5 5 5 7\n3 3 9\n")
    assert generate_waveform.main(["--cpu", "--in-code-file", str(root / "hyp.unit"),
                                   "--vocoder", str(root / "ckpt" / "step_000000003"),
                                   "--vocoder-cfg", str(root / "voc.json"), "--results-path",
                                   str(root / "wav"), "--dur-prediction"]) == 0
    wavs = [read_audio(str(root / "wav" / f"{i}_pred.wav"))[0] for i in range(2)]
    assert all(len(w) >= 8 * 3 and np.isfinite(w).all() for w in wavs)


def test_cli_train_vocoder_refuses_unported_flags(tmp_path):
    """Ported since: --num-workers parses and reaches the iterator
    (tests/test_torch_loader.py trains with it), --data-config and
    --input-type features parse (features needs
    --feat-manifest), and `cli.train --task repr_to_speech` reaches
    cli.train_vocoder with --input-type features
    (tests/test_torch_repr_to_speech.py runs both)."""
    from diffnorm_tpu_torch.cli import train, train_vocoder

    base = ["--cpu", "--units-file", "u", "--audio-dir", str(tmp_path), "--vocoder-cfg", "c"]
    assert train_vocoder.parse_args(base + ["--num-workers", "2"]).num_workers == 2
    assert train_vocoder.parse_args(base + ["--data-config", "d.yaml"]).data_config == "d.yaml"
    with pytest.raises(SystemExit):  # features without a feature manifest
        train_vocoder.parse_args(base + ["--input-type", "features"])
    args = train_vocoder.parse_args(base + ["--input-type", "features", "--feat-manifest", "m"])
    assert (args.input_type, args.feat_manifest) == ("features", "m")
    with pytest.raises(FileNotFoundError, match="'c'"):  # past the dispatch, at the config
        train.main(["--task", "repr_to_speech", *base, "--feat-manifest", "m"])


def test_cli_train_vocoder_refuses_a_multispeaker_config(tmp_path):
    """A `multispkr` config with --input-type code raises before any
    training: JAX's CLI builds a single-speaker generator for it, which the
    synthesis side cannot load, so there is no multi-speaker fine-tune to
    port (ROADMAP Queue 3). --input-type features takes the config."""
    from diffnorm_tpu_torch.cli import train_vocoder

    root = _write_corpus(tmp_path)
    (root / "spk.json").write_text(json.dumps(dict(VOC_CFG, multispkr=True, num_speakers=3)))
    args = ["--cpu", "--units-file", str(root / "train.units"), "--audio-dir", str(root),
            "--vocoder-cfg", str(root / "spk.json"), "--save-dir", str(root / "ckpt"),
            "--max-update", "1", *VOCODER_ARGS]
    with pytest.raises(NotImplementedError, match="multi-speaker"):
        train_vocoder.main(args)
    assert not (root / "ckpt").exists()
    gen = train_vocoder.build_generator(dict(VOC_CFG, multispkr=True, model_in_dim=12),
                                        "features")
    assert gen.proj.in_features == 12
