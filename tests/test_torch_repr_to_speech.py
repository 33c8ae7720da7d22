"""repr_to_speech in the port against the JAX package on the CPU, float32,
at tiny widths: the `FeatureGenerator` (a `proj` Dense in front of the
HiFi-GAN generator) loaded from JAX's tree, `FeatureToSpeechDataset` items
and batches, one GAN update of `cli.train_vocoder --input-type features`
against JAX's CLI on the same weights and batch, and `cli.train --task
repr_to_speech` into step directories that load back into the generator.
Features and WAVs are written from numpy seeds."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.data.code_dataset import FeatureToSpeechDataset as JFeatureToSpeechDataset
from diffnorm_tpu.data.iterators import EpochBatchIterator as JEpochBatchIterator
from diffnorm_tpu.models.hifigan import FeatureGenerator as JFeatureGenerator
from diffnorm_tpu.train.gan_trainer import GanTrainer as JGanTrainer
from diffnorm_tpu_torch.data.code_dataset import FeatureToSpeechDataset
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
from diffnorm_tpu_torch.data.manifest import write_feature_manifest
from diffnorm_tpu_torch.models.hifigan import FeatureGenerator
from diffnorm_tpu_torch.train.gan_trainer import GanTrainer
from diffnorm_tpu_torch.weights import from_jax_params, load_npz
from tests.helpers import write_wav16
from tests.test_torch_vocoder_train import MEL, VOCODER_ARGS
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

FEAT_DIM = 24
GEN = dict(feature_dim=FEAT_DIM, embedding_dim=8, upsample_rates=(4, 2),
           upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))
VOC_CFG = dict(model_in_dim=FEAT_DIM, embedding_dim=8, upsample_rates=[4, 2],
               upsample_kernel_sizes=[8, 4], upsample_initial_channel=16,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]])
GAN_REL = 1e-4  # test_torch_vocoder_train.py's bound on each metric


def _write_feature_corpus(root, seed=40):
    """Five utterances: 16 kHz WAVs and 50 Hz [frames, 24] feature dumps
    (two longer than the 8-frame crop, one exactly 8, one short), the
    feature manifest (`cli.prepare dump-features`' layout) with one entry
    that has no WAV, and the generator's config."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, frames in enumerate((13, 21, 8, 5, 17)):
        name = f"utt{i}"
        if i < 4:
            write_wav16(root / f"{name}.wav", rng.normal(size=frames * 320 + 51) * 0.2)
        np.save(root / f"{name}.feat.npy", rng.normal(size=(frames, FEAT_DIM)).astype(np.float32))
        rows.append((f"{name}.feat.npy", frames))
    write_feature_manifest(str(root / "train.manifest.tsv"), str(root), rows)
    (root / "voc.json").write_text(json.dumps(VOC_CFG))
    return root


def test_feature_generator_matches_jax_forward():
    """The port's FeatureGenerator on JAX's initialized tree (`proj`,
    `generator`) through `from_jax_params`: the waveform within 1e-5."""
    jm = JFeatureGenerator(**GEN)
    feats = np.random.default_rng(41).normal(size=(2, 7, FEAT_DIM)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(feats))["params"])
    assert sorted(params) == ["generator", "proj"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(feats)))
    model = from_jax_params(FeatureGenerator(**GEN), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (2, 7 * 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_feature_dataset_items_and_batches_match_jax(tmp_path):
    """FeatureToSpeechDataset.from_manifest against JAX's: the utterances
    with a WAV, every item (train crops drawn from the dataset's generator,
    the short one padded) and two epochs of batches of 3 through the
    iterator, equal."""
    root = _write_feature_corpus(tmp_path)
    args = (str(root / "train.manifest.tsv"), str(root))
    jds = JFeatureToSpeechDataset.from_manifest(*args, crop_units=8, seed=3)
    tds = FeatureToSpeechDataset.from_manifest(*args, crop_units=8, seed=3)
    assert tds.names == jds.names == ["utt0", "utt1", "utt2", "utt3"]
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        assert sorted(got) == sorted(want) == ["features", "index", "wav"]
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert tds[3]["features"].shape == (8, FEAT_DIM) and not tds[3]["features"][5:].any()
    titr = EpochBatchIterator(tds, max_sentences=3, seed=3)
    jitr = JEpochBatchIterator(jds, max_sentences=3, seed=3)
    n = 0
    for _ in range(2):
        for got, want in zip(titr.next_epoch_itr(), jitr.next_epoch_itr(), strict=True):
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            n += 1
        titr.finish_epoch()
        jitr.finish_epoch()
    assert n == 4


def test_cli_train_vocoder_features_update_matches_jax_cli(tmp_path, monkeypatch):
    """One update of `cli.train_vocoder --input-type features` in each
    package on the same corpus: the port's CLI takes JAX's initial weights
    (its first step loads the tree JAX's first step started from); the
    first batch equal, and every metric within 1e-4 relative, with no
    duration term."""
    from diffnorm_tpu.cli import train_vocoder as jax_train_vocoder
    from diffnorm_tpu_torch.cli import train_vocoder

    root = _write_feature_corpus(tmp_path)
    seen = {}
    jax_step = JGanTrainer.train_step

    def record_jax(self, state, batch):
        seen["jax"] = (jax.device_get(state), {k: np.asarray(v) for k, v in batch.items()})
        state, mets = jax_step(self, state, batch)
        seen["jax_mets"] = {k: float(v) for k, v in mets.items()}
        return state, mets

    port_step = GanTrainer.train_step

    def record_port(self, batch):
        state, _ = seen["jax"]
        self.load_variables({"g_params": state.g_params, "d_params": state.d_params})
        seen["port"] = batch
        seen["port_mets"] = port_step(self, batch)
        return seen["port_mets"]

    monkeypatch.setattr(JGanTrainer, "train_step", record_jax)
    monkeypatch.setattr(GanTrainer, "train_step", record_port)
    common = dict(feat_manifest=str(root / "train.manifest.tsv"), audio_dir=str(root),
                  vocoder_cfg=str(root / "voc.json"), crop_units=8, batch_size=2, max_update=1,
                  log_interval=1, mpd_periods=(2, 3), msd_scales=2, disc_width=0.0625,
                  n_fft=MEL["n_fft"], hop_size=MEL["hop_size"], win_size=MEL["win_size"],
                  num_mels=MEL["num_mels"])
    assert jax_train_vocoder.main(Config(cpu=True, input_type="features",
                                         save_dir=str(tmp_path / "jax"), **common)) == 0
    assert train_vocoder.main([
        "--cpu", "--input-type", "features", "--feat-manifest", common["feat_manifest"],
        "--audio-dir", str(root), "--vocoder-cfg", common["vocoder_cfg"], "--save-dir",
        str(tmp_path / "port"), "--max-update", "1", *VOCODER_ARGS]) == 0
    want_batch = seen["jax"][1]
    assert sorted(seen["port"]) == sorted(want_batch)
    for key, value in want_batch.items():
        np.testing.assert_array_equal(seen["port"][key], value, err_msg=key)
    got, want = seen["port_mets"], seen["jax_mets"]
    assert sorted(got) == sorted(want) == ["adv", "fm", "loss_d", "loss_g", "mel"]
    for key in want:
        assert abs(got[key] - want[key]) <= GAN_REL * abs(want[key]), (key, got, want)


def test_cli_train_task_repr_to_speech_dispatches_and_resumes(tmp_path, capsys):
    """`cli.train --task repr_to_speech` runs cli.train_vocoder with
    --input-type features: 2 updates saved as a step directory whose
    g_params load into a FeatureGenerator (its forward finite), then a
    re-run to step 3 resumes from it."""
    from diffnorm_tpu_torch.cli import train

    root = _write_feature_corpus(tmp_path)
    base = ["--task", "repr_to_speech", "--cpu", "--feat-manifest",
            str(root / "train.manifest.tsv"), "--audio-dir", str(root), "--vocoder-cfg",
            str(root / "voc.json"), "--save-dir", str(root / "ckpt"), *VOCODER_ARGS]
    assert train.main(base + ["--max-update", "2"]) == 0
    log = capsys.readouterr().err
    assert "step 2 | loss_d " in log and "dur_mse" not in log
    assert "vocoder training done at step 2" in log
    tree = load_npz(str(root / "ckpt" / "step_000000002" / "params.npz"))
    gen = from_jax_params(FeatureGenerator(**GEN), tree["g_params"]).eval()
    with torch.no_grad():
        wav = gen(torch.from_numpy(np.load(root / "utt0.feat.npy"))[None])
    assert wav.shape == (1, 13 * 8) and torch.isfinite(wav).all()
    assert train.main(base + ["--max-update", "3"]) == 0
    log = capsys.readouterr().err
    assert "resumed from step 2" in log and "vocoder training done at step 3" in log
