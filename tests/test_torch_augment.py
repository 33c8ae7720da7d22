"""The audio augments (`data/augment.py`, the port's copy) and their two
consumers against the JAX package on the CPU: each transform's output and
the generator's state after it on one seeded `np.random.Generator`
(bit for bit), the transforms a data config's YAML builds, the S2S
dataset's `concataugment` with SpecAugment and the vocoder dataset's
waveform transforms with `noisyoverlapaugment`, each over a stream of
batches through the CLI's iterator in the CLI's order (an example item
first, then two epochs). The noise directory and the corpora are written
from numpy seeds."""

import numpy as np
import pytest
import yaml

from diffnorm_tpu.data import augment as jaug
from diffnorm_tpu.data.code_dataset import CodeToSpeechDataset as JCodeToSpeechDataset
from diffnorm_tpu.data.iterators import EpochBatchIterator as JEpochBatchIterator
from diffnorm_tpu_torch.data import augment as aug
from diffnorm_tpu_torch.data.code_dataset import CodeToSpeechDataset
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
from tests.helpers import write_wav16
from tests.test_torch_s2s_train_data import CONFIG, _datasets, write_corpus
from tests.test_torch_vocoder_train import _write_corpus
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

SR = 16000


@pytest.fixture(scope="module")
def noise_dir(tmp_path_factory):
    """Seeded noise: 16 kHz WAVs of 0.05-0.4 s and one .npy sample."""
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(30)
    for i in range(4):
        write_wav16(root / f"n{i}.wav", rng.normal(size=int(rng.uniform(0.05, 0.4) * SR)) * 0.3)
    (root / "sub").mkdir()
    write_wav16(root / "sub" / "deep.wav", rng.normal(size=3000) * 0.1)
    np.save(root / "extra.npy", (rng.normal(size=2500) * 0.2).astype(np.float32))
    return root


def _sources(seed, n=6):
    """1-D and [1, T] waveforms of 0.1-0.5 s."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        wav = (rng.normal(size=int(rng.uniform(0.1, 0.5) * SR)) * 0.2).astype(np.float32)
        out.append(wav if i % 2 else wav[None, :])
    return out


WAVEFORM = {
    "noiseaugment": dict(rate=0.7),
    "musicaugment": dict(rate=1.0, snr_min=0.0, snr_max=3.0),
    "backgroundnoiseaugment": dict(rate=0.5),
    "babbleaugment": dict(rate=1.0),
    "sporadicnoiseaugment": dict(rate=1.0, noise_rate=8.0, noise_len_mean=0.02,
                                 noise_len_std=0.01),
}


@pytest.mark.parametrize("name", sorted(WAVEFORM))
def test_waveform_transform_matches_jax(noise_dir, name):
    """Six sources ([1, T] and 1-D) through the transform with one seeded
    generator each side: every output equal (its type too) and the
    generators in the same state after. [1, T] sources get real noise; 1-D
    ones get zeros after the same draws, as in JAX (the 2-D noise sample
    fails the rank check)."""
    kw = dict(samples_path=str(noise_dir), **WAVEFORM[name])
    (ours,) = aug.build_waveform_transforms({"waveform_transforms": {"*": [name]}, name: kw},
                                            True)
    theirs = jaug._WAVEFORM_TRANSFORMS[name](**kw)
    assert type(ours).__name__ == type(theirs).__name__ and ours.n_samples == 6
    r1, r2 = np.random.default_rng(31), np.random.default_rng(31)
    changed = 0
    for src in _sources(32):
        got, sr = ours(src, SR, rng=r1)
        want, jsr = theirs(src, SR, rng=r2)
        assert sr == jsr == SR and np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
        changed += src.ndim == 2 and not np.allclose(got, src)
    assert r1.bit_generator.state == r2.bit_generator.state
    assert changed >= 1


def test_concat_augment_indices_match_jax():
    """find_indices over 40 calls (rate 0.6, max_tokens 70, 3 attempts): the
    same partners, bases over the cap kept alone, and the generators alike."""
    n_frames = np.random.default_rng(33).integers(10, 80, size=12)
    ours, theirs = aug.ConcatAugment(0.6, 70, 3), jaug.ConcatAugment(0.6, 70, 3)
    r1, r2 = np.random.default_rng(34), np.random.default_rng(34)
    got = [ours.find_indices(i % 12, n_frames, 12, r1) for i in range(40)]
    want = [theirs.find_indices(i % 12, n_frames, 12, r2) for i in range(40)]
    assert got == want and r1.bit_generator.state == r2.bit_generator.state
    assert sum(len(g) == 2 for g in got) >= 5
    assert all(n_frames[g[0]] + n_frames[g[-1]] < 70 for g in got if len(g) == 2)


@pytest.mark.parametrize("mixing_noise_rate", [0.0, 0.5])
def test_noisy_overlap_matches_jax(noise_dir, mixing_noise_rate):
    """NoisyOverlapAugment over one batch of 1-D waveforms, three times on
    one generator (in-batch utterances, and external noise with
    mixing_noise_rate 0.5): equal outputs, generators alike; without a noise
    directory a noise rate > 0 raises, as JAX's."""
    kw = dict(rate=0.8, mixing_noise_rate=mixing_noise_rate,
              noise_path=str(noise_dir) if mixing_noise_rate else "")
    ours, theirs = aug.NoisyOverlapAugment(**kw), jaug.NoisyOverlapAugment(**kw)
    r1, r2 = np.random.default_rng(35), np.random.default_rng(35)
    batch = [s.reshape(-1) for s in _sources(36, n=5)]
    for _ in range(3):
        got, want = ours(batch, r1), theirs(batch, r2)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
    assert r1.bit_generator.state == r2.bit_generator.state
    assert any(not np.array_equal(g, s) for g, s in zip(got, batch))
    with pytest.raises(ValueError, match="noise_path"):
        aug.NoisyOverlapAugment(mixing_noise_rate=0.1)


def test_build_transforms_from_yaml(noise_dir, tmp_path):
    """A data config's YAML: the waveform and dataset transforms of the
    train and eval splits ("*" plus "_train" / "_eval") are JAX's, with the
    same parameters; an unknown name raises in both."""
    cfg_text = yaml.safe_dump({
        "waveform_transforms": {"*": ["noiseaugment"], "_train": ["babbleaugment",
                                                                  "sporadicnoiseaugment"]},
        "noiseaugment": {"samples_path": str(noise_dir), "rate": 0.3},
        "babbleaugment": {"samples_path": str(noise_dir), "snr_min": 1.0, "snr_max": 2.0},
        "sporadicnoiseaugment": {"samples_path": str(noise_dir), "noise_rate": 2.0},
        "dataset_transforms": {"_train": ["concataugment", "noisyoverlapaugment"]},
        "concataugment": {"rate": 0.4, "max_tokens": 500},
        "noisyoverlapaugment": {"rate": 0.6, "mixing_noise_rate": 0.0},
    })
    (tmp_path / "aug.yaml").write_text(cfg_text)
    cfg = yaml.safe_load((tmp_path / "aug.yaml").read_text())
    for is_train, n_wave, n_data in ((True, 3, 2), (False, 1, 0)):
        for build, n in (("build_waveform_transforms", n_wave),
                         ("build_dataset_transforms", n_data)):
            got, want = getattr(aug, build)(cfg, is_train), getattr(jaug, build)(cfg, is_train)
            assert len(got) == len(want) == n
            for g, w in zip(got, want):
                assert type(g).__name__ == type(w).__name__
                keys = set(vars(w)) - {"paths", "noise_shaper"}
                assert {k: vars(g)[k] for k in keys} == {k: vars(w)[k] for k in keys}
    train = aug.build_dataset_transforms(cfg, True)
    assert aug.get_transform(train, aug.ConcatAugment).max_tokens == 500
    assert aug.get_transform(aug.build_dataset_transforms(cfg, False), aug.ConcatAugment) is None
    for build in ("build_waveform_transforms", "build_dataset_transforms"):
        bad = {"waveform_transforms": {"*": ["pitchshift"]},
               "dataset_transforms": {"*": ["pitchshift"]}}
        for module in (aug, jaug):
            with pytest.raises(ValueError, match="pitchshift"):
                getattr(module, build)(bad, True)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_s2s_dataset_concat_and_specaugment_match_jax_over_a_stream(tmp_path):
    """The NAR dataset with `concataugment` and SpecAugment on train, read as
    cli.train reads it: one example item, then two epochs of the iterator
    (max_tokens 150, size caps). Every batch equal to JAX's (sources,
    concatenated targets with the first EOS dropped, ids); some items are
    concatenated; the generators alike after."""
    config = dict(CONFIG, dataset_transforms={"_train": ["concataugment"]},
                  concataugment={"rate": 0.5, "max_tokens": 90})
    write_corpus(tmp_path, n=14, config=config)
    jds, tds = _datasets(tmp_path, "train", True)
    for ds in (jds, tds):
        ds[0]
    kw = dict(max_tokens=150, seed=7, max_positions=(120, 60), ignore_invalid_inputs=True)
    ours, theirs = EpochBatchIterator(tds, **kw), JEpochBatchIterator(jds, num_prefetch=0, **kw)
    longer = 0
    for _ in range(2):
        for got, want in zip(ours.next_epoch_itr(), theirs.next_epoch_itr(), strict=True):
            _assert_batches_equal(got, want)
            single = [len(tds.tgt_units[i]) for i in got["id"]]
            longer += int((got["target_lengths"] > np.asarray(single)).sum())
        ours.finish_epoch()
        theirs.finish_epoch()
    assert longer >= 2
    assert tds._rng.random() == jds._rng.random()


def test_vocoder_dataset_transforms_match_jax_over_a_stream(tmp_path, noise_dir):
    """The vocoder dataset with noise, babble and sporadic noise on each crop
    and `noisyoverlapaugment` (with external noise) in the collater, read as
    cli.train_vocoder reads it: an example batch of item 0, then two epochs
    of batches of 3. Every batch's crops, codes and labels equal JAX's; the
    overlap changed some waveforms; the generators alike after."""
    root = _write_corpus(tmp_path)
    data_cfg = {
        "waveform_transforms": {"_train": ["noiseaugment", "babbleaugment",
                                           "sporadicnoiseaugment"]},
        "noiseaugment": {"samples_path": str(noise_dir), "rate": 0.5},
        "babbleaugment": {"samples_path": str(noise_dir), "rate": 0.5},
        "sporadicnoiseaugment": {"samples_path": str(noise_dir), "rate": 0.5},
        "dataset_transforms": {"_train": ["noisyoverlapaugment"]},
        "noisyoverlapaugment": {"rate": 0.7, "mixing_noise_rate": 0.4,
                                "noise_path": str(noise_dir)},
    }
    kw = dict(crop_units=8, seed=5, dedup_dur=True, data_cfg=data_cfg)
    jds = JCodeToSpeechDataset.from_files(str(root / "train.units"), str(root), **kw)
    tds = CodeToSpeechDataset.from_files(str(root / "train.units"), str(root), **kw)
    _assert_batches_equal(tds.collater([tds[0]]), jds.collater([jds[0]]))
    plain = CodeToSpeechDataset.from_files(str(root / "train.units"), str(root), crop_units=8,
                                           seed=5, dedup_dur=True)
    titr = EpochBatchIterator(tds, max_sentences=3, seed=5)
    jitr = JEpochBatchIterator(jds, max_sentences=3, seed=5)
    n_batches = moved = 0
    for _ in range(2):
        for got, want in zip(titr.next_epoch_itr(), jitr.next_epoch_itr(), strict=True):
            _assert_batches_equal(got, want)
            n_batches += 1
            moved += sum(not np.allclose(w, plain[int(i)]["wav"]) if len(plain.units[int(i)])
                         <= 8 else 0 for i, w in zip(got["id"], got["wav"]))
        titr.finish_epoch()
        jitr.finish_epoch()
    assert n_batches == 4 and moved >= 1
    assert tds._rng.random() == jds._rng.random()
