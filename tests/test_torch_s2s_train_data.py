"""The port's NAR S2UT training data (diffnorm_tpu_torch/data/{audio,
dictionary,s2s_dataset,iterators}.py, tasks/nar_s2ut_task.py) against the JAX
package on the CPU: the kaldi fbank, the WAV reader, SpecAugment and
delta-deltas, the feature-transform lists, the dataset's items and batches on
a corpus of .wav and .npy sources, size filtering, and the CMLM masks. Every
piece is numpy on the host in both packages, so each is held bit for bit
from one seed."""

import wave

import numpy as np
import pytest
import yaml

from diffnorm_tpu.config import Config
from diffnorm_tpu.data import audio as jax_audio
from diffnorm_tpu.data.dictionary import Dictionary as JDictionary
from diffnorm_tpu.data.iterators import EpochBatchIterator as JEpochBatchIterator
from diffnorm_tpu.data.s2s_dataset import SpeechToUnitDataset as JSpeechToUnitDataset
from diffnorm_tpu.tasks import nar_s2ut_task as jax_task
from diffnorm_tpu_torch.data import audio
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
from diffnorm_tpu_torch.tasks import nar_s2ut_task
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

CODES, SR = 16, 16000
SPEC = {"freq_mask_N": 2, "freq_mask_F": 10, "time_mask_N": 2, "time_mask_T": 12,
        "time_mask_p": 0.5}
CONFIG = {"transforms": {"*": ["utterance_cmvn"], "_train": ["specaugment"]},
          "specaugment": SPEC}


def _write_wav(path, pcm, sr=SR, channels=1, width=2):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_corpus(root, n=12, seed=0, config=CONFIG):
    """{train,dev}.tsv over half .wav (0.2-0.6 s of 16 kHz noise), half
    .npy (80-d fbank-like) sources, unit targets of 3-20 units, and
    config.yaml."""
    rng = np.random.default_rng(seed)
    for split, m in (("train", n), ("dev", 5)):
        rows = []
        for i in range(m):
            name = f"{split}{i}"
            if i % 2 == 0:
                pcm = (rng.normal(size=int(rng.uniform(0.2, 0.6) * SR)) * 3000).astype(np.int16)
                _write_wav(root / f"{name}.wav", pcm)
                frames, src = (len(pcm) - 400) // 160 + 1, f"{name}.wav"
            else:
                frames = int(rng.integers(20, 60))
                np.save(root / f"{name}.npy", rng.normal(size=(frames, 80)).astype(np.float32))
                src = f"{name}.npy"
            units = rng.integers(0, CODES, size=int(rng.integers(3, 21)))
            rows.append({"id": name, "src_audio": src, "src_n_frames": frames,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump(config))


def _datasets(root, split, is_train, seed=1):
    jds = JSpeechToUnitDataset.from_tsv(str(root), split, JDictionary.unit_dictionary(CODES),
                                        is_train=is_train, seed=seed)
    tds = SpeechToUnitDataset.from_tsv(str(root), split, Dictionary.unit_dictionary(CODES),
                                       is_train=is_train, seed=seed)
    return jds, tds


@pytest.mark.parametrize("seconds, sr", [(1.37, 16000), (0.5, 8000), (0.02, 16000)])
def test_logmel_fbank_is_bit_equal(seconds, sr):
    """The same numpy fbank: bit-equal on a seeded waveform (0.02 s at 16 kHz
    is one frame short of a frame: an empty [0, 80])."""
    wav = np.random.default_rng(0).normal(size=int(seconds * sr)).astype(np.float32)
    got = audio.logmel_fbank(wav, sample_rate=sr)
    want = jax_audio.logmel_fbank(wav, sample_rate=sr)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == 80
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels, width", [(1, 2), (2, 2), (1, 4)])
def test_wav_reader_matches_jax(tmp_path, channels, width):
    """A WAV written with `wave` (mono or stereo, 16- or 32-bit) reads the
    same through both readers, and get_features_or_waveform gives the same
    fbank and waveform."""
    rng = np.random.default_rng(1)
    dtype = np.int16 if width == 2 else np.int32
    pcm = (rng.normal(size=(4000, channels)) * np.iinfo(dtype).max / 8).astype(dtype)
    path = tmp_path / "a.wav"
    _write_wav(path, pcm, channels=channels, width=width)
    wav, sr = audio.read_audio(str(path))
    want, want_sr = jax_audio.read_audio(str(path))
    assert sr == want_sr == SR and wav.shape == (4000,)
    np.testing.assert_array_equal(wav, want)
    for need_waveform in (False, True):
        np.testing.assert_array_equal(
            audio.get_features_or_waveform(str(path), need_waveform=need_waveform),
            jax_audio.get_features_or_waveform(str(path), need_waveform=need_waveform))


@pytest.mark.parametrize("cfg", [
    SPEC, {"freq_mask_N": 1, "freq_mask_F": 30, "time_mask_N": 3, "time_mask_T": 40,
           "time_mask_p": 1.0, "mask_value": 0.0},
    {"freq_mask_N": 2, "freq_mask_F": 27, "time_mask_N": 2, "time_mask_T": 100,
     "time_mask_p": 0.05}])
def test_specaugment_matches_jax_from_one_seed(cfg):
    """Five utterances through one generator each: equal outputs, and the
    generators left in the same state."""
    kw = dict(freq_mask_n=cfg["freq_mask_N"], freq_mask_f=cfg["freq_mask_F"],
              time_mask_n=cfg["time_mask_N"], time_mask_t=cfg["time_mask_T"],
              time_mask_p=cfg["time_mask_p"], mask_value=cfg.get("mask_value"))
    ours, theirs = audio.SpecAugment(**kw), jax_audio.SpecAugment(**kw)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    feats = np.random.default_rng(4).normal(size=(5, 90, 80)).astype(np.float32)
    masked = 0
    for x in feats:
        got, want = ours(x, rng=r1), theirs(x, rng=r2)
        np.testing.assert_array_equal(got, want)
        masked += int((got != x).any())
    assert masked > 0
    assert r1.random() == r2.random()
    with pytest.raises(NotImplementedError, match="time warp"):
        audio.SpecAugment(time_warp_w=5)


@pytest.mark.parametrize("win_length", [3, 5, 9])
def test_delta_deltas_match_jax(win_length):
    x = np.random.default_rng(5).normal(size=(37, 80)).astype(np.float32)
    got = audio.DeltaDeltas(win=(win_length - 1) // 2)(x)
    want = jax_audio.DeltaDeltas(win=(win_length - 1) // 2)(x)
    assert got.shape == (37, 240)
    np.testing.assert_array_equal(got, want)


def test_build_feature_transforms_train_and_eval(tmp_path):
    """`*` then `_train` / `_eval`, with each transform's settings, as JAX's
    lists; global CMVN, delta-deltas and unknown names too."""
    np.savez(tmp_path / "gcmvn.npz", mean=np.ones(80, np.float32),
             std=np.full(80, 2.0, np.float32))
    cfg = {"transforms": {"*": ["utterance_cmvn"], "_train": ["specaugment", "delta_deltas"],
                          "_eval": ["global_cmvn"]},
           "utterance_cmvn": {"norm_vars": False}, "specaugment": SPEC,
           "delta_deltas": {"win_length": 7},
           "global_cmvn": {"stats_npz_path": str(tmp_path / "gcmvn.npz")}}
    x = np.random.default_rng(6).normal(size=(50, 80)).astype(np.float32)
    for is_train in (True, False):
        got = audio.build_feature_transforms(cfg, is_train)
        want = jax_audio.build_feature_transforms(cfg, is_train)
        assert [type(t).__name__ for t in got] == [type(t).__name__ for t in want]
        for g, w in zip(got, want):
            if isinstance(g, audio.SpecAugment):
                np.testing.assert_array_equal(g(x, np.random.default_rng(0)),
                                              w(x, np.random.default_rng(0)))
            else:
                np.testing.assert_array_equal(g(x), w(x))
    assert [type(t).__name__ for t in audio.build_feature_transforms(cfg, True)] == [
        "UtteranceCMVN", "SpecAugment", "DeltaDeltas"]
    assert audio.build_feature_transforms({}, True) == []
    with pytest.raises(ValueError, match="unknown feature transform"):
        audio.build_feature_transforms({"transforms": {"*": ["pitch"]}}, False)


def test_encode_line_matches_jax_dictionary():
    line = "0 15 7 16 </s> <pad> x 3"
    ours, theirs = Dictionary.unit_dictionary(CODES), JDictionary.unit_dictionary(CODES)
    assert len(ours) == len(theirs) == CODES + 4
    for eos in (True, False):
        got = ours.encode_line(line, append_eos=eos)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, theirs.encode_line(line, append_eos=eos))


@pytest.mark.parametrize("split, is_train", [("train", True), ("dev", False)])
def test_dataset_items_and_batches_match_jax(tmp_path, split, is_train):
    """Every item in ordered_indices order (SpecAugment draws on train from
    the dataset's generator), then batches of 4 collated: ids, padded
    sources, targets with EOS, lengths and counts equal; sizes and
    ordered_indices too."""
    write_corpus(tmp_path)
    jds, tds = _datasets(tmp_path, split, is_train)
    np.testing.assert_array_equal(tds.ordered_indices(), jds.ordered_indices())
    assert [tds.size(i) for i in range(len(tds))] == [jds.size(i) for i in range(len(jds))]
    order = tds.ordered_indices()
    for i in order:
        got, want = tds[int(i)], jds[int(i)]
        np.testing.assert_array_equal(got["source"], want["source"])
        np.testing.assert_array_equal(got["target"], want["target"])
        assert got["target"][-1] == 2
    for start in range(0, len(order), 4):
        idx = [int(i) for i in order[start:start + 4]]
        got = tds.collater([tds[i] for i in idx])
        want = jds.collater([jds[i] for i in idx])
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert got["src_tokens"].shape[1] in (32, 64, 96) and got["target"].shape[1] == 32
    if is_train:  # the generator moved with SpecAugment, alike
        assert tds._rng.random() == jds._rng.random()


def test_dataset_raises_for_what_is_not_ported(tmp_path):
    """use_audio_input, ported since, gives the waveforms as [T, 1] sources
    with no feature transform, batches equal to JAX's bit for bit; the
    dataset transforms, ported since, build what the config names
    (tests/test_torch_augment.py holds them to JAX's)."""
    from diffnorm_tpu_torch.data.augment import ConcatAugment, NoisyOverlapAugment

    for cfg, built in (({"use_audio_input": True, **CONFIG}, None),
                       ({"dataset_transforms": {"_train": ["concataugment"]}}, ConcatAugment),
                       ({"dataset_transforms": {"*": ["noisyoverlapaugment"]},
                         "noisyoverlapaugment": {"mixing_noise_rate": 0.0}},
                        NoisyOverlapAugment)):
        write_corpus(tmp_path, n=2, config=cfg)
        if built is None:
            write_corpus(tmp_path, n=4, config=cfg)
            jds, tds = _datasets(tmp_path, "train", is_train=True)
            want = jds.collater([jds[0], jds[2]])  # two .wav sources
            got = tds.collater([tds[0], tds[2]])
            assert got["src_tokens"].shape[2] == 1 and sorted(got) == sorted(want)
            for key, value in want.items():
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            continue
        ds = SpeechToUnitDataset.from_tsv(str(tmp_path), "train", Dictionary(CODES),
                                          is_train=True)
        assert [type(t) for t in ds.dataset_transforms] == [built]


@pytest.mark.parametrize("max_positions", [(40, None), (None, 12), (45, 15), (1000, 1000),
                                           None])
def test_size_filtering_matches_jax_iterator(tmp_path, max_positions):
    """EpochBatchIterator over the train split with (max_source,
    max_target) caps: the same batches (ids) in the same order as JAX's over
    two epochs, over-long samples skipped; a valid-style iterator raises on
    them as JAX's does."""
    write_corpus(tmp_path, n=16)
    jds, tds = _datasets(tmp_path, "train", True)
    kw = dict(max_tokens=150, seed=7, max_positions=max_positions, ignore_invalid_inputs=True)
    ours = EpochBatchIterator(tds, **kw)
    theirs = JEpochBatchIterator(jds, num_prefetch=0, **kw)
    kept = 0
    for _ in range(2):
        got = [b["id"].tolist() for b in ours.next_epoch_itr()]
        want = [b["id"].tolist() for b in theirs.next_epoch_itr()]
        assert got == want
        kept = sum(len(b) for b in got)
        ours.finish_epoch()
        theirs.finish_epoch()
    sizes = [tds.size(i) for i in range(len(tds))]
    caps = max_positions or (None, None)
    want_kept = sum(all(c is None or s <= c for s, c in zip(sz, caps)) for sz in sizes)
    assert kept == want_kept
    if want_kept < len(tds):
        strict = dict(kw, ignore_invalid_inputs=False)
        with pytest.raises(ValueError, match="invalid"):
            list(EpochBatchIterator(tds, **strict).next_epoch_itr())
        with pytest.raises(ValueError, match="invalid"):
            list(JEpochBatchIterator(jds, num_prefetch=0, **strict).next_epoch_itr())


def _targets(seed, b=6, t=24):
    """Unit targets with EOS and pad tails of several lengths (one row of
    length 1: EOS alone, one full row)."""
    rng = np.random.default_rng(seed)
    target = np.full((b, t), 1, np.int32)
    for i, n in enumerate([t - 1, 1, 7, 13, 2, 19][:b]):
        target[i, :n - 1] = rng.integers(4, 4 + CODES, size=n - 1)
        target[i, n - 1] = 2
    return target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cmlm_masks_match_jax(seed):
    """random_mask and side_mask from one default_rng seed: bit-equal
    canvases, masked positions become <unk>, and the generators end alike.
    Only units are masked, except in the row of EOS alone, where the random
    mask's budget of int(0 * u + 1) = 1 takes the first position, the EOS,
    as the reference's does."""
    target = _targets(seed)
    units_rows = np.arange(len(target)) != 1
    for ours, theirs in ((nar_s2ut_task.random_mask, jax_task.random_mask),
                         (nar_s2ut_task.side_mask, jax_task.side_mask)):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = ours(target, r1), theirs(target, r2)
        np.testing.assert_array_equal(got, want)
        changed = got != target
        assert (got[changed] == 3).all()
        assert (target[units_rows][changed[units_rows]] >= 4).all()
        assert r1.random() == r2.random()
    canvas = nar_s2ut_task.random_mask(target, np.random.default_rng(seed))
    assert canvas[1, 0] == 3 and (canvas[units_rows] == 3).sum(1).min() >= 1


@pytest.mark.parametrize("use_side", [False, True])
def test_prepare_batch_matches_jax_over_a_stream_of_batches(tmp_path, use_side):
    """Eight batches through one generator, as the training CLI hands them:
    the same canvases (the side mask in about half of them with use_side)."""
    class Args:
        data, config_yaml, target_code_size, n_frames_per_step = str(tmp_path), "config.yaml", \
            CODES, 1

    Args.use_side = use_side
    task = nar_s2ut_task.NARS2UTTask(Args)
    jtask = jax_task.NARS2UTTask(Config(data=str(tmp_path), target_code_size=CODES,
                                        use_side=use_side))
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for k in range(8):
        target = _targets(20 + k)
        got = task.prepare_batch({"target": target}, r1)["prev_target"]
        want = jtask.prepare_batch({"target": target}, r2)["prev_target"]
        np.testing.assert_array_equal(got, want)
    assert r1.random() == r2.random()
    # stacked units (k = 2): the packed canvas and the per-sub-frame target
    Args.n_frames_per_step = 2
    task = nar_s2ut_task.NARS2UTTask(Args)
    jtask = jax_task.NARS2UTTask(Config(data=str(tmp_path), target_code_size=CODES,
                                        use_side=use_side, n_frames_per_step=2))
    for k in range(4):
        target = _targets(30 + k)
        got = task.prepare_batch({"target": target}, r1)
        want = jtask.prepare_batch({"target": target}, r2)
        assert got["target"].shape == want["target"].shape == (len(target), 12, 2)
        for key in ("prev_target", "target", "target_packed"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
