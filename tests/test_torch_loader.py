"""The port's loader (data/iterators.py: workers, prefetch, read-ahead,
mark_trained), sharded --data (tasks/base.py) and the CLIs that use them,
against the JAX package on the CPU: the same batch index lists in the same
order for every worker count, the same resume offsets, JAX's shard rule,
and the CLIs' outputs unchanged by workers and read-ahead."""

import json

import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.data.iterators import EpochBatchIterator as JEpochBatchIterator
from diffnorm_tpu.data.iterators import read_ahead as jread_ahead
from diffnorm_tpu.data.repr_unit_dataset import ReprToReprUnitDataset as JDataset
from diffnorm_tpu.data.dictionary import Dictionary as JDictionary
from diffnorm_tpu.tasks.base import Task as JTask
from diffnorm_tpu_torch.cli import diff_norm_synthesis, generate, train_vocoder
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.data.iterators import (
    EpochBatchIterator,
    _Prefetcher,
    grouped,
    read_ahead,
)
from diffnorm_tpu_torch.tasks.vae_task import SpeechDecoderTask
from tests.test_torch_cli import TINY
from tests.test_torch_eval import WIDTH_FLAGS, generate_corpus  # noqa: F401
from tests.test_torch_train import CODES, FEAT, _cli_args
from tests.test_torch_vocoder_train import VOCODER_ARGS
from tests.test_torch_vocoder_train import _write_corpus as _write_vocoder_corpus
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


class Toy:
    """A map-style dataset of ragged sizes whose items record their index."""

    def __init__(self, n=23, seed=0):
        self.sizes = np.random.default_rng(seed).integers(3, 40, size=n)

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i):
        return {"id": i, "x": np.full(int(self.sizes[i]), i, np.float32)}

    def num_tokens(self, i):
        return int(self.sizes[i])

    def ordered_indices(self):
        return np.argsort(-self.sizes, kind="stable")

    def collater(self, samples):
        return {"id": np.asarray([s["id"] for s in samples])}


def _ids(itr):
    return [b["id"].tolist() for b in itr]


@pytest.mark.parametrize("workers,prefetch", [(0, 0), (0, 4), (1, 4), (4, 4), (4, 0)])
def test_batches_match_jax_for_every_worker_count(workers, prefetch):
    """Three epochs of --max-tokens 90, --batch-size 5 in multiples of 2,
    --curriculum 1 (epoch 1 in order): the port's batch lists equal JAX's
    sequential iterator's, with workers and prefetch alike."""
    kw = dict(max_tokens=90, max_sentences=5, required_batch_size_multiple=2, seed=3,
              curriculum=1)
    ours = EpochBatchIterator(Toy(), num_workers=workers, num_prefetch=prefetch, **kw)
    theirs = JEpochBatchIterator(Toy(), num_prefetch=0, **kw)
    epochs = []
    for _ in range(3):
        got, want = _ids(ours.next_epoch_itr()), _ids(theirs.next_epoch_itr())
        assert got == want and len(got) == len(ours)
        assert ours.end_of_epoch() and theirs.end_of_epoch()
        epochs.append(got)
        ours.finish_epoch()
        theirs.finish_epoch()
    first = [i for b in epochs[0] for i in b]
    assert first == Toy().ordered_indices().tolist()  # the curriculum epoch: in order
    assert epochs[1] != epochs[2]  # shuffled per epoch after it


@pytest.mark.parametrize("workers", [0, 4])
def test_mark_trained_offsets_and_resume_match_jax(workers):
    """A reader two groups ahead (read_ahead) of update_freq 2 groups: after
    k updates state_dict records the batches trained (2k), not those
    pulled, as JAX's; a resumed iterator hands out the rest of the epoch."""
    kw = dict(max_tokens=60, seed=5)
    for k in (1, 2, 3):
        ours = EpochBatchIterator(Toy(), num_workers=workers, **kw)
        theirs = JEpochBatchIterator(Toy(), num_prefetch=0, **kw)
        ours.load_state_dict({"epoch": 2, "offset": 1})
        theirs.load_state_dict({"epoch": 2, "offset": 1})
        got_itr = read_ahead(grouped(ours.next_epoch_itr(), 2), lambda g: g, depth=2)
        want_itr = jread_ahead(grouped(theirs.next_epoch_itr(), 2), lambda g: g, depth=2)
        for _ in range(k):
            assert _ids(next(got_itr)) == _ids(next(want_itr))
            ours.mark_trained(2)
            theirs.mark_trained(2)
        state = ours.state_dict()
        assert state == theirs.state_dict() == {"epoch": 2, "offset": 1 + 2 * k, "seed": 5}
        resumed, jresumed = (EpochBatchIterator(Toy(), **kw),
                             JEpochBatchIterator(Toy(), num_prefetch=0, **kw))
        resumed.load_state_dict(state)
        jresumed.load_state_dict(state)
        rest = _ids(resumed.next_epoch_itr())
        assert rest == _ids(jresumed.next_epoch_itr())
        full = EpochBatchIterator(Toy(), **kw)
        full.load_state_dict({"epoch": 2, "offset": 0})
        assert rest == _ids(full.next_epoch_itr())[1 + 2 * k:]
        ours.finish_epoch()
        assert ours.state_dict()["offset"] == 0 and ours.state_dict()["epoch"] == 3


class _Strict:
    """An iterator that fails if next() is called after its StopIteration."""

    def __init__(self, n):
        self.n, self.done = n, False

    def __iter__(self):
        return self

    def __next__(self):
        assert not self.done, "next() after StopIteration"
        if self.n == 0:
            self.done = True
            raise StopIteration
        self.n -= 1
        return self.n


def test_read_ahead_and_prefetcher_stop_once():
    """read_ahead never calls next() after the first StopIteration, at any
    depth; an exhausted _Prefetcher keeps raising StopIteration (it would
    block on its queue otherwise); a loading error reaches the consumer;
    close() stops the thread."""
    for depth in (1, 2, 5):
        for n in (0, 1, 3):
            assert list(read_ahead(_Strict(n), lambda v: v * 2, depth)) == \
                [2 * v for v in reversed(range(n))]
    pre = _Prefetcher(lambda: _Strict(3), depth=2)
    assert list(pre) == [2, 1, 0]
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(pre)

    def failing():
        yield 1
        raise OSError("unreadable")

    pre = _Prefetcher(failing, depth=2)
    assert next(pre) == 1
    with pytest.raises(OSError, match="unreadable"):
        next(pre)
    pre = _Prefetcher(lambda: iter(range(1000)), depth=2)
    assert next(pre) == 0
    pre.close()
    assert not pre._thread.is_alive()


def test_shards_rotate_as_jax_tasks_do():
    """data_path(epoch) and has_sharded_data against JAX's Task: shard
    (epoch - 1) % n, the first for epoch 1; one directory is no shard."""
    for data in ("a:b:c", "a:b", "a"):
        ours = SpeechDecoderTask(train_cli.parse_args(
            [data, "--tgt-feat-dir", "f", "--task", "speech_decoder", "--max-update", "1"]))
        theirs = JTask(Config(data=data))
        assert ours.has_sharded_data() == theirs.has_sharded_data()
        for epoch in range(1, 8):
            assert ours.data_path(epoch) == theirs.data_path(epoch)


def _shards(tmp_path):
    """Two shard directories (10 and 8 utterances) of the VAE corpus, their
    features in one directory whose manifests list both."""
    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    rng = np.random.default_rng(0)
    feat_dir = tmp_path / "feat"
    feat_dir.mkdir()
    roots, lines = [], {split: [str(feat_dir)] for split in ("train", "dev")}
    for k, n in enumerate((10, 8)):
        root = tmp_path / f"shard{k}"
        root.mkdir()
        for split in ("train", "dev"):
            rows = []
            for i in range(n if split == "train" else 2):
                t = int(rng.integers(6, 14))
                units = np.repeat(rng.integers(0, CODES, size=t), rng.integers(1, 3, size=t))
                name = f"{split}{k}_{i}"
                np.save(feat_dir / f"{name}.npy",
                        rng.normal(size=(len(units), FEAT)).astype(np.float32))
                lines[split].append(f"{name}.npy\t{len(units)}")
                rows.append({"id": name, "src_audio": f"{name}.wav", "src_n_frames": len(units),
                             "tgt_audio": " ".join(map(str, units)),
                             "tgt_n_frames": len(units)})
            write_translation_manifest(str(root / f"{split}.tsv"), rows)
        roots.append(root)
    for split, split_lines in lines.items():
        (feat_dir / f"{split}.manifest.tsv").write_text("\n".join(split_lines) + "\n")
    return roots, feat_dir


def _run_vae(roots, feat_dir, save_dir, max_update, extra=()):
    """cli.train on the sharded data; returns the ids of each training
    batch it prepared, in order (the read-ahead prepares up to two more
    than the run trains)."""
    seen, validating = [], []
    prepare, validate = SpeechDecoderTask.prepare_batch, train_cli.validate_split

    def record(self, batch, rng):
        if not validating:
            seen.append(batch["id"].tolist())
        return prepare(self, batch, rng)

    def flagged(*args):
        validating.append(True)
        try:
            return validate(*args)
        finally:
            validating.clear()

    SpeechDecoderTask.prepare_batch, train_cli.validate_split = record, flagged
    try:
        assert train_cli.main(_cli_args(":".join(map(str, roots)), feat_dir, save_dir,
                                        "speech_decoder", max_update,
                                        ["--max-tokens", "40", "--keep-last-epochs", "5",
                                         *extra])) == 0
    finally:
        SpeechDecoderTask.prepare_batch, train_cli.validate_split = prepare, validate
    return seen


def _losses(log):
    return {int(line.split("| step ")[1].split()[0]): line.split(" loss ")[1].split()[0]
            for line in log.splitlines() if "| step " in line}


def test_sharded_cli_train_and_mid_epoch_resume(tmp_path, capsys):
    """cli.train --data shard0:shard1 rotates the shard per epoch and feeds
    each epoch the batches of JAX's iterator on that shard; a checkpoint
    taken mid-epoch with the read-ahead (--save-interval-updates) resumes
    through --restore-file at the first batch not trained, and the losses
    of the resumed updates equal the uninterrupted run's."""
    roots, feat_dir = _shards(tmp_path)
    epochs = []
    for epoch in (1, 2, 3):
        ds = JDataset.from_tsv(str(roots[(epoch - 1) % 2]), str(feat_dir), "train",
                               JDictionary.unit_dictionary(CODES), is_train=True)
        itr = JEpochBatchIterator(ds, max_tokens=40, seed=42, num_prefetch=0,
                                  max_positions=(None, 2048), ignore_invalid_inputs=True)
        itr.epoch = epoch
        epochs.append(_ids(itr.next_epoch_itr()))
    assert len(epochs[0]) > 3  # step 2 is mid-epoch
    total = len(epochs[0]) + len(epochs[1]) + 1  # one update into epoch 3
    want = [b for e in epochs for b in e][:total]

    capsys.readouterr()
    seen = _run_vae(roots, feat_dir, tmp_path / "full", total)
    log = capsys.readouterr().err
    assert f"loaded data shard {roots[1]} for epoch 2" in log
    assert f"loaded data shard {roots[0]} for epoch 3" in log
    assert seen[:total] == want and len(seen) <= total + 2
    losses = _losses(log)

    _run_vae(roots, feat_dir, tmp_path / "part", 3, ["--save-interval-updates", "2"])
    part = json.loads((tmp_path / "part" / "step_000000002.json").read_text())
    assert part["epoch"] == 1 and part["iterator"]["offset"] == 2  # trained, not pulled
    capsys.readouterr()
    rest = _run_vae(roots, feat_dir, tmp_path / "resumed", total,
                    ["--restore-file", str(tmp_path / "part" / "step_000000002")])
    log = capsys.readouterr().err
    assert rest[:total - 2] == want[2:]
    resumed = _losses(log)
    assert sorted(resumed) == list(range(3, total + 1))
    assert all(resumed[s] == losses[s] for s in resumed)


def test_vocoder_cli_takes_workers(tmp_path, capsys):
    """cli.train_vocoder --num-workers 2 trains (it raised before); its
    iterator's batch lists are those of test_batches_match_jax_*."""
    root = _write_vocoder_corpus(tmp_path)
    assert train_vocoder.main(["--cpu", "--units-file", str(root / "train.units"),
                               "--audio-dir", str(root), "--vocoder-cfg", str(root / "voc.json"),
                               "--max-update", "2", "--save-dir", str(tmp_path / "ckpt"),
                               "--num-workers", "2", *VOCODER_ARGS]) == 0
    assert "saved checkpoint at step 2" in capsys.readouterr().err


def test_generate_cli_output_does_not_depend_on_workers(generate_corpus, tmp_path):  # noqa: F811
    """cli.generate in batches of 2 with the upload read-ahead: the same
    generate-test.txt with --num-workers 0 and 3."""
    base = [str(generate_corpus), "--cpu", "--path", str(generate_corpus / "nar.npz"),
            "--gen-subset", "test", "--batch-size", "2", *WIDTH_FLAGS]
    texts = []
    for workers in ("0", "3"):
        out = tmp_path / workers
        assert generate.main(base + ["--results-path", str(out), "--num-workers", workers]) == 0
        texts.append((out / "generate-test.txt").read_text())
    assert texts[0] == texts[1] and texts[0].count("D-") == 5


def test_ddim_cli_with_prefetch_writes_the_sequential_rows(tmp_path, monkeypatch):
    """cli.diff_norm_synthesis loads the next chunk on a worker and reads
    each chunk's units back one chunk behind: its manifest equals a
    sequential run of the same model, chunk by chunk, with the same noise
    (5 chunks of 1)."""
    from diffnorm_tpu.data.manifest import write_feature_manifest
    from diffnorm_tpu_torch.data.batching import bucket_length
    from diffnorm_tpu_torch.data.manifest import read_translation_manifest, write_translation_manifest
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.ops.unit_reduce import reduce_units
    from diffnorm_tpu_torch.weights import save_npz, to_jax_params

    torch.manual_seed(0)
    dims = dict(dim=16, latent_dim=3, feature_dim=24, vocab_size=20, timesteps=20,
                denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, vae_decoder_depth=1,
                vae_decoder_dim_head=8, vae_decoder_heads=2, chan_mults=[4])
    model = LatentDiffusionModule(**dims).eval()
    save_npz(str(tmp_path / "params.npz"), to_jax_params(model))
    rng = np.random.default_rng(0)
    feat_dir = tmp_path / "feat"
    feat_dir.mkdir()
    rows, frows = [], []
    for i in range(5):
        t = int(rng.integers(6, 14))
        units = np.repeat(rng.integers(0, 16, size=t // 2 + 1), 2)[:t]
        np.save(feat_dir / f"u{i}.feat.npy", rng.normal(size=(t, 24)).astype(np.float32))
        frows.append((f"u{i}.feat.npy", t))
        rows.append({"id": f"u{i}", "src_audio": f"u{i}", "src_n_frames": t,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": t})
    write_feature_manifest(str(feat_dir / "test.manifest.tsv"), str(feat_dir), frows)
    write_translation_manifest(str(tmp_path / "test.tsv"), rows)
    noise_rng = np.random.default_rng(7)
    drawn = []

    def numpy_noise(generator, shape, device):
        pair = tuple(torch.from_numpy(noise_rng.normal(size=shape).astype(np.float32))
                     for _ in range(2))
        drawn.append(pair)
        return pair

    monkeypatch.setattr(diff_norm_synthesis, "draw_noise", numpy_noise)
    flags = [f"--{k.replace('_', '-')}" for k in TINY]
    values = [json.dumps(v) if isinstance(v, list) else str(v) for v in TINY.values()]
    assert diff_norm_synthesis.main(
        [str(tmp_path), "--cpu", "--params-npz", str(tmp_path / "params.npz"), "--tgt-feat-dir",
         str(feat_dir), "--output-dir", str(tmp_path / "out"), "--start-step", "4",
         "--batch-size", "1", "--splits", "test",
         *[a for pair in zip(flags, values) for a in pair]]) == 0
    assert len(drawn) == 5

    items = []
    for row in rows:
        dedup, _, keep = reduce_units(np.asarray(row["tgt_audio"].split(), np.int64))
        items.append((row, dedup, keep))
    items.sort(key=lambda it: len(it[1]))
    expected = []
    for n, (row, dedup, keep) in enumerate(items):
        max_len = bucket_length(len(dedup))
        feat = np.zeros((1, max_len, 24), np.float32)
        mask = np.zeros((1, max_len), bool)
        feat[0, :len(dedup)] = np.load(feat_dir / f"{row['id']}.feat.npy")[keep]
        mask[0, :len(dedup)] = True
        units, _ = ddim_sample(model, torch.from_numpy(feat), torch.from_numpy(mask),
                               start_step=4, enc_noise=drawn[n][0], init_noise=drawn[n][1],
                               device=torch.device("cpu"))
        norm, _, _ = reduce_units(units.numpy()[0, :len(dedup)])
        expected.append({**{k: str(v) for k, v in row.items()},
                         "tgt_audio": " ".join(map(str, norm)), "tgt_n_frames": str(len(norm))})
    assert read_translation_manifest(str(tmp_path / "out" / "test.tsv")) == expected
