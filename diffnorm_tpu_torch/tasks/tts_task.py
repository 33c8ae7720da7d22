"""Text-to-speech training ("text_to_speech", the port of
diffnorm_tpu/tasks/tts_task.py; reference fairseq/tasks/text_to_speech.py):
the AR `tts_transformer` (criterion tacotron2_loss) and FastSpeech2
(fastspeech2_loss), trained by cli.train, scored by cli.validate and
synthesized by cli.generate.

`TextToSpeechDataset` reads an S2T-style manifest `{split}.tsv` with the
columns id, audio, n_frames and tgt_text, and optionally duration, pitch
and energy: `audio` is a mel or feature dump (`.npy`, [T, D]) read from
the path as written, `tgt_text` the input text (fairseq keeps the S2T
column names, where text is the source), `duration` FastSpeech2's per-token
integer alignment ("12 7 3 ..."), `pitch` and `energy` per-token `.npy`
files. Its collater pads the tokens with PAD and the frames with zeros to
the batch's longest, in the order given: src_tokens, src_lengths,
feat_tgt, tgt_lengths, prev_feats (the targets shifted right behind a zero
frame), tgt_mask, and where the rows have them durations, pitches and
energies cut or padded to the longest source. The dictionary is
`{data}/dict.txt` where there is one, else built from the train split's
text, else `vocab_size` - 4 numbered symbols; the target dictionary is the
source's. The arch picks the forward: FastSpeech2 takes the tokens and the
gold variances, the tts_transformer the teacher-forced frames.
`DummyTTSTask` ("dummy_tts") trains on `dataset_size` copies of
`dummy_batch`, in process or through cli.train without DATA.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from diffnorm_tpu_torch.criterions.tts_loss import CRITERIONS
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.manifest import read_translation_manifest
from diffnorm_tpu_torch.models.fastspeech2 import ARCHS as FASTSPEECH2_ARCHS
from diffnorm_tpu_torch.models.fastspeech2 import FastSpeech2Module
from diffnorm_tpu_torch.models.tts_transformer import ARCHS as TTS_TRANSFORMER_ARCHS
from diffnorm_tpu_torch.models.tts_transformer import TTSTransformerModule
from diffnorm_tpu_torch.tasks.base import Task

PAD = 1
ARCHS = {**TTS_TRANSFORMER_ARCHS, **FASTSPEECH2_ARCHS}
# each arch's criterions, the first the default
ARCH_CRITERIONS = {**dict.fromkeys(TTS_TRANSFORMER_ARCHS, ("tacotron2_loss", "tacotron2")),
                   **dict.fromkeys(FASTSPEECH2_ARCHS, ("fastspeech2_loss", "fastspeech2"))}


class TextToSpeechDataset:
    """Text tokens -> mel frames, with FastSpeech2's variances where the
    manifest has them (module docstring)."""

    def __init__(self, rows: List[Dict], src_dict: Dictionary, is_train: bool = True,
                 seed: int = 1):
        self.rows, self.src_dict = rows, src_dict
        self.shuffle, self.seed = is_train, seed
        self.sizes = np.asarray([int(r.get("n_frames", 0) or 0) for r in rows], np.int64)

    def __len__(self) -> int:
        return len(self.rows)

    def num_tokens(self, i: int) -> int:
        return int(self.sizes[i])

    def ordered_indices(self) -> np.ndarray:
        order = (np.random.default_rng(self.seed).permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        return np.lexsort((order, -self.sizes))

    def __getitem__(self, i: int) -> Dict:
        r = self.rows[i]
        item = {"index": i, "tokens": self.src_dict.encode_line(r["tgt_text"], append_eos=True),
                "feat": np.load(r["audio"]).astype(np.float32)}
        if r.get("duration"):
            item["duration"] = np.asarray([int(x) for x in r["duration"].split()], np.int32)
        for key in ("pitch", "energy"):
            if r.get(key):
                item[key] = np.load(r[key]).astype(np.float32)
        return item

    def collater(self, samples: List[Dict]) -> Dict:
        s_lens = np.asarray([len(s["tokens"]) for s in samples], np.int32)
        t_lens = np.asarray([s["feat"].shape[0] for s in samples], np.int32)
        smax, tmax = int(s_lens.max()), int(t_lens.max())
        src = np.full((len(samples), smax), PAD, np.int32)
        feat = np.zeros((len(samples), tmax, samples[0]["feat"].shape[1]), np.float32)
        for i, s in enumerate(samples):
            src[i, :s_lens[i]] = s["tokens"]
            feat[i, :t_lens[i]] = s["feat"]
        prev = np.zeros_like(feat)
        prev[:, 1:] = feat[:, :-1]
        batch = {"id": np.asarray([s["index"] for s in samples], np.int64),
                 "src_tokens": src, "src_lengths": s_lens, "feat_tgt": feat,
                 "tgt_lengths": t_lens, "ntokens": int(t_lens.sum()),
                 "nsentences": len(samples), "prev_feats": prev,
                 "tgt_mask": np.arange(tmax)[None, :] < t_lens[:, None]}
        if "duration" in samples[0]:
            dur = np.zeros((len(samples), smax), np.int32)
            for i, s in enumerate(samples):
                dur[i, :len(s["duration"])] = s["duration"][:smax]
            batch["durations"] = dur
        for key, out in (("pitch", "pitches"), ("energy", "energies")):
            if key in samples[0]:
                arr = np.zeros((len(samples), smax), np.float32)
                for i, s in enumerate(samples):
                    n = min(len(s[key]), smax)
                    arr[i, :n] = s[key][:n]
                batch[out] = arr
        return batch


class TextToSpeechTask(Task):
    tts_generation = True  # cli.generate's spectrogram branch

    def __init__(self, args):
        super().__init__(args)
        self.src_dict = self._build_dict()
        self.tgt_dict = self.src_dict

    def _vocab_size(self) -> int:
        return getattr(self.args, "vocab_size", None) or 100

    def _build_dict(self) -> Dictionary:
        root = self.args.data or ""
        dict_path = os.path.join(root, "dict.txt") if root else ""
        if dict_path and os.path.exists(dict_path):
            return Dictionary.load(dict_path)
        d = Dictionary()
        train_tsv = os.path.join(root, "train.tsv") if root else ""
        if train_tsv and os.path.exists(train_tsv):
            for r in read_translation_manifest(train_tsv):
                for tok in r.get("tgt_text", "").split():
                    d.add_symbol(tok)
        else:  # synthetic configurations size the embedding by vocab_size
            for i in range(self._vocab_size() - 4):
                d.add_symbol(str(i))
        return d

    def is_fastspeech(self) -> bool:
        return self.args.arch in FASTSPEECH2_ARCHS

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        rows = read_translation_manifest(os.path.join(self.data_path(epoch), f"{split}.tsv"))
        self.datasets[split] = TextToSpeechDataset(rows, self.src_dict,
                                                   is_train=split.startswith("train"),
                                                   seed=self.args.seed)

    def build_model(self):
        a = self.args
        vocab = getattr(a, "vocab_size", None) or len(self.src_dict)
        if self.is_fastspeech():
            return FastSpeech2Module(
                vocab_size=vocab, dim=a.encoder_embed_dim, ffn_dim=a.encoder_ffn_embed_dim,
                encoder_layers=a.encoder_layers, decoder_layers=a.decoder_layers,
                heads=a.encoder_attention_heads, n_mels=a.output_frame_dim,
                max_frames=a.max_target_positions or 2048)
        k = a.n_frames_per_step
        return TTSTransformerModule(
            vocab_size=vocab, dim=a.encoder_embed_dim, ffn_dim=a.encoder_ffn_embed_dim,
            encoder_layers=a.encoder_transformer_layers,
            decoder_layers=a.decoder_transformer_layers, heads=a.encoder_attention_heads,
            dropout=a.dropout, out_dim=a.output_frame_dim * k, n_frames_per_step=k,
            conv_layers=a.encoder_conv_layers, conv_kernel=a.encoder_conv_kernel_size,
            conv_dropout=a.encoder_dropout, prenet_layers=a.prenet_layers,
            prenet_dim=a.prenet_dim, prenet_dropout=a.prenet_dropout,
            postnet_layers=a.postnet_layers, postnet_dim=a.postnet_conv_dim,
            postnet_kernel=a.postnet_conv_kernel_size, postnet_dropout=a.postnet_dropout)

    def build_criterion(self):
        if self.is_fastspeech():
            return CRITERIONS[self.args.criterion]()
        return CRITERIONS[self.args.criterion](self.args.bce_pos_weight)

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 16) -> Dict:
        """A synthetic batch from a generator seeded 0 (JAX
        tts_task.py:179-198): max(seq_len // 4, 2) tokens and seq_len frames a
        row (the rows after the first 2 frames shorter), uniform durations
        summing to seq_len, normal pitches and energies."""
        rng = np.random.default_rng(0)
        vocab, d = self._vocab_size(), self.args.output_frame_dim
        s, t = max(seq_len // 4, 2), seq_len
        src = rng.integers(4, vocab, size=(batch_size, s)).astype(np.int32)
        feat = rng.normal(size=(batch_size, t, d)).astype(np.float32)
        t_lens = np.full((batch_size,), t, np.int32)
        t_lens[1:] = max(t - 2, 1)
        prev = np.zeros_like(feat)
        prev[:, 1:] = feat[:, :-1]
        dur = np.full((batch_size, s), t // s, np.int32)
        dur[:, -1] += t - (t // s) * s
        return {"src_tokens": src, "src_lengths": np.full((batch_size,), s, np.int32),
                "feat_tgt": feat, "tgt_lengths": t_lens, "prev_feats": prev,
                "tgt_mask": np.arange(t)[None, :] < t_lens[:, None], "durations": dur,
                "pitches": rng.normal(size=(batch_size, s)).astype(np.float32),
                "energies": rng.normal(size=(batch_size, s)).astype(np.float32),
                "ntokens": int(t_lens.sum()), "nsentences": batch_size}


class DummyTTSTask(TextToSpeechTask):
    """`dataset_size` identical batches of `dummy_batch(batch_size,
    tokens_per_sample)` (defaults 8, 4 and 16, JAX's), as a list, over a
    dictionary of `vocab_size` symbols."""

    synthetic = True

    def _build_dict(self) -> Dictionary:
        d = Dictionary()
        for i in range(self._vocab_size() - 4):
            d.add_symbol(str(i))
        return d

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        a = self.args
        batch = self.dummy_batch(getattr(a, "batch_size", None) or 4,
                                 getattr(a, "tokens_per_sample", None) or 16)
        self.datasets[split] = [batch] * (getattr(a, "dataset_size", None) or 8)
