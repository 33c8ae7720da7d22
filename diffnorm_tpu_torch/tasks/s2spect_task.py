"""Speech-to-spectrogram S2ST training ("speech_to_speech_spect", and
"speech_to_speech" without --target-is-code; the port of
diffnorm_tpu/tasks/s2spect_task.py; reference fairseq/tasks/speech_to_speech.py
with target_is_code False): fbank sources, mel-spectrogram targets,
teacher-forced on the targets shifted right behind a zero frame, the
Tacotron2 criterion, and the AR mel rollout in cli.generate.

`SpeechToSpectrogramDataset` reads a `{split}.tsv` whose `src_audio` and
`tgt_audio` are both `.npy` features or audio files (the fbank of
`data/audio.py`), under the data config's `audio_root`, with no feature
transforms, as JAX's. Its collater sorts a batch by descending source
length and pads sources and targets with zeros to the batch's longest:
src_tokens, src_lengths, feat_tgt, tgt_lengths, prev_feats, tgt_mask, and
the aux tasks' text targets under "multitask" (padded to the longest, at
least 1). `ordered_indices` sorts by descending source length, ties in a
shuffle seeded from `seed` on train splits.

The models are `s2spect_transformer`, `s2spect_transformer_fisher`,
`s2spect_conformer` (`models/s2spect.py`) and Translatotron2's
`s2spect2_conformer` (`models/s2spect2.py`, which needs the first-pass task
of --multitask-config-yaml); the criterions `criterions/tts_loss.py`'s.
`DummyS2SpectTask` ("dummy_s2spect") trains on identical synthetic batches
(`dummy_batch`), in process or through cli.train without DATA.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from diffnorm_tpu_torch.criterions.tts_loss import CRITERIONS
from diffnorm_tpu_torch.data.audio import get_features_or_waveform
from diffnorm_tpu_torch.data.manifest import read_translation_manifest
from diffnorm_tpu_torch.data.multitask import collate_text_targets
from diffnorm_tpu_torch.data.s2s_dataset import load_s2t_data_cfg
from diffnorm_tpu_torch.models.s2spect import ARCHS as S2SPECT_ARCHS
from diffnorm_tpu_torch.models.s2spect import S2SpecTModule
from diffnorm_tpu_torch.models.s2spect2 import ARCHS as S2SPECT2_ARCHS
from diffnorm_tpu_torch.models.s2spect2 import S2SpecT2Module
from diffnorm_tpu_torch.tasks.base import Task
from diffnorm_tpu_torch.tasks.multitask_mixin import MultitaskTaskMixin

ARCHS = {**S2SPECT_ARCHS, **S2SPECT2_ARCHS}


class SpeechToSpectrogramDataset:
    """Translation manifest rows whose both sides are audio or features
    (module docstring)."""

    def __init__(self, rows: List[Dict], root: str, data_cfg: Dict, is_train: bool = True,
                 seed: int = 1):
        self.rows, self.root, self.data_cfg = rows, root, data_cfg
        self.shuffle, self.seed = is_train, seed
        self.sizes = np.asarray([int(r.get("src_n_frames", 0) or 0) for r in rows], np.int64)
        self.multitask_data: Dict[str, Dict] = {}

    def add_multitask(self, name: str, text_data, decoder_type: str) -> None:
        """Join one aux task's per-sample text targets (TextTargetData)."""
        self.multitask_data[name] = {"data": text_data, "with_prev": decoder_type != "ctc"}

    @classmethod
    def from_tsv(cls, root: str, split: str, config_yaml: str = "config.yaml",
                 is_train: bool = True, seed: int = 1) -> "SpeechToSpectrogramDataset":
        rows = read_translation_manifest(os.path.join(root, f"{split}.tsv"))
        return cls(rows, root, load_s2t_data_cfg(root, config_yaml), is_train=is_train,
                   seed=seed)

    def __len__(self) -> int:
        return len(self.rows)

    def num_tokens(self, i: int) -> int:
        return int(self.sizes[i])

    def ordered_indices(self) -> np.ndarray:
        order = (np.random.default_rng(self.seed).permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        return np.lexsort((order, -self.sizes))

    def _load(self, path: str) -> np.ndarray:
        if not os.path.isabs(path):
            path = os.path.join(self.data_cfg.get("audio_root", self.root), path)
        return np.asarray(get_features_or_waveform(path), np.float32)

    def __getitem__(self, i: int) -> Dict:
        r = self.rows[i]
        sample = {"index": i, "source": self._load(r["src_audio"]),
                  "feat": self._load(r["tgt_audio"])}
        if self.multitask_data:
            sample["multitask"] = {}
            for name, mt in self.multitask_data.items():
                enc = mt["data"].get(r["id"])
                sample["multitask"][name] = np.zeros((0,), np.int32) if enc is None else enc
        return sample

    def collater(self, samples: List[Dict]) -> Dict:
        if not samples:
            return {}
        samples = sorted(samples, key=lambda s: s["source"].shape[0], reverse=True)
        s_lens = np.asarray([s["source"].shape[0] for s in samples], np.int32)
        t_lens = np.asarray([s["feat"].shape[0] for s in samples], np.int32)
        src = np.zeros((len(samples), int(s_lens.max()), samples[0]["source"].shape[1]),
                       np.float32)
        feat = np.zeros((len(samples), int(t_lens.max()), samples[0]["feat"].shape[1]),
                        np.float32)
        for i, s in enumerate(samples):
            src[i, :s_lens[i]] = s["source"]
            feat[i, :t_lens[i]] = s["feat"]
        prev = np.zeros_like(feat)
        prev[:, 1:] = feat[:, :-1]
        batch = {"id": np.asarray([s["index"] for s in samples], np.int64),
                 "src_tokens": src, "src_lengths": s_lens, "feat_tgt": feat,
                 "tgt_lengths": t_lens, "prev_feats": prev,
                 "tgt_mask": np.arange(feat.shape[1])[None, :] < t_lens[:, None],
                 "ntokens": int(t_lens.sum()), "nsentences": len(samples)}
        if self.multitask_data:
            batch["multitask"] = {}
            for name, mt in self.multitask_data.items():
                targets = [s["multitask"][name] for s in samples]
                batch["multitask"][name] = collate_text_targets(
                    targets, with_prev=mt["with_prev"],
                    pad_to=max(1, max(len(t) for t in targets)))
        return batch


class S2SpectTask(MultitaskTaskMixin, Task):
    tts_generation = True  # cli.generate's spectrogram branch

    def __init__(self, args):
        super().__init__(args)
        self._init_multitask(args)

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        ds = SpeechToSpectrogramDataset.from_tsv(self.data_path(epoch), split,
                                                 config_yaml=self.args.config_yaml,
                                                 is_train=split.startswith("train"))
        self.attach_multitask(ds, split)
        self.datasets[split] = ds

    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """The aux tasks' loss weights; draws nothing from `rng`."""
        self.inject_loss_weights(batch)
        return batch

    def build_model(self):
        a = self.args
        k = a.n_frames_per_step
        common = dict(in_channels=a.input_feat_per_channel, enc_dim=a.encoder_embed_dim,
                      enc_ffn_dim=a.encoder_ffn_embed_dim, enc_layers=a.encoder_layers,
                      enc_heads=a.encoder_attention_heads, conv_channels=a.conv_channels,
                      conv_kernel_sizes=a.conv_kernel_sizes,
                      depthwise_kernel_size=a.depthwise_conv_kernel_size,
                      dim=a.decoder_embed_dim, ffn_dim=a.decoder_ffn_embed_dim,
                      decoder_layers=a.decoder_transformer_layers,
                      heads=a.decoder_attention_heads, dropout=a.dropout,
                      out_dim=a.output_frame_dim * k, n_frames_per_step=k,
                      prenet_layers=a.prenet_layers, prenet_dim=a.prenet_dim,
                      prenet_dropout=a.prenet_dropout, postnet_layers=a.postnet_layers,
                      postnet_dim=a.postnet_conv_dim, postnet_kernel=a.postnet_conv_kernel_size,
                      postnet_dropout=a.postnet_dropout)
        if a.arch in S2SPECT2_ARCHS:
            mt_spec, others = self.first_pass_spec()
            return S2SpecT2Module(mt_spec=mt_spec,
                                  translation_decoder_layers=a.translation_decoder_layers,
                                  synthesizer_encoder_layers=a.synthesizer_encoder_layers,
                                  multitask=others, **common)
        return S2SpecTModule(encoder_type=a.encoder_type, **common)

    def build_criterion(self):
        name = self.args.criterion
        if name == "speech_to_spectrogram_2pass":
            return CRITERIONS[name](self.args.bce_pos_weight, multitask=self.multitask_tasks,
                                    mt_task_name=self.mt_task_name)
        return CRITERIONS[name](self.args.bce_pos_weight)

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 48) -> Dict:
        """A synthetic batch from a generator seeded 0 (JAX
        s2spect_task.py:180-200): sources [B, seq_len, F], targets of
        max(seq_len // 4, 8) frames."""
        rng = np.random.default_rng(0)
        t = max(seq_len // 4, 8)
        feat = rng.normal(size=(batch_size, t, self.args.output_frame_dim)).astype(np.float32)
        prev = np.zeros_like(feat)
        prev[:, 1:] = feat[:, :-1]
        t_lens = np.full((batch_size,), t, np.int32)
        return {"src_tokens": rng.normal(size=(batch_size, seq_len,
                                                self.args.input_feat_per_channel)
                                          ).astype(np.float32),
                "src_lengths": np.full((batch_size,), seq_len, np.int32),
                "feat_tgt": feat, "tgt_lengths": t_lens, "prev_feats": prev,
                "tgt_mask": np.arange(t)[None, :] < t_lens[:, None],
                "ntokens": int(t_lens.sum()), "nsentences": batch_size}


class DummyS2SpectTask(S2SpectTask):
    """`dataset_size` identical batches of `dummy_batch(batch_size,
    tokens_per_sample)`, as a list."""

    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        a = self.args
        batch = self.dummy_batch(getattr(a, "batch_size", None) or 2,
                                 getattr(a, "tokens_per_sample", None) or 48)
        self.datasets[split] = [batch] * (getattr(a, "dataset_size", None) or 4)
