"""HuBERT pretraining, "hubert_pretraining" (the port of
diffnorm_tpu/tasks/hubert_pretrain_task.py; reference
fairseq/tasks/hubert_pretraining.py): the wav2vec-style manifest
`{split}.tsv` and the frame labels `{split}.{label}` (--labels, default km;
under --label-dir, default DATA) through `dict.{label}.txt` there, else the
unit dictionary of --target-code-size units (`data/hubert_dataset.py`).
Models: `models/hubert.py:HubertPretrainModule` (hubert, hubert_base,
hubert_large), criterion "hubert".

`prepare_batch` draws each batch's span mask on the host over the frames
that have a label (`utils/masking.py:compute_mask_indices`, min_masks 2,
--mask-prob, --mask-length, --mask-selection, --mask-other,
--no-mask-overlap, --mask-min-space) from the generator it is given, as
JAX's does. `DummyHubertTask` ("dummy_hubert") serves `dataset_size` copies
of `dummy_batch(batch_size, tokens_per_sample)` (defaults 4, 2, 8000), in
process.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from diffnorm_tpu_torch.criterions.hubert_loss import HubertLoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.hubert_dataset import HubertPretrainDataset, host_frames_for_samples
from diffnorm_tpu_torch.models.hubert import (
    HubertPretrainModule,
    build_hubert_pretrain,
    parse_conv_spec,
)
from diffnorm_tpu_torch.tasks.base import Task
from diffnorm_tpu_torch.tasks.cmlm_cg_task import dummy_dataset
from diffnorm_tpu_torch.utils.masking import compute_mask_indices


def model_config(args) -> dict:
    """The model's config from cli.train's flags (--activation-dropout is
    stored as relu_dropout)."""
    return {**vars(args), "activation_dropout": args.relu_dropout}


def span_mask(args, shape, padding, rng: np.random.Generator, **kw) -> np.ndarray:
    """compute_mask_indices with the --mask-* flags (min_masks 2), the
    padded frames cleared."""
    return compute_mask_indices(
        shape, padding, mask_prob=args.mask_prob, mask_length=args.mask_length,
        mask_type=args.mask_selection, mask_other=args.mask_other, min_masks=2,
        no_overlap=args.no_mask_overlap, min_space=args.mask_min_space, rng=rng,
        **kw) & ~padding


def frame_padding(args, batch: Dict) -> np.ndarray:
    """[B, F] bool of a waveform batch's conv frames, True past each row's
    length (the frames its valid samples do not reach)."""
    conv = parse_conv_spec(args.conv_feature_layers)
    n = host_frames_for_samples(batch["src_tokens"].shape[1], conv)
    valid = np.asarray([host_frames_for_samples(int(x), conv) for x in batch["src_lengths"]])
    return np.arange(n)[None, :] >= valid[:, None]


def pretrain_dataset(args, manifest: str, split: str, **kw) -> HubertPretrainDataset:
    """The split's manifest cropped as the flags say (the labels in `kw`)."""
    return HubertPretrainDataset.from_manifest(
        manifest, conv_layers=parse_conv_spec(args.conv_feature_layers),
        max_sample_size=args.max_sample_size, min_sample_size=args.min_sample_size,
        sample_rate=args.sample_rate, normalize=args.normalize,
        is_train=split.startswith("train"), random_crop=args.random_crop, **kw)


class HubertPretrainingTask(Task):
    def __init__(self, args):
        super().__init__(args)
        label_dir = args.label_dir or args.data
        path = os.path.join(str(label_dir), f"dict.{args.labels}.txt") if label_dir else None
        self.tgt_dict = (Dictionary.load(path) if path and os.path.exists(path)
                         else Dictionary.unit_dictionary(args.target_code_size))

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        root = self.data_path(epoch)
        label_dir = str(self.args.label_dir or root)
        self.datasets[split] = pretrain_dataset(
            self.args, os.path.join(root, f"{split}.tsv"), split,
            label_file=os.path.join(label_dir, f"{split}.{self.args.labels}"),
            tgt_dict=self.tgt_dict, label_rate=self.args.label_rate)

    def build_model(self) -> HubertPretrainModule:
        return build_hubert_pretrain(model_config(self.args),
                                     self.args.num_classes or len(self.tgt_dict))

    def build_criterion(self) -> HubertLoss:
        a = self.args
        return HubertLoss(a.pred_masked_weight, a.pred_nomask_weight, a.loss_weights)

    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """The span mask over the frames with a label (JAX :86-107)."""
        target = batch["target"]
        batch["mask_indices"] = span_mask(self.args, target.shape, ~(target >= 0), rng)
        return batch

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 8000) -> Dict:
        """JAX's (:118-138): a generator seeded 0, labels in [4, K) over the
        valid frames, prepared."""
        conv = parse_conv_spec(self.args.conv_feature_layers)
        rng = np.random.default_rng(0)
        frames = host_frames_for_samples(seq_len, conv)
        lengths = np.full((batch_size,), seq_len, np.int32)
        lengths[-1] = max(seq_len * 3 // 4, 1)
        target = rng.integers(4, len(self.tgt_dict), size=(batch_size, frames)).astype(np.int64)
        for i, n in enumerate(lengths):
            target[i, host_frames_for_samples(int(n), conv):] = -1
        batch = {"src_tokens": rng.normal(size=(batch_size, seq_len)).astype(np.float32) * 0.1,
                 "src_lengths": lengths, "target": target, "ntokens": int((target >= 0).sum()),
                 "nsentences": batch_size}
        return self.prepare_batch(batch, rng)


class DummyHubertTask(HubertPretrainingTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 8000, default_batch=2, default_size=4)
