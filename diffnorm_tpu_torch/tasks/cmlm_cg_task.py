"""The text CMLM-CG task, "cmlm_cg" (the port of
diffnorm_tpu/tasks/cmlm_cg_task.py; reference fairseq/tasks/cmlm_cg.py):
classifier-free-guided CMLM text translation on bitext pairs, with the NAR
S2UT task's canvases (`random_mask`, and `side_mask` with --use-side) drawn
from the numpy generator each batch is given, exactly as JAX's.

`BitextDataset` reads a directory of `{split}.{src}` / `{split}.{tgt}` line
files through the dictionaries (an unknown token is <unk>, </s> appended),
or cli.preprocess's binarized pairs `{split}.{src}-{tgt}.{lang}.bin/.idx`
(`data/indexed_dataset.py`, any of its layouts) where they exist. Its order
is JAX's: by source length, longest first, ties in a permutation seeded 1
for the training split and in index order otherwise; its collater pads the
sources and targets to their longest row.

The dictionaries: --src-dict and --tgt-dict-path where given, else the
`dict.{lang}.txt` files of the first data directory (what cli.preprocess
writes), else unit dictionaries of --src-vocab-size - 4 (default 1000 - 4)
and --target-code-size symbols (JAX's `_find`, cmlm_cg_task.py:121-135).
--source-lang and --target-lang default to src and tgt.

`DummyCMLMCGTask` ("dummy_cmlm_cg") trains on `dataset_size` copies of
`dummy_batch(batch_size, tokens_per_sample)` (defaults 8, 4, 16), in
process; cli.train takes no dummy task.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.indexed_dataset import IndexedDataset
from diffnorm_tpu_torch.models.cmlm_text import TextCMLMModule
from diffnorm_tpu_torch.tasks.nar_s2ut_task import NARS2UTTask

PAD, EOS = 1, 2


class BitextDataset:
    """Parallel token sequences (module docstring)."""

    def __init__(self, src_seqs, tgt_seqs, seed: int = 1, is_train: bool = True, sizes=None):
        self.src_seqs, self.tgt_seqs = src_seqs, tgt_seqs
        self.shuffle, self.seed = is_train, seed
        self.sizes = (np.asarray(sizes, np.int64) if sizes is not None
                      else np.asarray([len(s) for s in src_seqs], np.int64))

    def __len__(self) -> int:
        return len(self.src_seqs)

    def num_tokens(self, i: int) -> int:
        return int(self.sizes[i])

    def ordered_indices(self) -> np.ndarray:
        order = (np.random.default_rng(self.seed).permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        return np.lexsort((order, -self.sizes))

    def __getitem__(self, i: int) -> Dict:
        return {"index": i, "src": self.src_seqs[i], "tgt": self.tgt_seqs[i]}

    def collater(self, samples: List[Dict]) -> Dict:
        s_lens = np.asarray([len(s["src"]) for s in samples], np.int32)
        t_lens = np.asarray([len(s["tgt"]) for s in samples], np.int32)
        src = np.full((len(samples), int(s_lens.max())), PAD, np.int32)
        tgt = np.full((len(samples), int(t_lens.max())), PAD, np.int32)
        for i, s in enumerate(samples):
            src[i, :s_lens[i]] = s["src"]
            tgt[i, :t_lens[i]] = s["tgt"]
        return {"id": np.asarray([s["index"] for s in samples], np.int64),
                "src_tokens": src, "src_lengths": s_lens, "target": tgt,
                "target_lengths": t_lens, "ntokens": int(t_lens.sum()),
                "nsentences": len(samples)}

    @classmethod
    def from_files(cls, root: str, split: str, src_lang: str, tgt_lang: str,
                   src_dict: Dictionary, tgt_dict: Dictionary, is_train: bool = True,
                   seed: int = 1) -> "BitextDataset":
        def read(path, d):
            with open(path) as f:
                return [d.encode_line(line.strip()) for line in f]

        return cls(read(os.path.join(root, f"{split}.{src_lang}"), src_dict),
                   read(os.path.join(root, f"{split}.{tgt_lang}"), tgt_dict),
                   is_train=is_train, seed=seed)

    @staticmethod
    def binarized_prefix(root: str, split: str, src_lang: str, tgt_lang: str,
                         lang: Optional[str] = None) -> str:
        return os.path.join(root, f"{split}.{src_lang}-{tgt_lang}.{lang or src_lang}")

    @classmethod
    def from_binarized(cls, root: str, split: str, src_lang: str, tgt_lang: str,
                       is_train: bool = True, seed: int = 1) -> "BitextDataset":
        """cli.preprocess's pairs (</s> already appended), read lazily."""
        src = IndexedDataset(cls.binarized_prefix(root, split, src_lang, tgt_lang))
        tgt = IndexedDataset(cls.binarized_prefix(root, split, src_lang, tgt_lang, tgt_lang))
        if len(src) != len(tgt):
            raise ValueError(f"{split}: {len(src)} source and {len(tgt)} target sequences")
        return cls(src, tgt, is_train=is_train, seed=seed, sizes=src.sizes)


class CMLMCGTask(NARS2UTTask):
    def __init__(self, args):
        super().__init__(args)
        a = self.args
        self.src_lang, self.tgt_lang = a.source_lang or "src", a.target_lang or "tgt"
        root = (a.data or "").split(":")[0]

        def find(flag_path: Optional[str], lang: str) -> Optional[str]:
            # the flag, else the dict.{lang}.txt a preprocess run leaves
            if flag_path:
                return flag_path
            path = os.path.join(root, f"dict.{lang}.txt") if root else ""
            return path if path and os.path.exists(path) else None

        src_path, tgt_path = find(a.src_dict, self.src_lang), find(a.tgt_dict_path, self.tgt_lang)
        self.src_dict = (Dictionary.load(src_path) if src_path
                         else Dictionary.unit_dictionary((a.src_vocab_size or 1000) - 4))
        if tgt_path:
            self.tgt_dict = Dictionary.load(tgt_path)

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        root, is_train = self.data_path(epoch), split.startswith("train")
        prefix = BitextDataset.binarized_prefix(root, split, self.src_lang, self.tgt_lang)
        if root and os.path.exists(prefix + ".idx"):
            ds = BitextDataset.from_binarized(root, split, self.src_lang, self.tgt_lang,
                                              is_train=is_train)
        else:
            ds = BitextDataset.from_files(root, split, self.src_lang, self.tgt_lang,
                                          self.src_dict, self.tgt_dict, is_train=is_train)
        self.datasets[split] = ds

    def model_widths(self) -> Dict:
        """The model's vocabularies and widths from the arguments."""
        a = self.args
        return dict(src_vocab_size=a.src_vocab_size or len(self.src_dict),
                    tgt_vocab_size=len(self.tgt_dict), dim=a.encoder_embed_dim,
                    ffn_dim=a.encoder_ffn_embed_dim, encoder_layers=a.encoder_layers,
                    decoder_layers=a.decoder_layers, heads=a.encoder_attention_heads,
                    dropout=a.dropout)

    def build_model(self) -> TextCMLMModule:
        return TextCMLMModule(cg_prob=self.args.cg_prob, **self.model_widths())

    def build_criterion(self) -> NARSpeechToUnitLoss:
        return NARSpeechToUnitLoss(self.args.label_smoothing)

    def random_pair(self, batch_size: int, seq_len: int, rng: np.random.Generator):
        """Source and target rows of random non-special tokens, the
        targets ending in EOS (JAX's dummy_batch draws)."""
        src = rng.integers(4, len(self.src_dict), size=(batch_size, seq_len)).astype(np.int32)
        tgt = rng.integers(4, len(self.tgt_dict), size=(batch_size, seq_len)).astype(np.int32)
        tgt[:, -1] = EOS
        return src, tgt

    def dummy_batch(self, batch_size: int = 2, seq_len: int = 16) -> Dict:
        """A synthetic batch from a generator seeded 0, prepared (JAX
        cmlm_cg_task.py:150-165)."""
        rng = np.random.default_rng(0)
        src, tgt = self.random_pair(batch_size, seq_len, rng)
        return self.prepare_batch({"src_tokens": src,
                                   "src_lengths": np.full((batch_size,), seq_len, np.int32),
                                   "target": tgt}, rng)


def dummy_dataset(task, default_len: int, default_batch: int = 4, default_size: int = 8) -> list:
    """`dataset_size` copies of the task's `dummy_batch(batch_size,
    tokens_per_sample)` (JAX's _SyntheticDataset, whose batches are all
    drawn from a generator seeded 0), as a list; the defaults are the JAX
    dummy task's."""
    a = task.args
    batch = task.dummy_batch(getattr(a, "batch_size", None) or default_batch,
                             getattr(a, "tokens_per_sample", None) or default_len)
    return [batch] * (getattr(a, "dataset_size", None) or default_size)


class DummyCMLMCGTask(CMLMCGTask):
    synthetic = True

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        self.datasets[split] = dummy_dataset(self, 16)
