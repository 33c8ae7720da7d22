"""The unit LM dataset (the port's copy of
diffnorm_tpu/data/unit_lm_dataset.py; reference fairseq's
token_block_utils_fast and the LM datasets): the unit sequences of the
translation manifests' targets, optionally concatenated and re-cut into
token blocks.

`slice_indices` gives the blocks' (start, end) token offsets under the four
break modes; `token_block_slices` is the fixed-window cut as (start doc,
start offset, end doc, end offset), here in numpy (JAX calls the same
algorithm in its native library). `UnitLMDataset` orders its items longest
first, ties in a permutation seeded `seed` for a training split and in index
order otherwise, and its collater pads with 0, as JAX's does: the unit LM
reads pad as 1, so a padded position counts as a `<s>` target there
(ROADMAP Queue 3; `tests/test_torch_unit_lm.py::
test_unit_lm_padding_fault_of_the_reference`).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.manifest import read_translation_manifest

BREAK_MODES = ("none", "complete", "complete_doc", "eos")


def token_block_slices(sizes: np.ndarray, block_size: int) -> np.ndarray:
    """[n_blocks, 4] (start_doc, start_off, end_doc, end_off) of the
    block_size windows over the concatenated documents."""
    sizes = np.asarray(sizes, np.int64)
    total = int(sizes.sum())
    n_blocks = (total + block_size - 1) // block_size
    out = np.zeros((n_blocks, 4), np.int64)
    doc = off = 0
    for blk in range(n_blocks):
        out[blk, :2] = doc, off
        remaining = min(block_size, total - blk * block_size)
        while remaining > 0 and doc < len(sizes):
            avail = int(sizes[doc]) - off
            if avail > remaining:
                off += remaining
                remaining = 0
            else:
                remaining -= avail
                doc, off = doc + 1, 0
        out[blk, 2:] = doc, off
    return out


def slice_indices(sizes: np.ndarray, break_mode: str, block_size: int,
                  document_sep_len: int = 1) -> np.ndarray:
    """[n_blocks, 2] (start, end) token offsets over the concatenated
    stream (fairseq's _get_slice_indices_fast):
    * none: fixed block_size windows across sequence boundaries;
    * complete: greedy groups of whole sequences up to block_size (a longer
      sequence alone);
    * complete_doc: the same without crossing a document separator (a
      sequence of document_sep_len tokens), groups of one token dropped;
    * eos: one sequence a block."""
    sizes = np.asarray(sizes, np.int64)
    if break_mode in (None, "none"):
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        quads = token_block_slices(sizes, block_size)
        out = np.zeros((len(quads), 2), np.int64)
        for i, (sd, so, ed, eo) in enumerate(quads):
            out[i] = offsets[sd] + so, (offsets[ed] + eo) if ed < len(sizes) else offsets[-1]
        return out
    pairs = []
    if break_mode == "complete":
        tok_idx = curr = 0
        for sz in sizes.tolist():
            if curr + sz <= block_size or curr == 0:
                curr += sz
            else:
                pairs.append((tok_idx, tok_idx + curr))
                tok_idx, curr = tok_idx + curr, sz
        if curr > 0:
            pairs.append((tok_idx, tok_idx + curr))
    elif break_mode == "complete_doc":
        tok_idx = curr = i = 0
        while i < len(sizes):
            sz = int(sizes[i])
            if (curr + sz <= block_size or curr == 0) and sz != document_sep_len:
                curr += sz
                i += 1
                continue
            if curr > 1:
                pairs.append((tok_idx, tok_idx + curr))
            tok_idx, curr = tok_idx + curr, 0
            if sz == document_sep_len:
                tok_idx += sz
                i += 1
        if curr > 1:
            pairs.append((tok_idx, tok_idx + curr))
    elif break_mode == "eos":
        cumsum = np.concatenate([[0], np.cumsum(sizes)])
        return np.stack([cumsum[:-1], cumsum[1:]], axis=1)
    else:
        raise ValueError(f"Invalid break_mode: {break_mode}")
    return np.asarray(pairs, np.int64).reshape(-1, 2)


class UnitLMDataset:
    def __init__(self, unit_seqs: List[np.ndarray], block_size: int = 0,
                 break_mode: str = "none", is_train: bool = True, seed: int = 1):
        """unit_seqs: dictionary-encoded int32 rows; `block_size` > 0 re-cuts
        their concatenation under `break_mode`."""
        if block_size:
            pairs = slice_indices([len(u) for u in unit_seqs], break_mode, block_size)
            flat = np.concatenate(unit_seqs) if unit_seqs else np.zeros(0, np.int32)
            unit_seqs = [flat[a:b] for a, b in pairs]
        self.unit_seqs = unit_seqs
        self.shuffle, self.seed = is_train, seed
        self.sizes = np.asarray([len(u) for u in unit_seqs], np.int64)

    def __len__(self) -> int:
        return len(self.unit_seqs)

    def num_tokens(self, index: int) -> int:
        return int(self.sizes[index])

    def ordered_indices(self) -> np.ndarray:
        order = (np.random.default_rng(self.seed).permutation(len(self)) if self.shuffle
                 else np.arange(len(self)))
        return np.lexsort((order, -self.sizes))

    def __getitem__(self, index: int) -> Dict:
        return {"index": index, "units": self.unit_seqs[index]}

    def collater(self, samples: List[Dict]) -> Dict:
        lens = np.asarray([len(s["units"]) for s in samples], np.int32)
        out = np.zeros((len(samples), int(lens.max())), np.int32)  # pad 0, as JAX's
        for i, s in enumerate(samples):
            out[i, :lens[i]] = s["units"]
        return {"id": np.asarray([s["index"] for s in samples], np.int64),
                "target_unit": out, "target_lengths": lens, "ntokens": int(lens.sum()),
                "nsentences": len(samples)}

    @classmethod
    def from_tsv(cls, root: str, split: str, tgt_dict: Dictionary, max_positions: int = 1024,
                 block_size: int = 0, break_mode: str = "none", is_train: bool = True,
                 seed: int = 1) -> "UnitLMDataset":
        """The `tgt_audio` unit strings of `{root}/{split}.tsv`, encoded
        without </s> and cut to `max_positions`."""
        rows = read_translation_manifest(os.path.join(root, f"{split}.tsv"))
        seqs = [tgt_dict.encode_line(r["tgt_audio"], append_eos=False)[:max_positions]
                .astype(np.int32) for r in rows]
        return cls(seqs, block_size=block_size, break_mode=break_mode, is_train=is_train,
                   seed=seed)
