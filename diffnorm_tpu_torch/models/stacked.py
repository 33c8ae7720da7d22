"""Stacked units (n_frames_per_step = k > 1), the port's copy of
diffnorm_tpu/models/stacked.py and of `stack_target`
(diffnorm_tpu/tasks/ar_s2ut_task.py:22-58; reference fairseq
stacked_embedding.py and tasks/speech_to_speech.py's stacked data path).

k consecutive units pack into one dictionary id, base V above the 4
specials: id = sum_i u_i * V^(k-1-i) + 4. The packing is int64 throughout.
JAX packs in int32, which wraps once V^k + 4 >= 2^31 (k >= 4 at the released
V = 1000): `pack_units([[999] * 4], 1000, 4)` gives -727379965 there, which
`unpack_units` then passes through as a special. Here it is
1,000,000,000,003 and round-trips (pinned in tests/test_torch_stacked.py).

`stack_unit_generate` is the greedy stacked AR generation (JAX's, fairseq's
StackUnitSequenceGenerator): k sub-frames a decoder step, the step's packed
id fed back, a row finished at the first step with EOS in any sub-frame.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from diffnorm_tpu_torch.models.layers import Dense

PAD, BOS, EOS, UNK = 1, 0, 2, 3
OFFSET = 4  # the specials


def _scale(vocab_size: int, n: int, device=None) -> torch.Tensor:
    return torch.tensor([vocab_size ** (n - 1 - i) for i in range(n)], dtype=torch.int64,
                        device=device)


def pack_units(units: torch.Tensor, vocab_size: int, n: int) -> torch.Tensor:
    """units [..., n] raw unit ids (0..V-1) -> packed dictionary ids [...],
    int64."""
    return (units.long() * _scale(vocab_size, n, units.device)).sum(dim=-1) + OFFSET


def unpack_units(tokens: torch.Tensor, vocab_size: int, n: int) -> torch.Tensor:
    """Packed dictionary ids [...] -> [..., n] dictionary ids of the
    sub-units; a special passes through unchanged in every slot
    (StackedEmbedding.forward parity)."""
    tokens = tokens.long()
    is_unit = tokens >= OFFSET
    val = torch.clamp(tokens - OFFSET, min=0)
    outs = [torch.where(is_unit, (val // vocab_size ** (n - 1 - i)) % vocab_size + OFFSET, tokens)
            for i in range(n)]
    return torch.stack(outs, dim=-1)


def stack_target(target: np.ndarray, vocab_size: int, k: int):
    """Pack a full-rate unit target for n_frames_per_step = k training.

    target: [B, L] left-aligned rows of unit ids (>= 4), one EOS, then PAD.
    Returns (packed [B, T], sub [B, T, k]), both int64: k consecutive units
    collapse into one packed id for the decoder's input side; `sub` keeps
    the per-sub-frame ids for the [B, T, k, V] loss, with the EOS step
    broadcast to every sub-frame and PAD elsewhere. A row whose unit count
    is not a multiple of k repeats its last unit to fill the final frame."""
    b, _ = target.shape
    m = (target >= OFFSET).sum(axis=1)  # real units per row
    n_steps = -(-m // k)  # ceil
    t = int(n_steps.max()) + 1  # +1 for the EOS step
    w = (t - 1) * k

    rows = np.arange(b)[:, None]
    idx = np.minimum(np.arange(w)[None, :], np.maximum(m - 1, 0)[:, None])
    gathered = target[rows, idx].astype(np.int64)  # the last unit repeats past m
    in_frame = np.arange(w)[None, :] < (n_steps * k)[:, None]
    sub_raw = np.where(in_frame, gathered - OFFSET, 0).reshape(b, t - 1, k)

    scale = np.array([vocab_size ** (k - 1 - i) for i in range(k)], dtype=np.int64)
    frame_valid = np.arange(t - 1)[None, :] < n_steps[:, None]
    packed = np.full((b, t), PAD, dtype=np.int64)
    packed[:, :-1] = np.where(frame_valid, (sub_raw * scale).sum(-1) + OFFSET, PAD)
    packed[np.arange(b), n_steps] = EOS

    sub = np.full((b, t, k), PAD, dtype=np.int64)
    sub[:, :-1] = np.where(frame_valid[..., None], sub_raw + OFFSET, PAD)
    sub[np.arange(b), n_steps] = EOS
    return packed, sub


class StackedEmbedding(nn.Module):
    """A packed token -> one embedding: each sub-unit through the `embed`
    table (V + 4 rows), the k embeddings concatenated and projected back to
    embed_dim by `project_in_dim` (no bias). With num_stacked = 1 the table
    alone."""

    def __init__(self, num_embeddings: int, embed_dim: int, num_stacked: int = 1):
        super().__init__()
        self.num_stacked = num_stacked
        self.embed = nn.Embedding(num_embeddings, embed_dim)
        nn.init.normal_(self.embed.weight, std=embed_dim ** -0.5)
        if num_stacked > 1:
            self.project_in_dim = Dense(num_stacked * embed_dim, embed_dim, bias=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.num_stacked == 1:
            return self.embed(tokens)
        sub = unpack_units(tokens, self.embed.num_embeddings - OFFSET, self.num_stacked)
        e = self.embed(sub)  # [..., n, D]
        return self.project_in_dim(e.reshape(e.shape[:-2] + (-1,)))


@torch.no_grad()
def stack_unit_generate(decode_step: Callable, batch_size: int, vocab_size: int,
                        n_frames_per_step: int, max_len: int = 256, init_state=None,
                        device=None):
    """Greedy stacked-unit generation (JAX models/stacked.py:73-114).

    decode_step(state, prev_packed [B], position [B]) -> (logits [B, k,
    V + 4], state). Each step takes every sub-frame's argmax with PAD and
    UNK banned; a row whose sub-frames hold an EOS finishes, that step and
    every later one giving PAD, and is fed EOS from then on, as JAX's
    frozen rows. The loop stops once every row has finished (one host sync
    a step): the steps JAX still runs give PAD only. Returns (packed tokens
    [B, max_len], sub-units [B, max_len, k]), int64."""
    k = n_frames_per_step
    packed_seq = torch.full((batch_size, max_len), PAD, dtype=torch.int64, device=device)
    sub_seq = torch.full((batch_size, max_len, k), PAD, dtype=torch.int64, device=device)
    prev = torch.full((batch_size,), EOS, dtype=torch.int64, device=device)
    finished = torch.zeros(batch_size, dtype=torch.bool, device=device)
    state = init_state
    for step in range(max_len):
        logits, state = decode_step(state, prev, torch.full_like(prev, step))
        lp = torch.log_softmax(logits.float(), dim=-1)
        lp[..., PAD] = -float("inf")
        lp[..., UNK] = -float("inf")
        sub = lp.argmax(dim=-1)  # [B, k]
        done = finished | (sub == EOS).any(dim=-1)
        packed = pack_units(torch.clamp(sub - OFFSET, min=0), vocab_size, k)
        packed_seq[:, step] = torch.where(done, PAD, packed)
        sub_seq[:, step] = torch.where(done[:, None], PAD, sub)
        prev = torch.where(done, EOS, packed)
        finished = done
        if bool(finished.all()):
            break
    return packed_seq, sub_seq
