"""The Levenshtein transformer, an insertion / deletion NAT (the port of
diffnorm_tpu/models/levenshtein.py; reference
fairseq/models/nat/levenshtein_transformer.py and levenshtein_utils.py).

`LevenshteinDecoder` is one pre-norm NAT decoder body (the NAR S2UT
model's `DecoderLayer`s, full-context self-attention, every dropout
`dropout`) with three heads over its final features: the words
(x @ embed^T, the tied output), deletion (`del_head`, keep 0 / delete 1 a
token) and insertion (`ins_head` over each adjacent pair's concatenated
features: how many placeholders, 0..MAX_INS - 1, go between them).
`LevenshteinModule` puts `models/cmlm_text.py`'s `TextEncoder` before it;
its training forward scores three host-made canvases (the task's
`prev_del`, `prev_kept`, `prev_ins`), one decoder pass each.

`edit_path_targets` gives the deletion and insertion supervision of any
canvas against its target by an LCS alignment on the host (JAX's C++
`edit_path_batch`, or its numpy loop: the same alignment), here with the
dynamic programme's rows vectorized in numpy.

`levenshtein_decode` is JAX's `levenshtein_decode_jit`, the decode
cli.generate runs: `max_iter` iterations of delete, insert placeholders and
fill on a static [B, max_len] canvas that starts as [BOS, EOS], each step a
decoder pass over the canvas it changes (`apply_del_words`,
`apply_ins_masks`: the left-packing and the insertions clipped to the
canvas's width); specials are banned from the fill; a row whose canvas
repeats is frozen. It stops once every row is frozen, which gives the
fixed-trip scan's output. A list of models (fairseq's --path a:b) averages
each head's log-probs as logsumexp minus log M.

On the card the decoder's encoder attention over a source of >= 2048
tokens takes the flash-attention kernel in eval, in each of the three
passes of a decode iteration.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.generate.mask_predict import average_log_probs
from diffnorm_tpu_torch.models.cmlm_text import TextEncoder
from diffnorm_tpu_torch.models.conformer import layer_norm
from diffnorm_tpu_torch.models.layers import Dense, Dropout, arch_default, sinusoidal_positions
from diffnorm_tpu_torch.models.nar_transformer import DecoderLayer

PAD, BOS, EOS, UNK = 1, 0, 2, 3
MAX_INS = 256  # placeholder-count classes (the reference's 256)


def _align(p: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(deleted [len(p)] bool, the target index each kept token of `p`
    matches) of one LCS alignment, the backtrack of JAX's edit_path_batch:
    a match where the diagonal made the cell, else deletion of p's token
    where the cell above is at least the cell to the left."""
    pn, tn = len(p), len(t)
    dp = np.zeros((pn + 1, tn + 1), np.int64)
    for i in range(1, pn + 1):
        # dp[i, j] = max(dp[i-1, j], dp[i, j-1], dp[i-1, j-1] + 1 on a match):
        # the row's candidates, then a running max along j
        cand = np.where(p[i - 1] == t, dp[i - 1, :-1] + 1, dp[i - 1, 1:])
        dp[i, 1:] = np.maximum.accumulate(cand)
    deleted = np.zeros(pn, bool)
    match = np.full(pn, -1, np.int64)
    i, j = pn, tn
    while i > 0 and j > 0:
        if p[i - 1] == t[j - 1] and dp[i, j] == dp[i - 1, j - 1] + 1:
            match[i - 1] = j - 1
            i, j = i - 1, j - 1
        elif dp[i - 1, j] >= dp[i, j - 1]:
            deleted[i - 1] = True
            i -= 1
        else:
            j -= 1
    deleted[:i] = True
    return deleted, match


def edit_path_targets(prev: np.ndarray, tgt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side supervision of canvases prev [B, P] against targets [B, T]
    (each row's tokens the prefix before its first PAD): (del_tgt [B, P]
    int32, 1 where a token is deleted; ins_tgt [B, P + 1] int32, the target
    tokens inserted in each slot, slot k before the k-th kept token and the
    last after it)."""
    prev, tgt = np.asarray(prev, np.int32), np.asarray(tgt, np.int32)
    b, plen = prev.shape
    del_tgt = np.zeros((b, plen), np.int32)
    ins_tgt = np.zeros((b, plen + 1), np.int32)

    def prefix(row):
        pads = np.flatnonzero(row == PAD)
        return row[:pads[0]] if len(pads) else row

    for s in range(b):
        p, t = prefix(prev[s]), prefix(tgt[s])
        deleted, match = _align(p, t)
        del_tgt[s, :len(p)] = deleted
        kept = match[~deleted]
        # slot k counts the target tokens between kept tokens k - 1 and k
        ins_tgt[s, :len(kept) + 1] = np.diff(np.concatenate([[-1], kept, [len(t)]])) - 1
    return del_tgt, ins_tgt


class LevenshteinDecoder(nn.Module):
    """The NAT decoder body and its three heads (module docstring)."""

    def __init__(self, vocab_size: int, dim: int = 512, ffn_dim: int = 2048, layers: int = 6,
                 heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.dim, self.n_layers = dim, layers
        self.embed_tokens = nn.Embedding(vocab_size, dim)
        nn.init.normal_(self.embed_tokens.weight, std=dim ** -0.5)
        self.embed_dropout = Dropout(dropout)
        for i in range(layers):
            self.add_module(f"layer_{i}", DecoderLayer(dim, ffn_dim, heads, dropout, dropout,
                                                       dropout))
        self.layer_norm = layer_norm(dim)
        self.del_head = Dense(dim, 2)
        self.ins_head = Dense(2 * dim, MAX_INS)

    def features(self, tokens: torch.Tensor, enc: torch.Tensor,
                 enc_mask: torch.Tensor) -> torch.Tensor:
        valid = tokens != PAD
        x = self.embed_tokens(tokens) * math.sqrt(self.dim)
        x = self.embed_dropout(
            x + sinusoidal_positions(valid, self.dim, padding_idx=PAD).to(x.dtype))
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, valid, enc, enc_mask)
        return self.layer_norm(x)

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor):
        """tokens [B, T] -> (word logits [B, T, V], deletion logits [B, T, 2],
        insertion logits [B, T - 1, MAX_INS] over the adjacent slots)."""
        feats = self.features(tokens, enc, enc_mask)
        pair = torch.cat([feats[:, :-1], feats[:, 1:]], dim=-1)
        return (F.linear(feats, self.embed_tokens.weight), self.del_head(feats),
                self.ins_head(pair))


class LevenshteinModule(nn.Module):
    """Text encoder + Levenshtein decoder (module docstring)."""

    def __init__(self, src_vocab_size: int, tgt_vocab_size: int, dim: int = 512,
                 ffn_dim: int = 2048, encoder_layers: int = 6, decoder_layers: int = 6,
                 heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.vocab_size = tgt_vocab_size
        self.encoder = TextEncoder(src_vocab_size, dim, ffn_dim, encoder_layers, heads, dropout)
        self.decoder = LevenshteinDecoder(tgt_vocab_size, dim, ffn_dim, decoder_layers, heads,
                                          dropout)

    def encode(self, src_tokens: torch.Tensor, src_lengths=None, tgt_speaker=None):
        return self.encoder(src_tokens)

    def decode(self, tokens, enc, enc_mask):
        return self.decoder(tokens, enc, enc_mask)

    def forward(self, src_tokens: torch.Tensor, src_lengths: torch.Tensor,
                prev_del: torch.Tensor, prev_kept: torch.Tensor,
                prev_ins: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The training forward, one decoder pass a canvas: deletion logits
        of prev_del, insertion logits of prev_kept's slots, word logits of
        prev_ins."""
        enc, enc_mask = self.encoder(src_tokens)
        return {"del_logits": self.decoder(prev_del, enc, enc_mask)[1],
                "ins_logits": self.decoder(prev_kept, enc, enc_mask)[2],
                "word_logits": self.decoder(prev_ins, enc, enc_mask)[0]}


def levenshtein_transformer_arch(cfg: dict) -> None:
    """`levenshtein_transformer` (JAX levenshtein.py:244-247 and
    build_model's defaults, :224-234): 512 wide, FF 2048, 6 + 6 layers, 8
    heads."""
    for key, value in (("encoder_embed_dim", 512), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 6), ("decoder_layers", 6),
                       ("encoder_attention_heads", 8), ("dropout", 0.1)):
        arch_default(cfg, key, value)


ARCHS = {"levenshtein_transformer": levenshtein_transformer_arch}


def _left_pack(tokens: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The kept tokens of each row left-packed in order, PAD after:
    tokens / keep [B, L] -> [B, L]."""
    b, length = tokens.shape
    dest = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1, length)
    buf = torch.full((b, length + 1), PAD, dtype=tokens.dtype, device=tokens.device)
    return buf.scatter(1, dest, tokens)[:, :length]


def apply_del_words(canvas: torch.Tensor, del_pred: torch.Tensor) -> torch.Tensor:
    """Delete the tokens where del_pred is True, never BOS or EOS, PAD
    counted as deleted, and left-pack (reference
    levenshtein_utils._apply_del_words on a fixed-width canvas)."""
    special = (canvas == BOS) | (canvas == EOS)
    return _left_pack(canvas, (canvas != PAD) & (special | ~del_pred))


def apply_ins_masks(packed: torch.Tensor, n_ins: torch.Tensor) -> torch.Tensor:
    """Insert n_ins[b, j] UNK placeholders between real tokens j and j + 1
    of a left-packed canvas [B, L] (n_ins [B, L - 1]), the running total of
    insertions clipped to the width left (reference
    levenshtein_utils._apply_ins_masks on a fixed-width canvas)."""
    b, length = packed.shape
    valid = packed != PAD
    n_tok = valid.sum(dim=1)
    n_ins = torch.where(valid[:, :-1] & valid[:, 1:], n_ins, 0)
    cum = torch.minimum(torch.cumsum(n_ins, dim=1), (length - n_tok)[:, None])
    offset = F.pad(cum, (1, 0))  # insertions strictly before token j
    pos = torch.arange(length, device=packed.device)[None, :]
    dest = torch.where(valid, torch.clamp(pos + offset, max=length), length)
    buf = torch.full((b, length + 1), UNK, dtype=packed.dtype, device=packed.device)
    expanded = buf.scatter(1, dest, torch.where(valid, packed, UNK))[:, :length]
    return torch.where(pos < (n_tok + cum[:, -1])[:, None], expanded, PAD)


@torch.no_grad()
def levenshtein_decode(model, src: torch.Tensor, src_lengths: torch.Tensor,
                       max_iter: int = 10, max_len: int = 200,
                       eos_penalty: float = 0.0) -> torch.Tensor:
    """JAX's levenshtein_decode_jit (module docstring): `model` a
    `LevenshteinModule` or a list of them. Returns the canvas [B, max_len]
    int64."""
    models: Sequence = list(model) if isinstance(model, (list, tuple)) else [model]
    pairs = [m.encode(src, src_lengths) for m in models]
    b = src.shape[0]
    canvas = torch.full((b, max_len), PAD, dtype=torch.int64, device=src.device)
    canvas[:, 0], canvas[:, 1] = BOS, EOS
    finished = torch.zeros(b, dtype=torch.bool, device=src.device)

    def score(tokens, head: int):
        outs = [m.decode(tokens, e, mask)[head] for m, (e, mask) in zip(models, pairs)]
        if len(outs) == 1:
            return outs[0]
        return average_log_probs([torch.log_softmax(o.float(), dim=-1) for o in outs])

    for _ in range(max_iter):
        packed = apply_del_words(canvas, score(canvas, 1).argmax(-1) == 1)
        ins_logits = score(packed, 2)
        if eos_penalty > 0.0:  # the "insert nothing" class (reference :195-196)
            ins_logits[..., 0] -= eos_penalty
        expanded = apply_ins_masks(packed, ins_logits.argmax(-1))
        word_logits = score(expanded, 0)
        word_logits[..., :4] = -1e30  # the specials are never filled in
        new_canvas = torch.where(expanded == UNK, word_logits.argmax(-1), expanded)
        converged = (new_canvas == canvas).all(dim=1)
        canvas = torch.where(finished[:, None], canvas, new_canvas)
        finished = finished | converged
        if bool(finished.all()):
            break  # every later iteration leaves every row as it is
    return canvas
