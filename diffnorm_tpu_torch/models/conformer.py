"""Conformer speech encoder with ESPnet-style relative-position attention
(PyTorch, batch-first [B, T, C]).

Counterpart of diffnorm_tpu/models/conformer.py (reference
s2t_conformer.py / conformer_layer.py / espnet_multihead_attention.py):
  Conv1dSubsampler: two stride-2 GLU convs (4x temporal downsample)
  per layer: 0.5 * macaron FFN -> rel-pos MHA -> conv module (GLU pointwise,
  depthwise k=31, BatchNorm, SiLU) -> 0.5 * FFN -> LayerNorm
Submodule and parameter names follow the flax tree (`weights.py` maps
`kernel` / `scale` and the BatchNorm statistics). Every LayerNorm uses flax's
epsilon 1e-6 (torch's default is 1e-5). Each module computes in the dtype of
its weights; attention scores, softmax and probs @ v are f32, as in JAX.

In training mode (JAX's `deterministic=False`) the dropouts of JAX's modules
apply: after the input projection, on the FFN's activation
(`activation_dropout`) and output, on the attention probabilities
(`attention_dropout`) and output, and on the conv module's output; the
rates left None fall back to `dropout`. Each draws from its module's
`generator` (`layers.set_dropout_generator`). BatchNorm normalizes with the
batch's statistics and updates its running ones, as flax's does.

`remat` (JAX's `encoder_remat`, nn.remat around each ConformerLayer)
recomputes each layer's activations in the backward instead of keeping them
(`torch.utils.checkpoint`, non-reentrant), in training with gradients only.
The recompute replays the forward's dropout draws: each explicit generator
the layer draws from is set back to its state at the layer's forward, and
after the recompute to where the stream stood before it, so later draws
do not move (checkpoint's `preserve_rng_state` covers only the default
generators). BatchNorm keeps the forward's update of its running
statistics: the recompute normalizes with the same batch statistics and
leaves the running ones alone, as flax keeps the forward's `batch_stats`.

`quant` (JAX's `quant` through the encoder, inference only) makes the
attention's q, k, v and out projections and both FFNs' w_1 and w_2 int8
W8A8 `Dense` sites with JAX's default knobs; q, k and v each quantize their
(same) input at their own site, as JAX's QDense do. `linear_pos`, the conv
module, the subsampler and the input projection stay float.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffnorm_tpu_torch.models.layers import Dense, Dropout, DropoutSite
from diffnorm_tpu_torch.ops.attention import apply_dropout
from diffnorm_tpu_torch.parallel.mesh import active_split, all_reduce_grad, global_sum

LN_EPS = 1e-6  # flax nn.LayerNorm


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def subsampled_lengths(lengths: torch.Tensor, n_layers: int = 2) -> torch.Tensor:
    """floor((len - 1) / 2 + 1) per stride-2 conv layer (f32, as in JAX)."""
    out = lengths
    for _ in range(n_layers):
        out = torch.floor((out.float() - 1) / 2 + 1).to(torch.int32)
    return out


class Conv1d(nn.Conv1d):
    """A conv over [B, T, C] (flax nn.Conv's layout), input cast to the
    weight's dtype; `weight` is torch's [out, in / groups, k]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).transpose(1, 2)
        return super().forward(x).transpose(1, 2)


class Conv1dSubsampler(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int = 1024,
                 out_channels: int = 512, kernel_sizes: Sequence[int] = (5, 5)):
        super().__init__()
        n = len(kernel_sizes)
        self.n_layers = n
        for i, k in enumerate(kernel_sizes):
            c_in = in_channels if i == 0 else mid_channels // 2
            c_out = mid_channels if i < n - 1 else out_channels * 2
            self.add_module(f"conv_{i}", Conv1d(c_in, c_out, k, stride=2, padding=k // 2))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """x: [B, T, C_in] -> ([B, T', out], new lengths)."""
        for i in range(self.n_layers):
            x = F.glu(getattr(self, f"conv_{i}")(x), dim=-1)  # GLU over channel halves
        return x, subsampled_lengths(lengths, self.n_layers)


def rel_positional_encoding(max_t: int, dim: int) -> np.ndarray:
    """[2*max_t - 1, dim] table; row i holds relative position (max_t-1 - i):
    positives first (descending), then negatives, ESPnet layout."""
    pos = np.arange(max_t, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * -(math.log(10000.0) / dim))
    pe_pos = np.zeros((max_t, dim), dtype=np.float32)
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((max_t, dim), dtype=np.float32)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    return np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T]: out[i, j] = x[i, j - i + T - 1]."""
    b, h, t, _ = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, 2 * t, t)[:, :, 1:, :]
    return x.reshape(b, h, t, 2 * t - 1)[..., :t]


class RelPosSelfAttention(DropoutSite, nn.Module):
    """Transformer-XL style self-attention with pos_bias_u / pos_bias_v;
    `dropout` drops attention probabilities in training mode."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0, quant: bool = False):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.dropout = dropout
        d = dim // heads
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            self.add_module(name, Dense(dim, dim, quant=quant))
        self.linear_pos = Dense(dim, dim, bias=False)
        bound = math.sqrt(6.0 / (heads + d))  # flax xavier_uniform on [h, d]
        self.pos_bias_u = nn.Parameter(torch.empty(heads, d).uniform_(-bound, bound))
        self.pos_bias_v = nn.Parameter(torch.empty(heads, d).uniform_(-bound, bound))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.heads, self.dim // self.heads

        def heads_of(z):
            return z.reshape(b, -1, h, d).transpose(1, 2)

        q, k, v = heads_of(self.linear_q(x)), heads_of(self.linear_k(x)), heads_of(self.linear_v(x))
        p = self.linear_pos(pos_emb).reshape(-1, h, d).transpose(0, 1)  # [H, 2T-1, d]
        bias_u = self.pos_bias_u.to(q.dtype)[None, :, None, :]
        bias_v = self.pos_bias_v.to(q.dtype)[None, :, None, :]
        # bf16 products are exact in f32: the f32 matmuls give JAX's
        # bf16 x bf16 -> f32 einsums
        ac = torch.matmul((q + bias_u).float(), k.float().transpose(-1, -2))
        bd = torch.matmul((q + bias_v).float(), p.float().transpose(-1, -2))
        scores = (ac + rel_shift(bd)) / math.sqrt(d)
        scores = scores.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
        attn = scores.softmax(dim=-1)
        if self.training and self.dropout > 0.0:
            attn = apply_dropout(attn, self.dropout, self.generator)
        out = torch.matmul(attn, v.float()).to(x.dtype)
        return self.linear_out(out.transpose(1, 2).reshape(b, t, self.dim))


class ConformerFFN(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, dropout: float = 0.0,
                 activation_dropout: float = 0.0, quant: bool = False):
        super().__init__()
        self.layer_norm = layer_norm(dim)
        self.w_1 = Dense(dim, ffn_dim, quant=quant)
        self.activation_dropout = Dropout(activation_dropout)
        self.w_2 = Dense(ffn_dim, dim, quant=quant)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.activation_dropout(F.silu(self.w_1(self.layer_norm(x))))
        return self.dropout(self.w_2(h))


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over the last axis of
    [B, T, C]: f32 (x - mean) * (scale * rsqrt(var + eps)) + bias, cast back
    to x's type (`momentum` 0.99 is flax's default, the Tacotron
    postnet's). In eval mode (use_running_average) mean and var are the
    running statistics. In training mode they are the batch's, in float32
    over every B x T frame, padding included: mean(x) and the biased
    max(0, mean(x^2) - mean(x)^2), flax's fast variance; the running
    statistics become momentum * old + (1 - momentum) * batch. torch's BatchNorm keeps the
    unbiased variance, so this is not nn.BatchNorm1d. The running statistics
    stay float32 when the module is cast (`_apply`), as flax keeps
    batch_stats."""

    STATS = ("running_mean", "running_var")
    update_stats = True  # False while a rematerialized layer recomputes

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def _apply(self, fn, recurse=True):
        stats = {k: self._buffers[k] for k in self.STATS}
        out = super()._apply(fn, recurse)
        for k, before in stats.items():
            if self._buffers[k].dtype != torch.float32:
                self._buffers[k] = before.to(self._buffers[k].device)
        return out

    @torch.no_grad()
    def _update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        for name, batch in zip(self.STATS if self.update_stats else (), (mean, var)):
            running = getattr(self, name)
            running.copy_(self.momentum * running + (1.0 - self.momentum) * batch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and active_split() is not None:
            # data parallel: the statistics of the global batch, every rank's
            # frames summed (and their gradients, in the backward)
            xf = x.float()
            sums = all_reduce_grad(torch.cat([xf.sum(dim=(0, 1)), xf.square().sum(dim=(0, 1))]))
            n = global_sum(x.shape[0] * x.shape[1])
            mean, sq = (sums / n).chunk(2)
            var = torch.clamp(sq - mean.square(), min=0.0)
            self._update_stats(mean, var)
        elif self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 1))
            var = torch.clamp(xf.square().mean(dim=(0, 1)) - mean.square(), min=0.0)
            self._update_stats(mean, var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x.float() - mean) * mul + self.bias.float()
        return y.to(x.dtype)


class ConvModule(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 31, dropout: float = 0.0):
        super().__init__()
        self.layer_norm = layer_norm(dim)
        self.pointwise_conv1 = Conv1d(dim, 2 * dim, 1, bias=False)
        self.depthwise_conv = Conv1d(dim, dim, kernel_size, padding=(kernel_size - 1) // 2,
                                     groups=dim, bias=False)
        self.batch_norm = BatchNorm(dim)
        self.pointwise_conv2 = Conv1d(dim, dim, 1, bias=False)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.glu(self.pointwise_conv1(self.layer_norm(x)), dim=-1)
        x = F.silu(self.batch_norm(self.depthwise_conv(x)))
        return self.dropout(self.pointwise_conv2(x))


class ConformerLayer(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, heads: int, depthwise_kernel_size: int = 31,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0, quant: bool = False):
        super().__init__()
        self.ffn1 = ConformerFFN(dim, ffn_dim, dropout, activation_dropout, quant)
        self.self_attn_layer_norm = layer_norm(dim)
        self.self_attn = RelPosSelfAttention(dim, heads, attention_dropout, quant)
        self.attn_dropout = Dropout(dropout)
        self.conv_module = ConvModule(dim, depthwise_kernel_size, dropout)
        self.ffn2 = ConformerFFN(dim, ffn_dim, dropout, activation_dropout, quant)
        self.final_layer_norm = layer_norm(dim)

    def forward(self, x, pos_emb, mask):
        x = x + 0.5 * self.ffn1(x)
        x = x + self.attn_dropout(self.self_attn(self.self_attn_layer_norm(x), pos_emb, mask))
        x = x + self.conv_module(x)
        x = x + 0.5 * self.ffn2(x)
        return self.final_layer_norm(x)


@contextlib.contextmanager
def _stats_frozen(layer: nn.Module):
    norms = [m for m in layer.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            del m.update_stats


def rematerialized(layer: nn.Module, *args) -> torch.Tensor:
    """`layer(*args)` whose activations are recomputed in the backward
    (JAX's nn.remat): the recompute draws the forward's dropout masks and
    leaves the BatchNorm running statistics as the forward left them."""
    gens = list({id(m.generator): m.generator for m in layer.modules()
                 if isinstance(m, DropoutSite) and m.generator is not None}.values())
    at_forward = [g.get_state() for g in gens]
    ran = []

    def run(*inputs):
        if not ran:
            ran.append(True)
            return layer(*inputs)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, at_forward):
            g.set_state(state)
        try:
            with _stats_frozen(layer):
                return layer(*inputs)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class ConformerEncoder(nn.Module):
    """Subsample -> scale -> linear -> dropout -> layers. Returns (features
    [B, T', C], mask [B, T'] True = valid). `attention_dropout` and
    `activation_dropout` fall back to `dropout` where None; `quant` makes
    the layers' projections and FFNs int8 sites (inference only); `remat`
    recomputes each layer in the backward (`rematerialized`)."""

    def __init__(self, in_channels: int = 80, dim: int = 512, ffn_dim: int = 2048,
                 layers: int = 12, heads: int = 8, depthwise_kernel_size: int = 31,
                 conv_channels: int = 1024, conv_kernel_sizes: Sequence[int] = (5, 5),
                 dropout: float = 0.0, attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None, quant: bool = False,
                 remat: bool = False):
        super().__init__()
        self.dim, self.remat = dim, remat
        self.subsample = Conv1dSubsampler(in_channels, conv_channels, dim,
                                          tuple(conv_kernel_sizes))
        self.linear = Dense(dim, dim)
        self.input_dropout = Dropout(dropout)
        attention_dropout = dropout if attention_dropout is None else attention_dropout
        activation_dropout = dropout if activation_dropout is None else activation_dropout
        self.n_layers = layers
        for i in range(layers):
            self.add_module(f"layer_{i}", ConformerLayer(
                dim, ffn_dim, heads, depthwise_kernel_size, dropout, attention_dropout,
                activation_dropout, quant))

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor,
                return_all_layers: bool = False):
        """With `return_all_layers` also the output of every layer, in
        order (fairseq's return_all_hiddens encoder_states, which the
        multitask aux heads tap): (features, mask, states)."""
        x, lengths = self.subsample(src, src_lengths)
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        x = x * math.sqrt(self.dim)
        pos = torch.from_numpy(rel_positional_encoding(x.shape[1], self.dim)).to(
            device=x.device, dtype=x.dtype)
        x = self.input_dropout(self.linear(x))
        states = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.n_layers):
            layer = getattr(self, f"layer_{i}")
            x = rematerialized(layer, x, pos, mask) if remat else layer(x, pos, mask)
            states.append(x)
        return (x, mask, states) if return_all_layers else (x, mask)
