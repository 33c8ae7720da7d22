"""mHuBERT speech encoder for the feature dump (PyTorch, batch-first [B, T, C]).

Counterpart of diffnorm_tpu/models/hubert.py for inference (fairseq
HubertModel.extract_features):
  ConvFeatureExtractor: 7 strided convs [(512,10,5), (512,3,2)x4,
    (512,2,2)x2], a 320x downsample; "default" mode: a per-channel GroupNorm
    (512 groups) on layer 0 only and no conv bias; "layer_norm" mode: a
    float32 LayerNorm over the channels after every conv, optional bias
  LayerNorm, post_extract_proj 512 -> 768, a grouped conv positional
    embedding (kernel 128, 16 groups), encoder LayerNorm
  12 transformer layers (768, 12 heads, FFN 3072), post-norm or
    `layer_norm_first`
`HubertEncoder(wav, output_layer=11)` gives the layer-11 features that
DiffNorm quantizes (models/kmeans.py). Every GELU is exact
(`approximate="none"`), not the tanh form of the denoiser's GEGLU.

Submodule and parameter names follow the flax tree (`feature_extractor.conv_0`,
`group_norm`, `pos_conv.conv`, `layer_3.q_proj`, ...), so weights carry over
through `weights.from_jax_params`; `utils/convert_weights.py` maps a fairseq
checkpoint onto that tree. LayerNorms use flax's epsilon 1e-6 except the
extractor's (1e-5), as in JAX, unless `layer_norm_eps` says otherwise. Each
module computes in the dtype of its weights; GroupNorm and the extractor's
LayerNorms take their statistics in float32, as flax's do. Attention goes
through `ops.attention.masked_attention`, which sends self-attention over
2048 or more frames (41 s of speech) on the card to the flash-attention
kernel.

JAX's pretraining hooks (`mask_indices` / `mask_emb`, `channel_mask`,
`feature_grad_mult`, LayerDrop and the training dropouts) wait for HuBERT
pretraining; the encoder raises where one is asked for. `HubertCTCModule`
and `HubertPretrainModule` are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.layers import Dense, _lecun_normal_
from diffnorm_tpu_torch.ops.attention import masked_attention

CONV_LAYERS = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2
LN_EPS = 1e-6  # flax nn.LayerNorm
EXTRACTOR_EPS = 1e-5  # the extractor's GroupNorm and LayerNorms


def _conv1d(cin: int, cout: int, k: int, bias: bool, **kw) -> nn.Conv1d:
    conv = nn.Conv1d(cin, cout, k, bias=bias, **kw)
    with torch.no_grad():  # flax nn.Conv's init: lecun normal kernel, zero bias
        _lecun_normal_(conv.weight, conv.weight.shape[1] * k)
        if bias:
            conv.bias.zero_()
    return conv


def _f32_norm(fn, x: torch.Tensor, norm: nn.Module, *args) -> torch.Tensor:
    """A norm with its statistics, scale and shift in float32, cast back."""
    return fn(x.float(), *args, norm.weight.float(), norm.bias.float(), norm.eps).to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """Waveform [B, T] -> [B, frames, C] (JAX hubert.py:37-71)."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] = CONV_LAYERS,
                 mode: str = "default", conv_bias: bool = False):
        super().__init__()
        if mode not in ("default", "layer_norm"):
            raise ValueError(f"extractor mode {mode!r}: 'default' or 'layer_norm'")
        self.conv_layers, self.mode = tuple(conv_layers), mode
        cin = 1
        for i, (dim, k, stride) in enumerate(self.conv_layers):
            self.add_module(f"conv_{i}", _conv1d(cin, dim, k, conv_bias, stride=stride))
            if mode == "layer_norm":
                self.add_module(f"ln_{i}", nn.LayerNorm(dim, eps=EXTRACTOR_EPS))
            cin = dim
        if mode == "default":
            dim = self.conv_layers[0][0]
            self.group_norm = nn.GroupNorm(dim, dim, eps=EXTRACTOR_EPS)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav.to(self.conv_0.weight.dtype)[:, None, :]  # [B, 1, T]
        for i in range(len(self.conv_layers)):
            x = getattr(self, f"conv_{i}")(x)  # [B, C, T']
            if self.mode == "layer_norm":
                ln = getattr(self, f"ln_{i}")
                x = _f32_norm(F.layer_norm, x.transpose(1, 2), ln,
                              ln.normalized_shape).transpose(1, 2)
            elif i == 0:
                x = _f32_norm(F.group_norm, x, self.group_norm, self.group_norm.num_groups)
            x = F.gelu(x)
        return x.transpose(1, 2)


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv over time, padded kernel // 2 on both sides, the last
    frame dropped for an even kernel, exact GELU (JAX hubert.py:74-92). The
    fairseq weight norm is folded at conversion."""

    def __init__(self, dim: int = 768, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.kernel = kernel
        self.conv = _conv1d(dim, dim, kernel, True, padding=kernel // 2, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight
        x = x.to(w.dtype).transpose(1, 2)
        if x.device.type == "cpu" and w.dtype == torch.bfloat16:
            # oneDNN's bf16 grouped conv with an even kernel is wrong on the
            # CPU (torch 2.13: errors as large as the output): the same bf16
            # operands, summed in float32 and rounded once
            h = F.conv1d(x.float(), w.float(), self.conv.bias.float(), padding=self.kernel // 2,
                         groups=self.conv.groups).to(w.dtype)
        else:
            h = self.conv(x)
        h = h.transpose(1, 2)
        if self.kernel % 2 == 0:
            h = h[:, :-1]
        return F.gelu(h)


class TransformerSentenceEncoderLayer(nn.Module):
    """Post-norm layer, or pre-norm with `layer_norm_first` (JAX
    hubert.py:95-156), without its dropouts (all 0 at inference)."""

    def __init__(self, dim: int = 768, heads: int = 12, ffn_dim: int = 3072,
                 layer_norm_first: bool = False, layer_norm_eps: float = LN_EPS):
        super().__init__()
        self.heads, self.layer_norm_first = heads, layer_norm_first
        self.q_proj, self.k_proj = Dense(dim, dim), Dense(dim, dim)
        self.v_proj, self.out_proj = Dense(dim, dim), Dense(dim, dim)
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.fc1, self.fc2 = Dense(dim, ffn_dim), Dense(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=layer_norm_eps)

    def attention(self, z: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, dim = z.shape

        def heads_of(y):
            return y.reshape(b, t, self.heads, dim // self.heads).transpose(1, 2)

        a = masked_attention(heads_of(self.q_proj(z)), heads_of(self.k_proj(z)),
                             heads_of(self.v_proj(z)), mask)
        return self.out_proj(a.transpose(1, 2).reshape(b, t, dim))

    def ffn(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(z)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.layer_norm_first:
            x = x + self.attention(self.self_attn_layer_norm(x), mask)
            return x + self.ffn(self.final_layer_norm(x))
        x = self.self_attn_layer_norm(x + self.attention(x, mask))
        return self.final_layer_norm(x + self.ffn(x))


class HubertEncoder(nn.Module):
    """JAX hubert.py:159-266 for inference. The training knobs are taken
    only at their inference values (0, and `feature_grad_mult` 1).
    `layer_norm_eps` (the feature, encoder and layer LayerNorms) and the
    positional conv's kernel and groups default to HuBERT's; wav2vec2-CTC
    (`models/wav2vec2_ctc.py`) sets them from its config."""

    def __init__(self, dim: int = 768, layers: int = 12, heads: int = 12,
                 ffn_dim: int = 3072,
                 conv_feature_layers: Optional[Sequence[Tuple[int, int, int]]] = None,
                 extractor_mode: str = "default", conv_bias: bool = False,
                 layer_norm_first: bool = False, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 dropout_input: float = 0.0, layerdrop: float = 0.0,
                 feature_grad_mult: float = 1.0, layer_norm_eps: float = LN_EPS,
                 pos_conv_kernel: int = 128, pos_conv_groups: int = 16):
        super().__init__()
        asked = {k: v for k, v in dict(
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, dropout_input=dropout_input,
            layerdrop=layerdrop, feature_grad_mult=feature_grad_mult - 1.0).items() if v}
        if asked:
            raise NotImplementedError(
                f"HubertEncoder: {sorted(asked)} are HuBERT pretraining knobs, not ported")
        self.dim, self.layers, self.layer_norm_first = dim, layers, layer_norm_first
        self.conv_feature_layers = tuple(conv_feature_layers or CONV_LAYERS)
        self.feature_extractor = ConvFeatureExtractor(self.conv_feature_layers,
                                                      extractor_mode, conv_bias)
        conv_dim = self.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(conv_dim, eps=layer_norm_eps)
        self.post_extract_proj = Dense(conv_dim, dim)
        self.pos_conv = ConvPositionalEmbedding(dim, pos_conv_kernel, pos_conv_groups)
        self.encoder_layer_norm = nn.LayerNorm(dim, eps=layer_norm_eps)
        for i in range(layers):
            self.add_module(f"layer_{i}", TransformerSentenceEncoderLayer(
                dim, heads, ffn_dim, layer_norm_first, layer_norm_eps))

    def forward(self, wav: torch.Tensor, output_layer: Optional[int] = None,
                mask: Optional[torch.Tensor] = None, mask_indices=None, mask_emb=None,
                channel_mask=None, return_features: bool = False,
                return_normed: bool = False):
        """wav [B, T] (16 kHz) -> features [B, frames, dim] after
        `output_layer` layers (1-based; None = all). `mask` [B, frames] bool
        (True = valid) zeroes padded frames before the positional conv and
        masks them as keys. `return_features` adds the raw extractor output,
        `return_normed` also its LayerNorm, as in JAX."""
        if mask_indices is not None or mask_emb is not None or channel_mask is not None:
            raise NotImplementedError(
                "HubertEncoder: mask_indices / mask_emb / channel_mask are HuBERT "
                "pretraining hooks, not ported")
        raw_features = self.feature_extractor(wav)
        normed_features = self.layer_norm(raw_features)
        x = self.post_extract_proj(normed_features)
        if mask is not None:
            x = torch.where(mask[:, :, None], x, 0.0)
        x = x + self.pos_conv(x)
        if not self.layer_norm_first:
            x = self.encoder_layer_norm(x)
        n = self.layers if output_layer is None else min(output_layer, self.layers)
        for i in range(n):
            x = getattr(self, f"layer_{i}")(x, mask)
        if self.layer_norm_first and output_layer is None:
            x = self.encoder_layer_norm(x)
        if return_normed:
            return x, raw_features, normed_features
        if return_features:
            return x, raw_features
        return x


def frames_for_samples(n_samples: int, conv_layers=None) -> int:
    """Output frame count of the conv extractor for a waveform length."""
    n = n_samples
    for _, k, s in (conv_layers or CONV_LAYERS):
        n = (n - k) // s + 1
    return n


def frame_lengths(lengths: torch.Tensor, conv_layers=None) -> torch.Tensor:
    """`frames_for_samples` per row of an int tensor, at least 0 (int32)."""
    n = lengths.to(torch.int32)
    for _, k, s in (conv_layers or CONV_LAYERS):
        n = torch.div(n - k, s, rounding_mode="floor") + 1
    return n.clamp(min=0)
