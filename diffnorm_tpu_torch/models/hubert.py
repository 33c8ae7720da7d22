"""HuBERT / wav2vec2 speech encoder (PyTorch, batch-first [B, T, C]): the
feature dump's encoder, HuBERT's masked-unit pretraining model and the CTC
fine-tune model (the port of diffnorm_tpu/models/hubert.py; reference
fairseq HubertModel, hubert_asr.py HubertCtc).
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

Training (JAX hubert.py:95-266) runs in the module's training mode: the
dropouts (`dropout` after out_proj, fc2 and the encoder LayerNorm,
`attention_dropout` on the probabilities, `activation_dropout` after fc1's
GELU, `dropout_input` after post_extract_proj) and LayerDrop (one Bernoulli
draw a layer; eval keeps every layer) draw from the generator that the
trainer sets (`layers.set_dropout_generator`); flax's streams cannot be
reproduced, so the tests hold these paths to JAX at rates 0.
`feature_grad_mult` g scales the gradient into the conv extractor as JAX's
`feats * g + stop_grad(feats * (1 - g))` (g = 0: no gradient, the extractor
run without one). The hooks: `mask_indices` [B, F] with `mask_emb` replace
masked frames after post_extract_proj (and its dropout); `channel_mask`
[B, dim] zeroes embedding channels (the fine-tune's channel mask).

`HubertPretrainModule` ("hubert", hubert_base, hubert_large) gives one
static [B, F, K] float32 set of cosine logits between the projected frames
and the K label embeddings over every frame, divided by `logit_temp`, and
`features_pen`, the extractor output's mean square over all positions; the
criterion weights the masked and unmasked frames (JAX :357-453).
`HubertCTCModule` (hubert_ctc, wav2vec_ctc) is fairseq's CTC layout: the
encoder as `w2v_model`, final dropout and `proj` to the letters; its masks
apply in training only (JAX :285-354).

Submodule and parameter names follow the flax tree (`feature_extractor.conv_0`,
`group_norm`, `pos_conv.conv`, `layer_3.q_proj`, ...), so weights carry over
through `weights.from_jax_params`; `utils/convert_weights.py` maps a fairseq
checkpoint onto that tree. LayerNorms use flax's epsilon 1e-6 except the
extractor's (1e-5), as in JAX, unless `layer_norm_eps` says otherwise. Each
module computes in the dtype of its weights; GroupNorm and the extractor's
LayerNorms take their statistics in float32, as flax's do. Attention goes
through `ops.attention.masked_attention`, which sends self-attention over
2048 or more frames (41 s of speech) on the card to the flash-attention
kernel; a training forward with attention dropout takes the module math,
as JAX keeps it off its kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.layers import (
    Dense,
    Dropout,
    DropoutSite,
    _lecun_normal_,
    local_heads,
    arch_default,
)
from diffnorm_tpu_torch.ops.attention import masked_attention, tp_shard

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


class TransformerSentenceEncoderLayer(DropoutSite, nn.Module):
    """Post-norm layer, or pre-norm with `layer_norm_first` (JAX
    hubert.py:95-156), with its dropouts in training mode. Under tensor
    parallelism each rank runs heads / model of the heads and its slice of
    the FF width."""

    tp_ready = True
    tp_axis = None

    def __init__(self, dim: int = 768, heads: int = 12, ffn_dim: int = 3072,
                 layer_norm_first: bool = False, layer_norm_eps: float = LN_EPS,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0):
        super().__init__()
        self.heads, self.layer_norm_first = heads, layer_norm_first
        self.attention_dropout = attention_dropout
        self.q_proj, self.k_proj = Dense(dim, dim), Dense(dim, dim)
        self.v_proj, self.out_proj = Dense(dim, dim), Dense(dim, dim)
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.fc1, self.fc2 = Dense(dim, ffn_dim), Dense(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.dropout, self.activation_dropout = Dropout(dropout), Dropout(activation_dropout)

    def shard_heads(self, n: int) -> None:
        self.heads = local_heads(self.heads, n)

    def attention(self, z: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, dim = z.shape

        def heads_of(y):
            return y.reshape(b, t, self.heads, -1).transpose(1, 2)

        a = masked_attention(heads_of(self.q_proj(z)), heads_of(self.k_proj(z)),
                             heads_of(self.v_proj(z)), mask,
                             dropout=self.attention_dropout if self.training else 0.0,
                             generator=self.generator, heads_axis=self.tp_axis)
        return self.dropout(self.out_proj(a.transpose(1, 2).reshape(b, t, -1)))

    def ffn(self, z: torch.Tensor) -> torch.Tensor:
        shard = tp_shard(self.tp_axis, -1, self.fc1.out_features)
        return self.dropout(self.fc2(self.activation_dropout(F.gelu(self.fc1(z)), shard)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.layer_norm_first:
            x = x + self.attention(self.self_attn_layer_norm(x), mask)
            return x + self.ffn(self.final_layer_norm(x))
        x = self.self_attn_layer_norm(x + self.attention(x, mask))
        return self.final_layer_norm(x + self.ffn(x))


class HubertEncoder(DropoutSite, nn.Module):
    """JAX hubert.py:159-266. `layer_norm_eps` (the feature, encoder and
    layer LayerNorms) and the positional conv's kernel and groups default to
    HuBERT's; wav2vec2-CTC (`models/wav2vec2_ctc.py`) sets them from its
    config. The training knobs act in training mode only (module
    docstring)."""

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
        self.dim, self.layers, self.layer_norm_first = dim, layers, layer_norm_first
        self.layerdrop, self.feature_grad_mult = layerdrop, feature_grad_mult
        self.conv_feature_layers = tuple(conv_feature_layers or CONV_LAYERS)
        self.feature_extractor = ConvFeatureExtractor(self.conv_feature_layers,
                                                      extractor_mode, conv_bias)
        conv_dim = self.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(conv_dim, eps=layer_norm_eps)
        self.post_extract_proj = Dense(conv_dim, dim)
        self.dropout_input, self.dropout = Dropout(dropout_input), Dropout(dropout)
        self.pos_conv = ConvPositionalEmbedding(dim, pos_conv_kernel, pos_conv_groups)
        self.encoder_layer_norm = nn.LayerNorm(dim, eps=layer_norm_eps)
        for i in range(layers):
            self.add_module(f"layer_{i}", TransformerSentenceEncoderLayer(
                dim, heads, ffn_dim, layer_norm_first, layer_norm_eps, dropout,
                attention_dropout, activation_dropout))

    def extract(self, wav: torch.Tensor) -> torch.Tensor:
        """The conv extractor's output, its gradient scaled by
        `feature_grad_mult` in training (JAX :202-208)."""
        g = self.feature_grad_mult
        if g == 1.0 or not (self.training and torch.is_grad_enabled()):
            return self.feature_extractor(wav)
        if g == 0.0:
            with torch.no_grad():
                return self.feature_extractor(wav)
        feats = self.feature_extractor(wav)
        return feats * g + (feats * (1.0 - g)).detach()

    def forward(self, wav: torch.Tensor, output_layer: Optional[int] = None,
                mask: Optional[torch.Tensor] = None, mask_indices=None, mask_emb=None,
                channel_mask=None, return_features: bool = False,
                return_normed: bool = False):
        """wav [B, T] (16 kHz) -> features [B, frames, dim] after
        `output_layer` layers (1-based; None = all). `mask` [B, frames] bool
        (True = valid) zeroes padded frames before the positional conv and
        masks them as keys. `mask_indices` [B, frames] bool and `mask_emb`
        [dim] substitute masked frames; `channel_mask` [B, dim] bool zeroes
        channels. `return_features` adds the raw extractor output,
        `return_normed` also its LayerNorm, as in JAX."""
        raw_features = self.extract(wav)
        normed_features = self.layer_norm(raw_features)
        x = self.dropout_input(self.post_extract_proj(normed_features))
        if mask_indices is not None:
            x = torch.where(mask_indices[:, :, None], mask_emb.to(x.dtype), x)
        if channel_mask is not None:
            x = torch.where(channel_mask[:, None, :], 0.0, x)
        if mask is not None:
            x = torch.where(mask[:, :, None], x, 0.0)
        x = x + self.pos_conv(x)
        if not self.layer_norm_first:
            x = self.encoder_layer_norm(x)
        x = self.dropout(x)
        n = self.layers if output_layer is None else min(output_layer, self.layers)
        for i in range(n):
            y = getattr(self, f"layer_{i}")(x, mask)
            if self.training and self.layerdrop > 0.0:
                # LayerDrop: the layer's output kept with 1 - p (no rescale)
                if self.generator is None:
                    raise ValueError("LayerDrop needs a generator (set_dropout_generator)")
                keep = torch.rand((), generator=self.generator,
                                  device=x.device) < 1.0 - self.layerdrop
                x = torch.where(keep, y, x)
            else:
                x = y
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


def _uniform_param(*shape: int) -> nn.Parameter:
    """flax's uniform(scale=1.0) init: U[0, 1)."""
    return nn.Parameter(torch.rand(*shape))


def _valid_frames(wav: torch.Tensor, src_lengths: torch.Tensor, conv_layers):
    """(frame lengths [B], valid-frame mask [B, F]) of a padded waveform."""
    out_lengths = frame_lengths(src_lengths, conv_layers)
    n_frames = frames_for_samples(wav.shape[1], conv_layers)
    valid = torch.arange(n_frames, device=wav.device)[None, :] < out_lengths[:, None]
    return out_lengths, valid


class HubertCTCModule(nn.Module):
    """The encoder (`w2v_model`) and a linear CTC head (`proj`) over the
    letters (JAX hubert.py:285-354; reference hubert_asr.py HubertCtc):
    16 kHz waveform [B, T(, 1)] -> frame logits. With `apply_mask` the
    model holds a `mask_emb` that the fine-tune's time mask substitutes;
    the time and channel masks apply in training only."""

    def __init__(self, vocab_size: int, dim: int = 768, final_dropout: float = 0.0,
                 apply_mask: bool = False, feature_grad_mult: float = 0.0, **kw):
        super().__init__()
        self.apply_mask = apply_mask
        self.w2v_model = HubertEncoder(dim=dim, feature_grad_mult=feature_grad_mult, **kw)
        self.conv_feature_layers = self.w2v_model.conv_feature_layers
        self.proj = Dense(dim, vocab_size)
        self.final_dropout = Dropout(final_dropout)
        if apply_mask:
            self.mask_emb = _uniform_param(dim)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor, mask_indices=None,
                channel_mask=None) -> Dict[str, torch.Tensor]:
        wav = src[..., 0] if src.dim() == 3 else src
        out_lengths, valid = _valid_frames(wav, src_lengths, self.conv_feature_layers)
        use_mask = self.apply_mask and self.training
        x = self.w2v_model(wav, mask=valid,
                           mask_indices=mask_indices if use_mask else None,
                           mask_emb=self.mask_emb if use_mask else None,
                           channel_mask=channel_mask if use_mask else None)
        logits = self.proj(self.final_dropout(x))
        return dict(logits=logits, logit_lengths=out_lengths, mask=valid)


class HubertPretrainModule(nn.Module):
    """HuBERT masked-unit pretraining (JAX hubert.py:357-453; reference
    hubert.py forward :432-527): the encoder with the masked frames replaced
    by `mask_emb`, `final_proj` to `final_dim`, and the cosine of every frame
    against every row of `label_embs_concat` [K, final_dim], in float32,
    over `logit_temp`. The K-way softmax over these logits is the
    reference's NCE over [positive; all embeddings] with the positive's
    duplicate removed, so one static [B, F, K] tensor serves every frame;
    single target set (untie_final_proj and target_glu off, as in JAX)."""

    def __init__(self, num_classes: int, dim: int = 768, final_dim: int = 256,
                 logit_temp: float = 0.1, feature_grad_mult: float = 0.1,
                 dropout_input: float = 0.1, dropout: float = 0.1,
                 attention_dropout: float = 0.1, activation_dropout: float = 0.0,
                 layerdrop: float = 0.05, **kw):
        super().__init__()
        self.logit_temp = logit_temp
        self.encoder = HubertEncoder(
            dim=dim, feature_grad_mult=feature_grad_mult, dropout_input=dropout_input,
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, layerdrop=layerdrop, **kw)
        self.conv_feature_layers = self.encoder.conv_feature_layers
        self.mask_emb = _uniform_param(dim)
        self.final_proj = Dense(dim, final_dim)
        self.label_embs_concat = _uniform_param(num_classes, final_dim)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor,
                mask_indices: torch.Tensor) -> Dict[str, torch.Tensor]:
        """src [B, T(, 1)] waveform; mask_indices [B, F] bool (the task's
        host-side span mask). Returns logits [B, F, K] float32,
        features_pen, the valid-frame mask, mask_indices and the frame
        lengths."""
        wav = src[..., 0] if src.dim() == 3 else src
        out_lengths, valid = _valid_frames(wav, src_lengths, self.conv_feature_layers)
        x, raw_features = self.encoder(wav, mask=valid, mask_indices=mask_indices,
                                       mask_emb=self.mask_emb, return_features=True)
        features_pen = raw_features.float().square().mean()  # over every position (:441)
        proj = self.final_proj(x).float()
        embs = self.label_embs_concat.float()
        proj = proj / proj.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        embs = embs / embs.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        logits = torch.einsum("bfd,kd->bfk", proj, embs) / self.logit_temp
        return dict(logits=logits, features_pen=features_pen, mask=valid,
                    mask_indices=mask_indices, logit_lengths=out_lengths)


def parse_conv_spec(spec):
    """fairseq --conv-feature-layers "[(512,10,5), (512,3,2), ...]" -> a
    tuple of (channels, kernel, stride); None or a sequence as it is (JAX
    hubert.py:_parse_conv_spec)."""
    if spec is None or isinstance(spec, (tuple, list)):
        return spec
    import ast

    return tuple(tuple(t) for t in ast.literal_eval(str(spec)))


def hubert_base_arch(cfg: dict) -> None:
    """hubert / hubert_base (JAX hubert.py:497-504)."""
    for key, value in (("encoder_embed_dim", 768), ("encoder_layers", 12),
                       ("encoder_attention_heads", 12), ("encoder_ffn_embed_dim", 3072),
                       ("final_dim", 256)):
        arch_default(cfg, key, value)


def hubert_large_arch(cfg: dict) -> None:
    """hubert_large (hubert_large_librivox.yaml, JAX :507-518): pre-norm
    24 x 1024, the layer_norm extractor."""
    for key, value in (("encoder_embed_dim", 1024), ("encoder_layers", 24),
                       ("encoder_attention_heads", 16), ("encoder_ffn_embed_dim", 4096),
                       ("final_dim", 768), ("extractor_mode", "layer_norm"),
                       ("layer_norm_first", True)):
        arch_default(cfg, key, value)


def hubert_ctc_arch(cfg: dict) -> None:
    """hubert_ctc and fairseq's wav2vec_ctc alias (JAX :558-563)."""
    for key, value in (("encoder_embed_dim", 768), ("encoder_layers", 12),
                       ("encoder_attention_heads", 12), ("encoder_ffn_embed_dim", 3072)):
        arch_default(cfg, key, value)


PRETRAIN_ARCHS = {"hubert": hubert_base_arch, "hubert_base": hubert_base_arch,
                  "hubert_large": hubert_large_arch}
CTC_ARCHS = {"hubert_ctc": hubert_ctc_arch, "wav2vec_ctc": hubert_ctc_arch}


def _cfg(cfg: dict, key: str, default):
    value = cfg.get(key)
    return default if value is None else value


def encoder_config(cfg: dict) -> dict:
    """The encoder's keyword arguments from a config (cli.train's flags as
    a dict), JAX's build_model defaults where a key is unset."""
    return dict(dim=_cfg(cfg, "encoder_embed_dim", 768), layers=_cfg(cfg, "encoder_layers", 12),
                heads=_cfg(cfg, "encoder_attention_heads", 12),
                ffn_dim=_cfg(cfg, "encoder_ffn_embed_dim", 3072),
                conv_feature_layers=parse_conv_spec(cfg.get("conv_feature_layers")),
                extractor_mode=_cfg(cfg, "extractor_mode", "default"),
                conv_bias=bool(cfg.get("conv_bias")),
                layer_norm_first=bool(cfg.get("layer_norm_first")))


def build_hubert_pretrain(cfg: dict, num_classes: Optional[int] = None) -> HubertPretrainModule:
    """JAX HubertPretrainModel.build_model (hubert.py:459-492)."""
    return HubertPretrainModule(
        num_classes=num_classes or _cfg(cfg, "num_classes", 504),
        final_dim=_cfg(cfg, "final_dim", 256), logit_temp=_cfg(cfg, "logit_temp", 0.1),
        feature_grad_mult=_cfg(cfg, "feature_grad_mult", 0.1),
        dropout_input=_cfg(cfg, "dropout_input", 0.1), dropout=_cfg(cfg, "dropout", 0.1),
        attention_dropout=_cfg(cfg, "attention_dropout", 0.1),
        activation_dropout=_cfg(cfg, "activation_dropout", 0.0),
        layerdrop=_cfg(cfg, "encoder_layerdrop", 0.05), **encoder_config(cfg))


def build_hubert_ctc(cfg: dict, vocab_size: Optional[int] = None) -> HubertCTCModule:
    """JAX HubertCTCModel.build_model (hubert.py:531-555): the fine-tune's
    regularization off unless set."""
    return HubertCTCModule(
        vocab_size=vocab_size or _cfg(cfg, "vocab_size", 32),
        final_dropout=_cfg(cfg, "final_dropout", 0.0), dropout=_cfg(cfg, "dropout", 0.0),
        attention_dropout=_cfg(cfg, "attention_dropout", 0.0),
        activation_dropout=_cfg(cfg, "activation_dropout", 0.0),
        layerdrop=_cfg(cfg, "encoder_layerdrop", 0.0),
        feature_grad_mult=_cfg(cfg, "feature_grad_mult", 0.0),
        apply_mask=bool(cfg.get("apply_mask")), **encoder_config(cfg))
