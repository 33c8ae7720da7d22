"""wav2vec 2.0 contrastive pretraining (the port of
diffnorm_tpu/models/wav2vec2.py; reference fairseq/models/wav2vec/wav2vec2.py
Wav2Vec2Model:580-781 and fairseq/modules/gumbel_vector_quantizer.py; recipe
examples/wav2vec/config/pretraining/wav2vec2_base_librispeech.yaml).

Static shapes, as in JAX: the task draws the span mask and the negatives on
the host (`tasks/audio_pretrain_task.py`) and gives a fixed budget of masked
slots, `masked_pos` [B, M] with `masked_valid`, and `neg_idxs` [B, M, N]
into the masked axis; the model gathers the slots, quantizes their
layer-normed conv features (`GumbelVectorQuantizer`) and scores the
projected encoder output against the quantized target and the N negatives
by cosine over `logit_temp`, a negative equal to its positive removed
(-inf). The encoder is HuBERT's (`models/hubert.py:HubertEncoder`).

The quantizer's Gumbel noise comes from uniforms on [tiny, 1): a tensor the
caller passes (the tests pass JAX's), else a draw from the generator the
trainer sets. Omitted, as in JAX (off in every released recipe):
input_quantizer, negatives_from_everywhere, cross_sample_negatives,
codebook_negatives, target_glu, the conformer layer type.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.hubert import (
    HubertEncoder,
    _cfg,
    _uniform_param,
    _valid_frames,
    encoder_config,
)
from diffnorm_tpu_torch.models.layers import Dense, Dropout, DropoutSite, arch_default


class GumbelVectorQuantizer(DropoutSite, nn.Module):
    """JAX wav2vec2.py:45-121 (weight_proj_depth 1, time first):
    `weight_proj` to groups x num_vars logits, the perplexities of the hard
    codes and of the mean softmax weighted by `valid`, and in training the
    straight-through hard Gumbel sample (forward one-hot, backward the soft
    sample's gradient); in eval the hard argmax codes. `combine_groups`
    shares one codebook across the groups."""

    def __init__(self, dim: int, num_vars: int = 320, groups: int = 2, vq_dim: int = 256,
                 combine_groups: bool = False):
        super().__init__()
        self.num_vars, self.groups, self.vq_dim = num_vars, groups, vq_dim
        self.combine_groups = combine_groups
        num_groups = 1 if combine_groups else groups
        self.vars = nn.Parameter(torch.rand(1, num_groups * num_vars, vq_dim // groups))
        self.weight_proj = Dense(dim, groups * num_vars)
        with torch.no_grad():  # the reference's N(0, 1) kernel, zero bias
            self.weight_proj.weight.normal_()

    def forward(self, x: torch.Tensor, temp, valid: Optional[torch.Tensor] = None,
                uniforms: Optional[torch.Tensor] = None) -> Dict:
        """x [B, M, C]; temp the Gumbel temperature; valid [B, M] bool;
        uniforms [B, M, groups, num_vars] on [tiny, 1) (training only; drawn
        from `self.generator` where None)."""
        b, m, _ = x.shape
        logits = self.weight_proj(x).reshape(b, m, self.groups, self.num_vars)
        hard_idx = logits.argmax(dim=-1)
        hard_x = F.one_hot(hard_idx, self.num_vars).float()
        w = (torch.ones(b, m, 1, 1, device=x.device) if valid is None
             else valid[:, :, None, None].float())
        denom = w.sum().clamp_min(1.0)
        hard_probs = (hard_x * w).sum(dim=(0, 1)) / denom
        code_ppl = torch.exp(-(hard_probs * torch.log(hard_probs + 1e-7)).sum(-1)).sum()
        avg_probs = (logits.float().softmax(-1) * w).sum(dim=(0, 1)) / denom
        prob_ppl = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-7)).sum(-1)).sum()
        if self.training:
            if uniforms is None:
                if self.generator is None:
                    raise ValueError("the Gumbel sample needs a generator "
                                     "(set_dropout_generator)")
                uniforms = torch.rand(logits.shape, generator=self.generator,
                                      device=x.device)
            tiny = torch.finfo(torch.float32).tiny
            g = -torch.log(-torch.log(uniforms.float().clamp_min(tiny)))
            soft = ((logits.float() + g) / temp).softmax(-1)
            hard = F.one_hot(soft.argmax(-1), self.num_vars).float()
            sel = hard + soft - soft.detach()
        else:
            sel = hard_x
        cb = self.vars.reshape(-1, self.num_vars, self.vq_dim // self.groups).float()
        if self.combine_groups:
            cb = cb.expand(self.groups, -1, -1)
        q = torch.einsum("bmgv,gvd->bmgd", sel, cb).reshape(b, m, self.vq_dim)
        return {"x": q.to(x.dtype), "targets": hard_idx, "num_vars": self.num_vars * self.groups,
                "code_perplexity": code_ppl, "prob_perplexity": prob_ppl}


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """torch.cosine_similarity over the last axis, JAX's spelling (the
    product of the norms clamped)."""
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(eps)


def _gather_slots(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x [B, F, D] at pos [B, M] -> [B, M, D]."""
    return x.gather(1, pos.long()[:, :, None].expand(-1, -1, x.shape[-1]))


class Wav2Vec2PretrainModule(nn.Module):
    """The contrastive forward (JAX wav2vec2.py:131-243, quantize_targets):
    encoder output at the masked slots against the Gumbel-quantized
    layer-normed features, and N same-utterance negatives."""

    def __init__(self, dim: int = 768, final_dim: int = 256, latent_vars: int = 320,
                 latent_groups: int = 2, latent_dim: int = 0, logit_temp: float = 0.1,
                 feature_grad_mult: float = 0.1, dropout_input: float = 0.1,
                 dropout_features: float = 0.1, dropout: float = 0.1,
                 attention_dropout: float = 0.1, activation_dropout: float = 0.0,
                 layerdrop: float = 0.05, **kw):
        super().__init__()
        self.logit_temp = logit_temp
        self.encoder = HubertEncoder(
            dim=dim, feature_grad_mult=feature_grad_mult, dropout_input=dropout_input,
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, layerdrop=layerdrop, **kw)
        self.conv_feature_layers = self.encoder.conv_feature_layers
        conv_dim = self.conv_feature_layers[-1][0]
        vq_dim = latent_dim if latent_dim > 0 else final_dim
        self.quantizer = GumbelVectorQuantizer(conv_dim, latent_vars, latent_groups, vq_dim)
        self.project_q = Dense(vq_dim, final_dim)
        self.final_proj = Dense(dim, final_dim)
        self.mask_emb = _uniform_param(dim)
        self.dropout_features = Dropout(dropout_features)

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor, mask_indices: torch.Tensor,
                masked_pos: torch.Tensor, masked_valid: torch.Tensor, neg_idxs: torch.Tensor,
                temp=2.0, uniforms: Optional[torch.Tensor] = None) -> Dict:
        """src [B, T(, 1)] waveform; mask_indices [B, F] bool; masked_pos
        [B, M] int frame indices of the masked slots, masked_valid [B, M]
        bool; neg_idxs [B, M, N] indices into the masked axis; temp the
        Gumbel temperature; uniforms the quantizer's (training). Returns
        logits [B, M, 1 + N] (the positive first), the penalties and the
        perplexities."""
        wav = src[..., 0] if src.dim() == 3 else src
        _, valid = _valid_frames(wav, src_lengths, self.conv_feature_layers)
        x, raw_features, normed = self.encoder(wav, mask=valid, mask_indices=mask_indices,
                                               mask_emb=self.mask_emb, return_normed=True)
        features_pen = raw_features.float().square().mean()
        y_src = self.dropout_features(_gather_slots(normed, masked_pos))
        q = self.quantizer(y_src, temp, valid=masked_valid, uniforms=uniforms)
        y = self.project_q(q["x"]).float()  # [B, M, Df]; float32 for the equality below
        x_m = self.final_proj(_gather_slots(x, masked_pos)).float()
        b, m, df = y.shape
        n = neg_idxs.shape[-1]
        negs = _gather_slots(y, neg_idxs.reshape(b, m * n)).reshape(b, m, n, df)
        # a negative equal to its positive (the same codes) leaves the softmax
        neg_is_pos = (y[:, :, None, :] == negs).all(-1)
        pos_sim = _cosine(x_m, y)[:, :, None]
        neg_sim = _cosine(x_m[:, :, None, :], negs).masked_fill(neg_is_pos, -torch.inf)
        logits = torch.cat([pos_sim, neg_sim], dim=2) / self.logit_temp
        return {"logits": logits, "features_pen": features_pen,
                "prob_perplexity": q["prob_perplexity"],
                "code_perplexity": q["code_perplexity"], "num_vars": q["num_vars"],
                "targets": q["targets"], "temp": temp, "masked_valid": masked_valid,
                "mask": valid}


def wav2vec2_base_arch(cfg: dict) -> None:
    """wav2vec2 / wav2vec2_base (JAX wav2vec2.py:276-283)."""
    for key, value in (("encoder_embed_dim", 768), ("encoder_layers", 12),
                       ("encoder_attention_heads", 12), ("encoder_ffn_embed_dim", 3072),
                       ("final_dim", 256)):
        arch_default(cfg, key, value)


def wav2vec2_large_arch(cfg: dict) -> None:
    """wav2vec2_large (wav2vec2_large_librivox.yaml, JAX :286-299): pre-norm
    24 x 1024, the layer_norm extractor with conv biases, the Gumbel
    temperature (2.0, 0.1, 0.999995)."""
    for key, value in (("encoder_embed_dim", 1024), ("encoder_layers", 24),
                       ("encoder_attention_heads", 16), ("encoder_ffn_embed_dim", 4096),
                       ("final_dim", 768), ("latent_temp", (2.0, 0.1, 0.999995)),
                       ("extractor_mode", "layer_norm"), ("conv_bias", True),
                       ("layer_norm_first", True)):
        arch_default(cfg, key, value)


ARCHS = {"wav2vec2": wav2vec2_base_arch, "wav2vec2_base": wav2vec2_base_arch,
         "wav2vec2_large": wav2vec2_large_arch}


def build_wav2vec2(cfg: dict) -> Wav2Vec2PretrainModule:
    """JAX Wav2Vec2PretrainModel.build_model (wav2vec2.py:246-272)."""
    return Wav2Vec2PretrainModule(
        final_dim=_cfg(cfg, "final_dim", 256), latent_vars=_cfg(cfg, "latent_vars", 320),
        latent_groups=_cfg(cfg, "latent_groups", 2), latent_dim=_cfg(cfg, "latent_dim", 0),
        logit_temp=_cfg(cfg, "logit_temp", 0.1),
        feature_grad_mult=_cfg(cfg, "feature_grad_mult", 0.1),
        dropout_input=_cfg(cfg, "dropout_input", 0.1),
        dropout_features=_cfg(cfg, "dropout_features", 0.1), dropout=_cfg(cfg, "dropout", 0.1),
        attention_dropout=_cfg(cfg, "attention_dropout", 0.1),
        activation_dropout=_cfg(cfg, "activation_dropout", 0.0),
        layerdrop=_cfg(cfg, "encoder_layerdrop", 0.05), **encoder_config(cfg))
