"""Non-autoregressive CMLM speech-to-unit translator.

Counterpart of diffnorm_tpu/models/nar_transformer.py with the shared
input/output embedding: a conformer encoder over 80-d fbank, a NAT unit
decoder (pre-norm layers with full-context self-attention, encoder
attention and a ReLU FF; sinusoidal positions keyed on the pad structure;
logits = x @ embed^T) and a 256-way length head over the mean-pooled
encoder states. The decoder's attention runs through
`ops.attention.masked_attention`, whose encoder attention takes the
flash-attention kernel on the card once the subsampled source reaches 2048
frames and no attention dropout applies. Names follow the flax tree
(`weights.from_jax_variables`).

The model's options (JAX :38-116, :224-308, :362-420):
* `n_frames_per_step` k > 1, stacked units: the canvas holds packed ids
  (`models/stacked.py`), embedded by a `StackedEmbedding`; the final
  features go through `out_proj_n_frames` (D -> k D, no bias) and
  `subframe_out` (D -> V, no bias) to logits [B, T, k, V];
* `multitask`, the --multitask-config-yaml aux heads (`AuxTaskSpec`): a
  linear CTC head (`mt_{name}_ctc`) over a tapped encoder layer or decoder
  inner state, or a small causal transformer decoder (`mt_{name}_decoder`,
  `models/ar_transformer.py`) cross-attending a tapped encoder layer; they
  run in the training and validation forward only;
* `ctc_vocab`, the --multitask-ctc-vocab head `ctc_proj` over the final
  encoder features;
* `target_speaker_embed`: a [B, speaker_embed_dim] embedding concatenated
  to every encoder frame and projected back by `spk_emb_proj`.

Training (`NARS2UTModule.forward` in training mode) has JAX's dropouts, its
classifier-free-guidance drop of whole sources (`cg_prob`) and
self-prompting (`use_sp`); the dropouts draw from each module's `generator`
(`layers.set_dropout_generator`), the CG and SP draws from the model's
`cg_generator` and `sp_generator`, which the trainer sets.

`quant_int8` (JAX's `NARS2UTModule(quant_int8=True)`, the int8 NAR decode
of `bench.py --e2e` and `cli.generate --quant-int8`) makes every projection
of the conformer's attention and FFNs and of the decoder's self- and
encoder attention and FF an int8 W8A8 `Dense` site (ops/quant.py, JAX's
default knobs): 8 sites a conformer layer, 10 a decoder layer; the length
head and the output projection stay float. Build the model in float32, load
its weights (which packs the int8 weights from the float32 masters), then
cast. `calibrate_act_scales` records the sites' static activation scales on
one forward, as JAX's `calibrate_apply` does.

Dictionary layout: bos=0, pad=1, eos=2, unk=3 (mask token), units at +4.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import ConformerEncoder, layer_norm
from diffnorm_tpu_torch.models.layers import (
    Dense,
    Dropout,
    DropoutSite,
    arch_default,
    sinusoidal_positions,
)
from diffnorm_tpu_torch.models.stacked import OFFSET, StackedEmbedding, pack_units
from diffnorm_tpu_torch.ops import attention as attention_ops
from diffnorm_tpu_torch.ops.quant import calibrating, quant_sites
from diffnorm_tpu_torch.parallel.mesh import draw_rows

PAD, BOS, EOS, UNK = 1, 0, 2, 3


class AuxTaskSpec(NamedTuple):
    """One --multitask-config-yaml task as a model spec (reference
    build_multitask_decoder, s2s_transformer.py:171-230, and the defaults of
    base_multitask_text_transformer_decoder_arch :582-616). input_layer is
    the Python index of the tapped state: -1 the final encoder layer or the
    last decoder inner state."""

    name: str
    decoder_type: str  # "transformer" | "ctc"
    vocab_size: int
    input_from: str = "encoder"  # "encoder" | "decoder"
    input_layer: int = -1
    decoder_layers: int = 2
    decoder_dim: int = 256
    decoder_heads: int = 4
    decoder_ffn_dim: int = 2048
    dropout: float = 0.3


def build_aux_heads(module: nn.Module, specs: Sequence[AuxTaskSpec], encoder_dim: int,
                    decoder_dim: int) -> None:
    """Add each spec's aux head to `module`: a linear CTC projection
    `mt_{name}_ctc` over the tapped encoder or decoder state, or a causal
    transformer decoder `mt_{name}_decoder` over the tapped encoder layer."""
    from diffnorm_tpu_torch.models.ar_transformer import ARUnitDecoder

    for spec in specs:
        if spec.decoder_type == "ctc":
            in_dim = decoder_dim if spec.input_from == "decoder" else encoder_dim
            module.add_module(f"mt_{spec.name}_ctc", Dense(in_dim, spec.vocab_size))
        else:
            module.add_module(f"mt_{spec.name}_decoder", ARUnitDecoder(
                spec.vocab_size, dim=spec.decoder_dim, ffn_dim=spec.decoder_ffn_dim,
                layers=spec.decoder_layers, heads=spec.decoder_heads, dropout=spec.dropout,
                context_dim=encoder_dim))


def aux_head_outputs(module: nn.Module, specs: Sequence[AuxTaskSpec],
                     multitask_prev: Optional[Dict[str, torch.Tensor]], enc_states,
                     enc_mask: torch.Tensor, inner, dec_tokens: torch.Tensor) -> Dict:
    """Each aux head over its tapped state: enc_states are the encoder's
    per-layer outputs, inner the decoder's [embed_out, after layer 1, ...]
    (None without a decoder tap), dec_tokens the decoder's input (the mask
    of a decoder-tapped CTC head). A transformer head cross-attends the
    tapped ENCODER state whatever its input_from, as the reference's
    criterion.py:69-80 does. Returns {name: {"logits", and "mask" for a
    CTC head}}."""
    out = {}
    for spec in specs:
        if spec.decoder_type == "ctc":
            if spec.input_from == "decoder":
                tapped, mask = inner[spec.input_layer], dec_tokens != PAD
            else:
                tapped, mask = enc_states[spec.input_layer], enc_mask
            out[spec.name] = {"logits": getattr(module, f"mt_{spec.name}_ctc")(tapped),
                              "mask": mask}
        else:
            head = getattr(module, f"mt_{spec.name}_decoder")
            out[spec.name] = {"logits": head(multitask_prev[spec.name],
                                             enc_states[spec.input_layer], enc_mask)}
    return out


class MultiheadAttention(DropoutSite, nn.Module):
    """fairseq-style MHA (biased q/k/v/out projections); `dropout` drops
    attention probabilities in training mode; `causal` masks future keys;
    the keys and values project from `context_dim` features (default
    `dim`).

    Decoding (models/ar_transformer.py's `KVCache`) passes `kv`, keys and
    values [B, H, S, d] in place of the projected context: with `write_at`
    = t a self-attention cache, into which the step's own keys and values go
    at position t, the query attending positions <= t without the causal
    mask (JAX's decode mode); without it the encoder keys and values, as
    `project_kv` gives them once per decode."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0, quant: bool = False,
                 causal: bool = False, context_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.dropout, self.causal = dropout, causal
        kv_dim = context_dim or dim
        self.q_proj = Dense(dim, dim, quant=quant)
        self.k_proj = Dense(kv_dim, dim, quant=quant)
        self.v_proj = Dense(kv_dim, dim, quant=quant)
        self.out_proj = Dense(dim, dim, quant=quant)

    def _heads(self, z: torch.Tensor) -> torch.Tensor:
        """[B, T, H * d] -> [B, H, T, d]."""
        return z.reshape(z.shape[0], z.shape[1], self.heads, -1).transpose(1, 2)

    def project_kv(self, context: torch.Tensor):
        """The keys and values of `context` [B, S, C], [B, H, S, d] each,
        contiguous as the flash-attention kernel reads them."""
        return (self._heads(self.k_proj(context)).contiguous(),
                self._heads(self.v_proj(context)).contiguous())

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, kv=None,
                write_at: Optional[int] = None) -> torch.Tensor:
        b, tq, _ = x.shape
        q, causal = self._heads(self.q_proj(x)), self.causal
        if kv is None:
            ctx = x if context is None else context
            k, v = self._heads(self.k_proj(ctx)), self._heads(self.v_proj(ctx))
        else:
            k, v = kv
            if write_at is not None:
                end = write_at + tq
                k[:, :, write_at:end] = self._heads(self.k_proj(x))
                v[:, :, write_at:end] = self._heads(self.v_proj(x))
                k, v, causal = k[:, :, :end], v[:, :, :end], False
        out = attention_ops.masked_attention(
            q, k, v, mask=mask, dropout=self.dropout if self.training else 0.0,
            generator=self.generator, causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, tq, self.dim))


class DecoderLayer(nn.Module):
    """Pre-norm decoder layer: self-attention (causal where `causal`, the AR
    decoder's), encoder attention over `context_dim` features, ReLU FF, each
    sublayer's output dropped by `dropout`, the FF activation by
    `activation_dropout`, attention probabilities by `attention_dropout`."""

    def __init__(self, dim: int, ffn_dim: int, heads: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 quant: bool = False, causal: bool = False,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.self_attn_layer_norm = layer_norm(dim)
        self.self_attn = MultiheadAttention(dim, heads, attention_dropout, quant, causal=causal)
        self.self_attn_dropout = Dropout(dropout)
        self.encoder_attn_layer_norm = layer_norm(dim)
        self.encoder_attn = MultiheadAttention(dim, heads, attention_dropout, quant,
                                               context_dim=context_dim)
        self.encoder_attn_dropout = Dropout(dropout)
        self.final_layer_norm = layer_norm(dim)
        self.fc1 = Dense(dim, ffn_dim, quant=quant)
        self.activation_dropout = Dropout(activation_dropout)
        self.fc2 = Dense(ffn_dim, dim, quant=quant)
        self.ff_dropout = Dropout(dropout)

    def forward(self, x, self_mask, enc, enc_mask, self_kv=None, enc_kv=None,
                write_at: Optional[int] = None):
        """`self_kv`, `write_at` and `enc_kv` are a decode step's cache
        (`MultiheadAttention`'s `kv`), `enc` then unused."""
        x = x + self.self_attn_dropout(self.self_attn(
            self.self_attn_layer_norm(x), mask=self_mask, kv=self_kv, write_at=write_at))
        x = x + self.encoder_attn_dropout(self.encoder_attn(
            self.encoder_attn_layer_norm(x), context=enc, mask=enc_mask, kv=enc_kv))
        h = self.activation_dropout(F.relu(self.fc1(self.final_layer_norm(x))))
        return x + self.ff_dropout(self.fc2(h))


class NATUnitDecoder(nn.Module):
    """NAT unit decoder with a length head (shared input/output embedding;
    with n_frames_per_step k > 1 the stacked-unit input and sub-frame
    output)."""

    def __init__(self, vocab_size: int, dim: int = 512, ffn_dim: int = 2048,
                 layers: int = 6, heads: int = 8, max_lengths: int = 256,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0, quant: bool = False,
                 n_frames_per_step: int = 1):
        super().__init__()
        self.dim, self.n_layers, self.max_lengths = dim, layers, max_lengths
        self.n_frames_per_step = n_frames_per_step
        if n_frames_per_step > 1:
            self.embed_tokens = StackedEmbedding(vocab_size, dim, n_frames_per_step)
            self.out_proj_n_frames = Dense(dim, dim * n_frames_per_step, bias=False)
            self.subframe_out = Dense(dim, vocab_size, bias=False)
        else:
            self.embed_tokens = nn.Embedding(vocab_size, dim)
        self.embed_length = nn.Embedding(max_lengths, dim)
        tables = (self.embed_length,) if n_frames_per_step > 1 else (
            self.embed_tokens, self.embed_length)
        for emb in tables:
            nn.init.normal_(emb.weight, std=dim ** -0.5)
        self.embed_dropout = Dropout(dropout)
        for i in range(layers):
            self.add_module(f"layer_{i}", DecoderLayer(dim, ffn_dim, heads, dropout,
                                                       attention_dropout, activation_dropout,
                                                       quant))
        self.layer_norm = layer_norm(dim)

    def null_context(self) -> torch.Tensor:
        """The BOS embedding, the CG null encoder feature [1, dim]."""
        if self.n_frames_per_step > 1:
            return self.embed_tokens(torch.full((1,), BOS, device=self.layer_norm.weight.device))
        return self.embed_tokens.weight[BOS:BOS + 1]

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor,
                return_inner: bool = False):
        """tokens [B, T]; enc [B, S, C]; enc_mask [B, S] True = valid.
        Returns logits [B, T, vocab] ([B, T, k, vocab] when stacked) in the
        model's dtype; with `return_inner` also the hidden states before the
        final norm, [embed_out, after layer 1, ...] (fairseq's
        inner_states, which decoder-tapped CTC heads index)."""
        valid = tokens != PAD
        x = self.embed_tokens(tokens) * math.sqrt(self.dim)
        x = self.embed_dropout(
            x + sinusoidal_positions(valid, self.dim, padding_idx=PAD).to(x.dtype))
        inner = [x]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, valid, enc, enc_mask)
            inner.append(x)
        x = self.layer_norm(x)
        k = self.n_frames_per_step
        if k > 1:
            b, t, _ = x.shape
            logits = self.subframe_out(self.out_proj_n_frames(x).reshape(b, t, k, self.dim))
        else:
            logits = F.linear(x, self.embed_tokens.weight)
        return (logits, inner) if return_inner else logits

    def forward_length(self, enc: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        """Mean-pooled encoder states -> [B, max_lengths] logits."""
        m = enc_mask[..., None].to(enc.dtype)
        pooled = (enc * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return pooled @ self.embed_length.weight.to(pooled.dtype).t()


@contextlib.contextmanager
def _eval_mode(module: nn.Module):
    """`module` in eval mode (no dropout) for the duration, then back in the
    mode it was in."""
    was_training = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was_training)


class NARS2UTModule(nn.Module):
    """Conformer encoder + NAT unit decoder. Dimensions and dropout follow
    the `nar_s2ut_conformer` arch defaults; `attention_dropout` and
    `activation_dropout` fall back to `dropout` where None. The options
    (module docstring): `n_frames_per_step`, `multitask` (AuxTaskSpecs),
    `ctc_vocab`, `target_speaker_embed` with `speaker_embed_dim`;
    `encoder_remat` recomputes each conformer layer in the backward."""

    def __init__(self, vocab_size: int = 1004, in_channels: int = 80,
                 encoder_dim: int = 512, encoder_ffn_dim: int = 2048,
                 encoder_layers: int = 12, encoder_heads: int = 8,
                 decoder_dim: int = 512, decoder_ffn_dim: int = 2048,
                 decoder_layers: int = 6, decoder_heads: int = 8,
                 depthwise_kernel_size: int = 31, conv_channels: int = 1024,
                 conv_kernel_sizes: Sequence[int] = (5, 5), dropout: float = 0.1,
                 attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None, cg_prob: float = 0.0,
                 use_sp: bool = False, quant_int8: bool = False,
                 n_frames_per_step: int = 1, multitask: Sequence[AuxTaskSpec] = (),
                 ctc_vocab: int = 0, target_speaker_embed: bool = False,
                 speaker_embed_dim: int = 256, encoder_remat: bool = False):
        super().__init__()
        self.vocab_size, self.cg_prob, self.use_sp = vocab_size, cg_prob, use_sp
        self.n_frames_per_step, self.multitask = n_frames_per_step, tuple(multitask)
        self.cg_generator: Optional[torch.Generator] = None
        self.sp_generator: Optional[torch.Generator] = None
        attention_dropout = dropout if attention_dropout is None else attention_dropout
        activation_dropout = dropout if activation_dropout is None else activation_dropout
        if target_speaker_embed:
            self.spk_emb_proj = Dense(encoder_dim + speaker_embed_dim, encoder_dim)
        self.encoder = ConformerEncoder(in_channels, encoder_dim, encoder_ffn_dim,
                                        encoder_layers, encoder_heads,
                                        depthwise_kernel_size, conv_channels,
                                        conv_kernel_sizes, dropout, attention_dropout,
                                        activation_dropout, quant_int8,
                                        remat=encoder_remat)
        self.decoder = NATUnitDecoder(vocab_size, decoder_dim, decoder_ffn_dim,
                                      decoder_layers, decoder_heads, dropout=dropout,
                                      attention_dropout=attention_dropout,
                                      activation_dropout=activation_dropout, quant=quant_int8,
                                      n_frames_per_step=n_frames_per_step)
        if ctc_vocab:
            self.ctc_proj = Dense(encoder_dim, ctc_vocab)
        build_aux_heads(self, self.multitask, encoder_dim, decoder_dim)

    def apply_speaker(self, enc: torch.Tensor, tgt_speaker: Optional[torch.Tensor]):
        """The speaker-conditioned encoder output: the [B, D] embedding
        concatenated to every frame, projected back to encoder_dim
        (s2s_transformer.py:44-52). As it is without the option or an
        embedding."""
        if not hasattr(self, "spk_emb_proj") or tgt_speaker is None:
            return enc
        spk = tgt_speaker[:, None, :].to(enc.dtype).expand(-1, enc.shape[1], -1)
        return self.spk_emb_proj(torch.cat([enc, spk], dim=-1))

    def encode(self, src: torch.Tensor, src_lengths: torch.Tensor,
               tgt_speaker: Optional[torch.Tensor] = None):
        enc, enc_mask = self.encoder(src, src_lengths)
        return self.apply_speaker(enc, tgt_speaker), enc_mask

    def apply_cg_drop(self, enc: torch.Tensor, enc_mask: torch.Tensor, drop: torch.Tensor):
        """Replace dropped rows' encoder output with the BOS null context and
        mark every position valid. drop: [B] bool."""
        null = self.decoder.null_context().to(enc.dtype)
        enc = torch.where(drop[:, None, None], null[None], enc)
        enc_mask = torch.where(drop[:, None], True, enc_mask)
        return enc, enc_mask

    def decode(self, tokens, enc, enc_mask):
        return self.decoder(tokens, enc, enc_mask)

    def forward_length(self, enc, enc_mask):
        return self.decoder.forward_length(enc, enc_mask)

    def self_prompt(self, prev_tokens: torch.Tensor, enc: torch.Tensor,
                    enc_mask: torch.Tensor, use_prompt: torch.Tensor):
        """Self-prompting (JAX nar_transformer.py:480-506): a draft y0 of the
        canvas by the decoder without dropout or gradient, specials banned,
        PAD and EOS kept (stacked: the sub-frames' argmax re-packed); its
        embedding goes before the encoder frames where `use_prompt` (a 0-d
        bool), else the frames are padded by as many masked positions, so
        the key length does not depend on the draw."""
        with torch.no_grad(), _eval_mode(self.decoder):
            draft_logits = self.decoder(prev_tokens, enc, enc_mask).float()
        draft_logits[..., :4] = torch.finfo(torch.float32).min
        draft = draft_logits.argmax(-1)
        if draft.dim() == 3:
            draft = pack_units(torch.clamp(draft - OFFSET, min=0), self.vocab_size - OFFSET,
                               self.n_frames_per_step)
        keep = (prev_tokens == PAD) | (prev_tokens == EOS)
        y0 = torch.where(keep, prev_tokens, draft.to(prev_tokens.dtype))
        prompt = self.decoder.embed_tokens(y0).detach().to(enc.dtype)
        n = prompt.shape[1]
        sp_enc = torch.cat([prompt, enc], dim=1)
        sp_mask = torch.cat([y0 != PAD, enc_mask], dim=1)
        pad_enc = F.pad(enc, (0, 0, 0, n))
        pad_mask = F.pad(enc_mask, (0, n), value=False)
        return (torch.where(use_prompt, sp_enc, pad_enc),
                torch.where(use_prompt, sp_mask, pad_mask))

    def forward(self, src: torch.Tensor, src_lengths: torch.Tensor, prev_tokens: torch.Tensor,
                tgt_tokens: torch.Tensor, cg_drop: Optional[torch.Tensor] = None,
                use_prompt: Optional[torch.Tensor] = None,
                multitask_prev: Optional[Dict[str, torch.Tensor]] = None,
                tgt_speaker: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The training and validation forward (JAX's __call__ with
        tgt_tokens). src [B, T, 80], prev_tokens the CMLM canvas [B, L],
        tgt_tokens the targets [B, L] ([B, L, k] per sub-frame when
        stacked), multitask_prev {task: prev_output_tokens} of the
        transformer aux heads, tgt_speaker [B, D]. In training mode, rows
        are CG-dropped with cg_prob and (use_sp) the self-prompt is taken
        with 0.5, drawn from cg_generator and sp_generator unless given as
        `cg_drop` [B] bool and `use_prompt` 0-d bool. Returns logits
        [B, L, V] ([B, L, k, V]), word_ins_mask (the canvas's UNK
        positions), length_logits [B, 256] and length_tgt, the target
        lengths (packed steps) clipped to 255; ctc_logits and ctc_mask with
        the CTC head; multitask, the aux heads' outputs (`aux_head_outputs`),
        which tap the encoder states before the speaker, CG and SP."""
        if self.multitask:
            enc, enc_mask, enc_states = self.encoder(src, src_lengths, return_all_layers=True)
        else:
            enc, enc_mask = self.encoder(src, src_lengths)
        enc = self.apply_speaker(enc, tgt_speaker)
        raw_enc_mask = enc_mask
        length_logits = self.decoder.forward_length(enc, enc_mask)
        tgt_steps = tgt_tokens[..., 0] if tgt_tokens.dim() == 3 else tgt_tokens
        length_tgt = torch.clamp((tgt_steps != PAD).sum(dim=1), 0, self.decoder.max_lengths - 1)
        if self.training and self.cg_prob > 0.0:
            if cg_drop is None:
                cg_drop = draw_rows(lambda n: torch.rand(n, generator=self.cg_generator,
                                                         device=enc.device),
                                    enc.shape[0]) < self.cg_prob
            enc, enc_mask = self.apply_cg_drop(enc, enc_mask, cg_drop)
        if self.training and self.use_sp:
            if use_prompt is None:
                use_prompt = torch.rand((), generator=self.sp_generator, device=enc.device) < 0.5
            enc, enc_mask = self.self_prompt(prev_tokens, enc, enc_mask, use_prompt)
        need_inner = any(s.input_from == "decoder" for s in self.multitask)
        logits = self.decoder(prev_tokens, enc, enc_mask, return_inner=need_inner)
        if need_inner:
            logits, inner = logits
        out = {"logits": logits, "word_ins_mask": prev_tokens == UNK,
               "length_logits": length_logits, "length_tgt": length_tgt}
        if hasattr(self, "ctc_proj"):
            out["ctc_logits"], out["ctc_mask"] = self.ctc_proj(enc), enc_mask
        if self.multitask:
            # decoder taps index inner_states[decoder_layer - 1] over the
            # CMLM canvas, as fairseq's (research/TranSpeech/criterion.py:62-67)
            out["multitask"] = aux_head_outputs(
                self, self.multitask, multitask_prev, enc_states, raw_enc_mask,
                inner if need_inner else None, prev_tokens)
        return out


@torch.no_grad()
def calibrate_act_scales(model: NARS2UTModule, src: torch.Tensor, src_lengths: torch.Tensor,
                         target: Optional[torch.Tensor] = None) -> int:
    """Record every int8 site's activation amax over one eval-mode forward
    (JAX's `calibrate_apply` around `NARS2UTModule.__call__`, as
    cli/generate.py:_calibrate_static runs it on the first batch): the
    encoder over `src`, then the decoder over the canvas the decode loop
    fills, UNK where `target` [B, L] is not PAD (an all-UNK canvas of 32
    without a target). The sites keep their mode: turn static scales on with
    `ops.quant.set_static_scales`. Returns the number of sites that hold an
    amax (0 for a model without int8)."""
    if target is not None:
        canvas = torch.where(target != PAD, UNK, PAD)
    else:
        canvas = torch.full((src.shape[0], 32), UNK, dtype=torch.int64, device=src.device)
    with calibrating(model), _eval_mode(model):
        enc, enc_mask = model.encode(src, src_lengths)
        model.decode(canvas, enc, enc_mask)
    return sum(site.act_amax is not None for _, site in quant_sites(model))


def nar_s2ut_conformer_arch(cfg: dict) -> None:
    """The `nar_s2ut_conformer` defaults for every width left None in
    `cfg` (JAX nar_transformer.py:584-606); only ESPnet rel-pos attention is
    implemented, as in JAX."""
    for key, value in (("encoder_embed_dim", 512), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 12), ("encoder_attention_heads", 8)):
        arch_default(cfg, key, value)
    arch_default(cfg, "decoder_embed_dim", cfg["encoder_embed_dim"])
    arch_default(cfg, "decoder_ffn_embed_dim", cfg["encoder_ffn_embed_dim"])
    for key, value in (("decoder_layers", 6), ("decoder_attention_heads", 8),
                       ("dropout", 0.1), ("depthwise_conv_kernel_size", 31),
                       ("attn_type", "espnet"), ("pos_enc_type", "rel_pos")):
        arch_default(cfg, key, value)
    if cfg["attn_type"] != "espnet" or cfg["pos_enc_type"] != "rel_pos":
        raise ValueError(
            f"unsupported --attn-type {cfg['attn_type']} / --pos-enc-type "
            f"{cfg['pos_enc_type']}: the conformer encoder implements the ESPnet rel-pos "
            f"attention the DiffNorm recipes use")


def nar_s2ut_conformer_fisher_arch(cfg: dict) -> None:
    arch_default(cfg, "encoder_embed_dim", 256)
    arch_default(cfg, "encoder_attention_heads", 4)
    nar_s2ut_conformer_arch(cfg)


ARCHS = {"nar_s2ut_conformer": nar_s2ut_conformer_arch,
         "nar_s2ut_conformer_fisher": nar_s2ut_conformer_fisher_arch}
