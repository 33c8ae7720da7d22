"""The AR text translation transformer, fairseq's "transformer" family (the
port of diffnorm_tpu/models/transformer_text.py; reference
fairseq/models/transformer/transformer_legacy.py): the pre-norm
`TextEncoder` (`models/cmlm_text.py`) and the causal KV-cached
`ARUnitDecoder` (`models/ar_transformer.py`), so
`generate.beam_search.ar_generate` decodes it through `encode`,
`init_cache` and `decode_step`. Three archs: `transformer`,
`transformer_iwslt_de_en` and `transformer_wmt_en_de_big` (1024 wide, FF
4096, 16 heads, dropout 0.3). The decoder's output projection is its input
embedding unless share_decoder_input_output_embed is False (an unshared
`output_proj`); --share-all-embeddings is refused, as JAX refuses it: the
source and target tables are separate. It trains with
label_smoothed_cross_entropy on the "translation" task.

On the card the encoder's self-attention over a source of >= 2048 tokens
and the decoder's encoder attention (one query a row in a decode step)
take the flash-attention kernel in eval (`ops.attention.masked_attention`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from diffnorm_tpu_torch.models.ar_transformer import ARUnitDecoder, KVCache
from diffnorm_tpu_torch.models.cmlm_text import TextEncoder
from diffnorm_tpu_torch.models.layers import arch_default


class TextTransformerModule(nn.Module):
    """Text encoder + causal decoder (module docstring). The encoder's
    dropouts are all `dropout`; the decoder's attention and activation
    dropouts fall back to `dropout` where None."""

    n_frames_per_step = 1

    def __init__(self, src_vocab_size: int, tgt_vocab_size: int, encoder_dim: int = 512,
                 encoder_ffn_dim: int = 2048, encoder_layers: int = 6, encoder_heads: int = 8,
                 decoder_dim: int = 512, decoder_ffn_dim: int = 2048, decoder_layers: int = 6,
                 decoder_heads: int = 8, dropout: float = 0.1,
                 attention_dropout: Optional[float] = None,
                 activation_dropout: Optional[float] = None,
                 share_decoder_input_output_embed: bool = True):
        super().__init__()
        self.vocab_size = tgt_vocab_size
        self.encoder = TextEncoder(src_vocab_size, encoder_dim, encoder_ffn_dim, encoder_layers,
                                   encoder_heads, dropout)
        self.decoder = ARUnitDecoder(
            tgt_vocab_size, decoder_dim, decoder_ffn_dim, decoder_layers, decoder_heads,
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, context_dim=encoder_dim,
            share_input_output_embed=share_decoder_input_output_embed)

    def encode(self, src_tokens: torch.Tensor, src_lengths: Optional[torch.Tensor] = None,
               tgt_speaker=None):
        """(features [B, S, dim], mask [B, S]); the mask comes from the
        tokens, so `src_lengths` is not read."""
        return self.encoder(src_tokens)

    def init_cache(self, enc: torch.Tensor, enc_mask: torch.Tensor, max_len: int) -> KVCache:
        return self.decoder.init_cache(enc, enc_mask, max_len)

    def decode_step(self, tokens: torch.Tensor, cache: KVCache, position: torch.Tensor):
        """tokens [N, 1] -> (logits [N, V], cache)."""
        return self.decoder.decode_step(tokens, cache, position)

    def forward(self, src_tokens: torch.Tensor, src_lengths: torch.Tensor,
                prev_tokens: torch.Tensor, tgt_speaker=None) -> Dict:
        """The teacher-forced forward: {"logits" [B, L, V]}; the model takes
        no speaker (`tgt_speaker`, which the AR criterion passes, must be
        None)."""
        if tgt_speaker is not None:
            raise ValueError("the text transformer takes no target speaker")
        enc, enc_mask = self.encoder(src_tokens)
        return {"logits": self.decoder(prev_tokens, enc, enc_mask)}


def transformer_arch(cfg: dict) -> None:
    """`transformer` (JAX transformer_text.py:121-131)."""
    for key, value in (("encoder_embed_dim", 512), ("encoder_ffn_embed_dim", 2048),
                       ("encoder_layers", 6), ("encoder_attention_heads", 8),
                       ("decoder_embed_dim", 512), ("decoder_ffn_embed_dim", 2048),
                       ("decoder_layers", 6), ("decoder_attention_heads", 8), ("dropout", 0.1)):
        arch_default(cfg, key, value)


def transformer_iwslt_de_en_arch(cfg: dict) -> None:
    """`transformer_iwslt_de_en` (JAX :134-144): FF 1024, 4 heads."""
    for key, value in (("encoder_ffn_embed_dim", 1024), ("encoder_attention_heads", 4),
                       ("decoder_ffn_embed_dim", 1024), ("decoder_attention_heads", 4)):
        arch_default(cfg, key, value)
    transformer_arch(cfg)


def transformer_wmt_en_de_big_arch(cfg: dict) -> None:
    """`transformer_wmt_en_de_big` (JAX :147-156): 1024 wide, FF 4096, 16
    heads, dropout 0.3."""
    for key, value in (("encoder_embed_dim", 1024), ("encoder_ffn_embed_dim", 4096),
                       ("encoder_attention_heads", 16), ("decoder_embed_dim", 1024),
                       ("decoder_ffn_embed_dim", 4096), ("decoder_attention_heads", 16),
                       ("dropout", 0.3)):
        arch_default(cfg, key, value)
    transformer_arch(cfg)


ARCHS = {"transformer": transformer_arch,
         "transformer_iwslt_de_en": transformer_iwslt_de_en_arch,
         "transformer_wmt_en_de_big": transformer_wmt_en_de_big_arch}
