"""wav2vec2-CTC and HuBERT-CTC speech recognizers for ASR-BLEU, inference only.

The port's counterpart of the model JAX's `eval/asr_bleu.py:ASRGenerator`
runs through `transformers.AutoModelForCTC` (Wav2Vec2ForCTC or HubertForCTC,
by the config's `model_type`), built on the port's `HubertEncoder`: wav2vec2
and HuBERT share the encoder. From a Hugging Face `config.json`:
  feat_extract_norm "group" -> extractor_mode "default" (GroupNorm on the
    first conv), "layer" -> "layer_norm" (a LayerNorm after every conv)
  do_stable_layer_norm -> layer_norm_first (pre-norm layers, the encoder
    LayerNorm at the end)
  conv_dim / conv_kernel / conv_stride, conv_bias, num_conv_pos_embeddings /
    num_conv_pos_embedding_groups and layer_norm_eps as they are
  feat_proj_layer_norm (HuBERT only; wav2vec2 always has it) -> whether the
    extractor's output passes a LayerNorm before the projection
then `lm_head`, a Dense onto the CTC vocabulary. Logits are float32 when the
weights are. A HuBERT checkpoint's names carry the prefix `hubert.` where
wav2vec2's carry `wav2vec2.`. HuBERT's `conv_pos_batch_norm` (a BatchNorm
in place of the positional conv's weight norm) is not ported and raises.

`load_ctc_checkpoint(dir)` reads a checkpoint directory as
`save_pretrained` writes it: config.json, preprocessor_config.json,
vocab.json, tokenizer_config.json, and the weights from model.safetensors
(read by `read_safetensors`, a parser of its own: the port does not need the
safetensors package) or pytorch_model.bin (`torch.load(weights_only=True)`).
HF's names map onto the port's module paths (`hf_key`); a name left over or
missing raises, except `masked_spec_embed`, which inference does not use.
The positional conv's weight norm is folded, in either of HF's forms
(`weight_g` / `weight_v` of the released checkpoints, or
`parametrizations.weight.original0/1`): g * v / ||v||, the norm over every
dim but dim 2.

`normalize_waveform` is the feature extractor's do_normalize, and
`ctc_decode` Wav2Vec2CTCTokenizer.batch_decode with its defaults.
"""

from __future__ import annotations

import json
import os
import re
import struct
from itertools import groupby
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from diffnorm_tpu_torch.models.hubert import HubertEncoder
from diffnorm_tpu_torch.models.layers import Dense
from diffnorm_tpu_torch.utils.convert_weights import fold_weight_norm

# Wav2Vec2Config's defaults, for keys an older config.json lacks
HF_DEFAULTS = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
    conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
    conv_bias=False, feat_extract_norm="group", do_stable_layer_norm=False,
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16, layer_norm_eps=1e-5,
    vocab_size=32, hidden_act="gelu", feat_extract_activation="gelu",
    feat_proj_layer_norm=True, conv_pos_batch_norm=False)
EXTRACTOR_MODES = {"group": "default", "layer": "layer_norm"}
# model_type -> the prefix of the encoder's names in the checkpoint
PREFIXES = {"wav2vec2": "wav2vec2", "hubert": "hubert"}
UNUSED = ("masked_spec_embed",)  # under the prefix
POS_CONV = "encoder.pos_conv_embed.conv"  # under the prefix

# port module path -> HF name under the prefix ("{p}."), in order; the
# first that matches is taken
_NAME_RULES = (
    (r"^encoder\.feature_extractor\.conv_(\d+)\.", r"{p}.feature_extractor.conv_layers.\1.conv."),
    (r"^encoder\.feature_extractor\.ln_(\d+)\.",
     r"{p}.feature_extractor.conv_layers.\1.layer_norm."),
    (r"^encoder\.feature_extractor\.group_norm\.",
     "{p}.feature_extractor.conv_layers.0.layer_norm."),
    (r"^encoder\.layer_norm\.", "{p}.feature_projection.layer_norm."),
    (r"^encoder\.post_extract_proj\.", "{p}.feature_projection.projection."),
    (r"^encoder\.pos_conv\.conv\.", "{p}." + POS_CONV + "."),
    (r"^encoder\.encoder_layer_norm\.", "{p}.encoder.layer_norm."),
    (r"^encoder\.layer_(\d+)\.(q|k|v|out)_proj\.", r"{p}.encoder.layers.\1.attention.\2_proj."),
    (r"^encoder\.layer_(\d+)\.self_attn_layer_norm\.", r"{p}.encoder.layers.\1.layer_norm."),
    (r"^encoder\.layer_(\d+)\.fc1\.", r"{p}.encoder.layers.\1.feed_forward.intermediate_dense."),
    (r"^encoder\.layer_(\d+)\.fc2\.", r"{p}.encoder.layers.\1.feed_forward.output_dense."),
    (r"^encoder\.layer_(\d+)\.final_layer_norm\.", r"{p}.encoder.layers.\1.final_layer_norm."),
    (r"^lm_head\.", "lm_head."),
)
# the weight-norm forms of the positional conv: (g, v)
_WEIGHT_NORM = (("weight_g", "weight_v"),
                ("parametrizations.weight.original0", "parametrizations.weight.original1"))
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool}


def hf_key(name: str, prefix: str = "wav2vec2") -> str:
    """The HF Wav2Vec2ForCTC (HubertForCTC with prefix "hubert") name of a
    `Wav2Vec2CTC` state-dict entry."""
    for pattern, repl in _NAME_RULES:
        if re.match(pattern, name):
            return re.sub(pattern, repl.replace("{p}", prefix), name)
    raise KeyError(f"no HF name for {name}")


class Wav2Vec2CTC(nn.Module):
    """wav2vec2 or HuBERT encoder + CTC head: input_values [B, T] -> logits
    [B, frames, vocab]."""

    def __init__(self, config: Dict):
        super().__init__()
        cfg = {**HF_DEFAULTS, **config}
        model_type = cfg.get("model_type", "wav2vec2")
        if model_type not in PREFIXES:
            raise NotImplementedError(f"model_type {model_type!r}: only wav2vec2-CTC and "
                                      f"HuBERT-CTC")
        self.prefix = PREFIXES[model_type]
        for key in ("add_adapter", "adapter_attn_dim", "use_weighted_layer_sum",
                    "conv_pos_batch_norm"):
            if cfg.get(key):
                raise NotImplementedError(f"{model_type} config {key}={cfg[key]!r} is not ported")
        for key in ("hidden_act", "feat_extract_activation"):
            if cfg[key] != "gelu":
                raise NotImplementedError(f"{model_type} config {key}={cfg[key]!r}: only gelu")
        if cfg["feat_extract_norm"] not in EXTRACTOR_MODES:
            raise ValueError(f"feat_extract_norm {cfg['feat_extract_norm']!r}: 'group' or 'layer'")
        self.encoder = HubertEncoder(
            dim=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
            heads=cfg["num_attention_heads"], ffn_dim=cfg["intermediate_size"],
            conv_feature_layers=list(zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"])),
            extractor_mode=EXTRACTOR_MODES[cfg["feat_extract_norm"]],
            conv_bias=bool(cfg["conv_bias"]), layer_norm_first=bool(cfg["do_stable_layer_norm"]),
            layer_norm_eps=float(cfg["layer_norm_eps"]),
            pos_conv_kernel=cfg["num_conv_pos_embeddings"],
            pos_conv_groups=cfg["num_conv_pos_embedding_groups"],
            feature_layer_norm=model_type == "wav2vec2" or bool(cfg["feat_proj_layer_norm"]))
        self.lm_head = Dense(cfg["hidden_size"], cfg["vocab_size"])

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.encoder(input_values))


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets}} (and `__metadata__`), then
    the raw little-endian tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"]).clone()
    return out


def hf_to_port_state(sd: Dict[str, torch.Tensor], model: Wav2Vec2CTC) -> Dict[str, torch.Tensor]:
    """An HF Wav2Vec2ForCTC or HubertForCTC state dict -> `model`'s state
    dict (float32). Raises on an HF name left over or a port name missing."""
    sd = dict(sd)
    p = model.prefix
    pos_conv = f"{p}.{POS_CONV}"
    for g, v in _WEIGHT_NORM:
        if f"{pos_conv}.{g}" in sd:
            sd[pos_conv + ".weight"] = torch.from_numpy(fold_weight_norm(
                sd.pop(f"{pos_conv}.{g}"), sd.pop(f"{pos_conv}.{v}"), dim=2))
    state, missing = {}, []
    for name in model.state_dict():
        key = hf_key(name, p)
        if key in sd:
            state[name] = sd.pop(key).float()
        else:
            missing.append(key)
    for key in UNUSED:
        sd.pop(f"{p}.{key}", None)
    if missing or sd:
        raise KeyError(f"{p}-CTC checkpoint: missing {missing}, not used {sorted(sd)}")
    return state


class CTCCheckpoint(NamedTuple):
    model: Wav2Vec2CTC
    preprocessor: Dict  # preprocessor_config.json
    vocab: Dict[str, int]  # vocab.json
    tokenizer: Dict  # tokenizer_config.json (with special_tokens_map.json under it)


def _read_json(path: str, default=None):
    if not os.path.exists(path):
        if default is None:
            raise FileNotFoundError(path)
        return default
    with open(path) as f:
        return json.load(f)


def load_ctc_checkpoint(path: str, device="cpu") -> CTCCheckpoint:
    """A `save_pretrained` wav2vec2-CTC or HuBERT-CTC directory, the model
    float32 on `device` in eval mode."""
    config = _read_json(os.path.join(path, "config.json"))
    weights = os.path.join(path, "model.safetensors")
    if os.path.exists(weights):
        sd = read_safetensors(weights)
    else:
        weights = os.path.join(path, "pytorch_model.bin")
        if not os.path.exists(weights):
            raise FileNotFoundError(f"{path}: neither model.safetensors nor pytorch_model.bin")
        sd = torch.load(weights, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = Wav2Vec2CTC(config)
    model.load_state_dict(hf_to_port_state(sd, model), assign=True)
    tokenizer = {**_read_json(os.path.join(path, "special_tokens_map.json"), {}),
                 **_read_json(os.path.join(path, "tokenizer_config.json"), {})}
    if tokenizer.get("target_lang"):
        raise NotImplementedError("a multilingual (target_lang) CTC vocabulary is not ported")
    return CTCCheckpoint(model.to(device).eval(),
                         _read_json(os.path.join(path, "preprocessor_config.json"), {}),
                         _read_json(os.path.join(path, "vocab.json")), tokenizer)


def normalize_waveform(wav: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor's do_normalize on one utterance, in
    float32: (x - mean) / sqrt(var + 1e-7)."""
    x = np.asarray(wav, dtype=np.float32)
    return (x - x.mean()) / np.sqrt(x.var() + 1e-7)


def _token(value) -> str:
    """A special token as tokenizer_config.json stores it: a string or an
    AddedToken dict."""
    return value["content"] if isinstance(value, dict) else value


def clean_up_tokenization(text: str) -> str:
    """PreTrainedTokenizerBase.clean_up_tokenization."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


def ctc_decode(ids: Sequence[int], vocab: Dict[str, int], tokenizer_config: Dict) -> str:
    """Wav2Vec2CTCTokenizer.batch_decode of one row with its defaults:
    repeats grouped, the pad (CTC blank) dropped, the word delimiter made a
    space, the other special tokens kept as strings, then stripped (and
    lowercased / cleaned up where the tokenizer config says so)."""
    decoder = {i: t for t, i in vocab.items()}
    for i, tok in (tokenizer_config.get("added_tokens_decoder") or {}).items():
        decoder[int(i)] = _token(tok)
    unk = _token(tokenizer_config.get("unk_token", "<unk>"))
    pad = _token(tokenizer_config.get("pad_token", "<pad>"))
    delimiter = _token(tokenizer_config.get("word_delimiter_token", "|"))
    space = tokenizer_config.get("replace_word_delimiter_char", " ")
    tokens: List[str] = [decoder.get(int(i), unk) for i in ids]
    chars = [t for t, _ in groupby(tokens) if t != pad]
    text = "".join(space if c == delimiter else c for c in chars).strip()
    if tokenizer_config.get("do_lower_case", False):
        text = text.lower()
    if tokenizer_config.get("clean_up_tokenization_spaces", False):
        text = clean_up_tokenization(text)
    return text
