"""fairseq torch checkpoint -> the port's weights tree.

The port's copy of the HuBERT and code-HiFi-GAN parts of
diffnorm_tpu/utils/convert_weights.py. It returns the flax-path tree JAX's
converter returns (`{"params": ...}` of float32 numpy arrays), which
`weights.from_jax_params` loads, so the port's module paths stay flax
paths. Layout rules:
* torch Linear weight [out, in]       -> Dense kernel [in, out]
* torch Conv1d weight [out, in, k]    -> Conv kernel [k, in, out]
* torch grouped Conv1d [out, in/g, k] -> Conv kernel [k, in/g, out]
* torch ConvTranspose1d [in, out, k]  -> ConvTranspose kernel [k, out, in]
  (flax transpose_kernel=True)
* torch Embedding [V, D]              -> Embed embedding [V, D]
* weight norm (weight_g / weight_v) is folded: w = g * v / ||v||, the norm
  over every dim except `dim` (HiFi-GAN uses dim=0, wav2vec2's pos_conv
  dim=2)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def fold_weight_norm(g, v, dim: int = 0) -> np.ndarray:
    g, v = _t(g), _t(v)
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def conv_w(w) -> np.ndarray:
    """[out, in, k] -> [k, in, out]"""
    return _t(w).transpose(2, 1, 0)


def dense_w(w) -> np.ndarray:
    return _t(w).T


def _get_conv(sd: Dict, prefix: str, wn_dim: int = 0) -> np.ndarray:
    """A conv weight in torch's layout, weight norm folded where stored."""
    if f"{prefix}.weight_g" in sd:
        return fold_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"], dim=wn_dim)
    return _t(sd[f"{prefix}.weight"])


def load_torch_state(path: str) -> Dict:
    """A torch checkpoint's model state dict: the `model` entry of a full
    fairseq checkpoint, else the file's dict itself."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt


def convert_hubert_checkpoint(path: str, layers: int = 12) -> Dict:
    """fairseq (m)HuBERT checkpoint -> HubertEncoder variables."""
    return convert_hubert_state(load_torch_state(path), layers=layers)


def _ln(sd: Dict, prefix: str) -> Dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _dense(sd: Dict, prefix: str) -> Dict:
    return {"kernel": dense_w(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def convert_hifigan_checkpoint(path: str, cfg: Dict) -> Dict:
    """fairseq code-HiFi-GAN checkpoint -> CodeGenerator variables (the
    "generator" entry of a training checkpoint, else "model", else the
    file's dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_hifigan_state(ckpt.get("generator", ckpt.get("model", ckpt)), cfg)


def _conv(sd: Dict, prefix: str) -> Dict:
    """A weight-normed conv (or transposed conv) in the flax layout."""
    return {"kernel": _get_conv(sd, prefix).transpose(2, 1, 0), "bias": _t(sd[f"{prefix}.bias"])}


def convert_hifigan_state(sd: Dict, cfg: Dict) -> Dict:
    """A code-HiFi-GAN generator state dict -> {"params": CodeGenerator tree}
    for the vocoder config `cfg`."""
    gen: Dict = {"conv_pre": _conv(sd, "conv_pre")}
    n_k = len(cfg["resblock_kernel_sizes"])
    for i in range(len(cfg["upsample_rates"])):
        gen[f"up_{i}"] = _conv(sd, f"ups.{i}")
        for j in range(n_k):
            r = f"resblocks.{i * n_k + j}"
            block: Dict = {}
            for c in range(len(cfg["resblock_dilation_sizes"][j])):
                block[f"conv1_{c}"] = _conv(sd, f"{r}.convs1.{c}")
                block[f"conv2_{c}"] = _conv(sd, f"{r}.convs2.{c}")
            gen[f"resblock_{i}_{j}"] = block
    gen["conv_post"] = _conv(sd, "conv_post")
    params: Dict = {"generator": gen, "dict": {"embedding": _t(sd["dict.weight"])}}
    if any(k.startswith("spkr.") for k in sd):
        params["spkr"] = {"embedding": _t(sd["spkr.weight"])}
    if any(k.startswith("dur_predictor.") for k in sd):
        d = "dur_predictor"
        params[d] = {
            "conv1": {"kernel": conv_w(sd[f"{d}.conv1.0.weight"]),
                      "bias": _t(sd[f"{d}.conv1.0.bias"])},
            "ln1": _ln(sd, f"{d}.ln1"),
            "conv2": {"kernel": conv_w(sd[f"{d}.conv2.0.weight"]),
                      "bias": _t(sd[f"{d}.conv2.0.bias"])},
            "ln2": _ln(sd, f"{d}.ln2"),
            "proj": _dense(sd, f"{d}.proj"),
        }
    return {"params": params}


def convert_hubert_state(sd: Dict, layers: int = 12) -> Dict:
    """A fairseq HubertModel state dict -> {"params": HubertEncoder tree}."""
    if all(k.startswith("encoder.") for k in sd):
        sd = {k.removeprefix("encoder."): v for k, v in sd.items()}

    fe: Dict = {}
    # layer_norm extractor mode keeps a LayerNorm inside a TransposeLast
    # sandwich at index .2.1 of every layer; default mode a GroupNorm at .2
    # of layer 0 only
    ln_mode = "feature_extractor.conv_layers.0.2.1.weight" in sd
    i = 0
    while f"feature_extractor.conv_layers.{i}.0.weight" in sd:
        prefix = f"feature_extractor.conv_layers.{i}"
        fe[f"conv_{i}"] = {"kernel": conv_w(sd[f"{prefix}.0.weight"])}
        if f"{prefix}.0.bias" in sd:
            fe[f"conv_{i}"]["bias"] = _t(sd[f"{prefix}.0.bias"])
        if ln_mode:
            fe[f"ln_{i}"] = _ln(sd, f"{prefix}.2.1")
        i += 1
    if not ln_mode:
        fe["group_norm"] = _ln(sd, "feature_extractor.conv_layers.0.2")

    params: Dict = {
        "feature_extractor": fe,
        "layer_norm": _ln(sd, "layer_norm"),
        "post_extract_proj": _dense(sd, "post_extract_proj"),
        "pos_conv": {"conv": {
            "kernel": _get_conv(sd, "encoder.pos_conv.0", wn_dim=2).transpose(2, 1, 0),
            "bias": _t(sd["encoder.pos_conv.0.bias"])}},
        "encoder_layer_norm": _ln(sd, "encoder.layer_norm"),
    }
    for n in range(layers):
        p = f"encoder.layers.{n}"
        params[f"layer_{n}"] = {
            **{proj: _dense(sd, f"{p}.self_attn.{proj}")
               for proj in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
            "fc1": _dense(sd, f"{p}.fc1"),
            "fc2": _dense(sd, f"{p}.fc2"),
            "final_layer_norm": _ln(sd, f"{p}.final_layer_norm"),
        }
    return {"params": params}
