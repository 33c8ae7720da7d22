"""fairseq torch checkpoint -> the port's weights tree.

The port's copy of diffnorm_tpu/utils/convert_weights.py for the families
the port runs: HuBERT (the encoder, the CTC fine-tune, HuBERT's and
wav2vec2's pretraining models, and the --w2v-path warm start), the
code-HiFi-GAN, the DiffNorm speech VAE and latent normalizer, the NAR S2UT
conformer, the GAN discriminators and the S2T transformer encoder (a function, no CLI type, as in JAX), with the
key-inventory audit. Each converter returns the flax-path tree JAX's
converter returns (float32 numpy arrays), which `weights.from_jax_variables`
loads, so the port's module paths stay flax paths. Layout rules:
* torch Linear weight [out, in]       -> Dense kernel [in, out]
* torch Conv1d weight [out, in, k]    -> Conv kernel [k, in, out]
* torch grouped Conv1d [out, in/g, k] -> Conv kernel [k, in/g, out]
* torch ConvTranspose1d [in, out, k]  -> ConvTranspose kernel [k, out, in]
  (flax transpose_kernel=True)
* torch Embedding [V, D]              -> Embed embedding [V, D]
* weight norm (weight_g / weight_v) is folded: w = g * v / ||v||, the norm
  over every dim except `dim` (HiFi-GAN uses dim=0, wav2vec2's pos_conv
  dim=2)
* spectral norm (weight_orig / weight_u / weight_v) is folded at eval
  semantics: W / (u^T W v) with the stored vectors, no power iteration
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from diffnorm_tpu_torch.weights import flatten_tree


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


def torch_layer_count(sd: Dict) -> int:
    """The transformer layer count of a HuBERT-layout state dict."""
    n = -1
    for k in sd:
        m = re.search(r"encoder\.layers\.(\d+)\.", k)
        if m:
            n = max(n, int(m.group(1)))
    return n + 1


def convert_hubert_ctc_checkpoint(path: str, layers: int = 12) -> Dict:
    """A fairseq CTC fine-tune checkpoint (hubert_asr.py HubertCtc:
    `w2v_encoder.w2v_model.*` and `w2v_encoder.proj`) -> {"params":
    HubertCTCModule tree} (JAX convert_weights.py:152-171), with
    `mask_emb` where the checkpoint has one."""
    return convert_hubert_ctc_state(load_torch_state(path), layers=layers)


def convert_hubert_ctc_state(sd: Dict, layers: int = 12) -> Dict:
    sd = {k.removeprefix("w2v_encoder."): v for k, v in sd.items()}
    inner = {k.removeprefix("w2v_model."): v for k, v in sd.items()
             if k.startswith("w2v_model.")}
    params = {"w2v_model": convert_hubert_state(inner, layers=layers)["params"],
              "proj": _dense(sd, "proj")}
    if "w2v_model.mask_emb" in sd:
        params["mask_emb"] = _t(sd["w2v_model.mask_emb"])
    return {"params": params}


def convert_hubert_pretrain_state(sd: Dict, layers: int = 12) -> Dict:
    """A fairseq HubertModel pretraining state dict -> {"params":
    HubertPretrainModule tree}: the backbone, mask_emb, final_proj and
    label_embs_concat (JAX :174-189)."""
    backbone = {k: v for k, v in sd.items()
                if k not in ("mask_emb", "label_embs_concat") and not k.startswith("final_proj.")}
    return {"params": {"encoder": convert_hubert_state(backbone, layers=layers)["params"],
                       "mask_emb": _t(sd["mask_emb"]), "final_proj": _dense(sd, "final_proj"),
                       "label_embs_concat": _t(sd["label_embs_concat"])}}


W2V_HEADS = ("mask_emb", "quantizer.vars", "quantizer.weight_proj.weight",
             "quantizer.weight_proj.bias", "project_q.weight", "project_q.bias",
             "final_proj.weight", "final_proj.bias")


def convert_wav2vec2_pretrain_state(sd: Dict, layers: int = 12) -> Dict:
    """A fairseq Wav2Vec2Model pretraining state dict -> {"params":
    Wav2Vec2PretrainModule tree}: the backbone, mask_emb, the quantizer,
    project_q and final_proj (JAX :192-215)."""
    backbone = {k: v for k, v in sd.items() if k not in W2V_HEADS}
    return {"params": {
        "encoder": convert_hubert_state(backbone, layers=layers)["params"],
        "mask_emb": _t(sd["mask_emb"]),
        "quantizer": {"vars": _t(sd["quantizer.vars"]),
                      "weight_proj": _dense(sd, "quantizer.weight_proj")},
        "project_q": _dense(sd, "project_q"), "final_proj": _dense(sd, "final_proj")}}


def load_pretrained_encoder(path: str, layers: int = 12):
    """fairseq --w2v-path (hubert_asr.py:334-368; JAX :240-280): (the
    encoder's params tree, mask_emb or None) of a pretraining checkpoint: a
    fairseq .pt (a Wav2Vec2Model or HubertModel state dict, or a bare
    backbone), or a step directory (or .npz) of the port's
    hubert_pretraining / audio_pretraining runs, which holds the tree under
    "encoder". A .pt of another depth than `layers` raises."""
    import os

    if os.path.isdir(path) or path.endswith(".npz"):
        from diffnorm_tpu_torch.train.checkpoint import load_params

        params = load_params(path)
        if "encoder" not in params:
            raise ValueError(f"no 'encoder' subtree in pretraining checkpoint {path}; "
                             f"top-level keys: {sorted(params)}")
        return params["encoder"], params.get("mask_emb")
    sd = load_torch_state(path)
    ckpt_layers = torch_layer_count(sd)
    if ckpt_layers and ckpt_layers != layers:
        raise ValueError(f"{path} has {ckpt_layers} transformer layers but the fine-tune "
                         f"model is configured with encoder_layers={layers}")
    mask_emb = _t(sd["mask_emb"]) if "mask_emb" in sd else None
    if any(k.startswith("quantizer.") for k in sd):
        enc = convert_wav2vec2_pretrain_state(sd, layers=layers)["params"]["encoder"]
    elif "label_embs_concat" in sd:
        enc = convert_hubert_pretrain_state(sd, layers=layers)["params"]["encoder"]
    else:
        enc = convert_hubert_state(sd, layers=layers)["params"]
    return enc, mask_emb


def _shapes(tree: Mapping) -> Dict:
    return {k: tuple(np.shape(v)) for k, v in flatten_tree(tree).items()}


def graft_encoder_params(variables: Dict, encoder_params: Dict, name: str = "w2v_model",
                         mask_emb=None) -> Dict:
    """`variables` with params[name] replaced by `encoder_params`, whose
    tree and shapes must match (else a ValueError shows both); a model
    `mask_emb` (the fine-tune's time mask) takes the checkpoint's where it
    has one (JAX :283-311)."""
    target = variables["params"].get(name)
    if target is None:
        raise ValueError(f"model has no '{name}' subtree; keys: {sorted(variables['params'])}")
    if _shapes(target) != _shapes(encoder_params):
        raise ValueError("pretrained encoder does not match the fine-tune model (check "
                         "encoder dims/conv spec/layers/--extractor-mode/--conv-bias):\n"
                         f"model:  {_shapes(target)}\nckpt:   {_shapes(encoder_params)}")
    params = dict(variables["params"])
    params[name] = encoder_params
    if mask_emb is not None and "mask_emb" in params:
        if np.shape(params["mask_emb"]) != np.shape(mask_emb):
            raise ValueError(f"mask_emb shape mismatch: model {np.shape(params['mask_emb'])} "
                             f"vs ckpt {np.shape(mask_emb)}")
        params["mask_emb"] = mask_emb
    return {**variables, "params": params}


# ------------------------------------------- DiffNorm VAE / latent normalizer

def _conv_tree(sd: Dict, prefix: str) -> Dict:
    out = {"kernel": conv_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _linear_tree(sd: Dict, prefix: str) -> Dict:
    out = {"kernel": dense_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _wavenet_tree(sd: Dict, prefix: str) -> Dict:
    """A reference Wavenet / WavenetEncoder (latent_module.py:585-617,
    1003-1032) under `prefix` -> the Wavenet tree; stacks and blocks are
    counted by probing keys."""
    tree: Dict = {"init_conv": _conv_tree(sd, f"{prefix}.init_conv"),
                  "final_conv": _conv_tree(sd, f"{prefix}.final_conv")}
    s = 0
    while f"{prefix}.stacks.{s}.blocks.0.conv.weight" in sd:
        blocks: Dict = {}
        j = 0
        while f"{prefix}.stacks.{s}.blocks.{j}.conv.weight" in sd:
            bp = f"{prefix}.stacks.{s}.blocks.{j}"
            block = {"conv": _conv_tree(sd, f"{bp}.conv"),
                     "res_conv": _conv_tree(sd, f"{bp}.res_conv")}
            if f"{bp}.skip_conv.weight" in sd:
                block["skip_conv"] = _conv_tree(sd, f"{bp}.skip_conv")
            if f"{bp}.to_time_cond.weight" in sd:
                block["to_time_cond"] = _linear_tree(sd, f"{bp}.to_time_cond")
            blocks[f"block_{j}"] = block
            j += 1
        tree[f"stack_{s}"] = blocks
        s += 1
    return tree


def _rmsnorm_tree(sd: Dict, prefix: str, cond: bool) -> Dict:
    if cond:
        return {"to_gamma_beta": _linear_tree(sd, f"{prefix}.to_gamma_beta")}
    return {"gamma": _t(sd[f"{prefix}.gamma"])}


def _attention_tree(sd: Dict, prefix: str) -> Dict:
    return {p: _linear_tree(sd, f"{prefix}.{p}") for p in ("to_q", "to_kv", "to_out")}


def _ff_tree(sd: Dict, prefix: str) -> Dict:
    """FeedForward (latent_module.py:887-903), a None-filtered Sequential:
    0 the in-projection, 1 GEGLU; with the causal conv it sits at 2.1
    (inside a Rearrange sandwich) and the out-projection at 3, else the
    out-projection is at 2."""
    tree = {"proj_in": _linear_tree(sd, f"{prefix}.0")}
    if f"{prefix}.2.1.weight" in sd:
        tree["conv"] = _conv_tree(sd, f"{prefix}.2.1")
        tree["proj_out"] = _linear_tree(sd, f"{prefix}.3")
    else:
        tree["proj_out"] = _linear_tree(sd, f"{prefix}.2")
    return tree


def _cond_transformer_tree(sd: Dict, prefix: str, cond: bool) -> Dict:
    """ConditionableTransformer (latent_module.py:642-706): each layer's
    ModuleList holds [attn-norm, attn, cross-norm | None, cross-attn | None,
    ff-norm, ff] at the fixed indices 0-5."""
    tree: Dict = {}
    layer = 0
    while f"{prefix}.layers.{layer}.1.to_q.weight" in sd:
        lp = f"{prefix}.layers.{layer}"
        tree[f"attn_norm_{layer}"] = _rmsnorm_tree(sd, f"{lp}.0", cond)
        tree[f"attn_{layer}"] = _attention_tree(sd, f"{lp}.1")
        if f"{lp}.3.to_q.weight" in sd:
            tree[f"cross_norm_{layer}"] = _rmsnorm_tree(sd, f"{lp}.2", cond)
            tree[f"cross_attn_{layer}"] = _attention_tree(sd, f"{lp}.3")
        tree[f"ff_norm_{layer}"] = _rmsnorm_tree(sd, f"{lp}.4", cond)
        tree[f"ff_{layer}"] = _ff_tree(sd, f"{lp}.5")
        layer += 1
    tree["final_norm"] = {"gamma": _t(sd[f"{prefix}.to_pred.0.gamma"])}
    tree["to_pred"] = {"kernel": dense_w(sd[f"{prefix}.to_pred.1.weight"])}
    return tree


def convert_vae_state(sd: Dict) -> Dict:
    """A fairseq `speech_vae_decoder` state dict (SpeechVAEEncoderDecoder,
    latent_module.py:1035-1142; the model wrapper nests it under
    `encoder.`) -> the SpeechVAEModule params tree."""
    if any(k.startswith("encoder.encoder_wave.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    params: Dict = {}
    for side in ("enc", "dec"):
        b = 0
        while f"{side}oder_wave.{b}.init_conv.weight" in sd:
            params[f"{side}_wave_{b}"] = _wavenet_tree(sd, f"{side}oder_wave.{b}")
            b += 1
    params["decoder_tf"] = _cond_transformer_tree(sd, "decoder_tf", cond=False)
    params["decoder_lm"] = _linear_tree(sd, "decoder_lm")
    return params


def _perceiver_tree(sd: Dict, prefix: str) -> Dict:
    """PerceiverResampler (latent_module.py:416-471): the latents, the
    context projection, per layer [attention, FF], the final RMSNorm."""
    tree: Dict = {"latents": _t(sd[f"{prefix}.latents"]),
                  "proj_context": _linear_tree(sd, f"{prefix}.proj_context"),
                  "norm": {"gamma": _t(sd[f"{prefix}.norm.gamma"])}}
    layer = 0
    while f"{prefix}.layers.{layer}.0.to_q.weight" in sd:
        tree[f"attn_{layer}"] = _attention_tree(sd, f"{prefix}.layers.{layer}.0")
        tree[f"ff_{layer}"] = _ff_tree(sd, f"{prefix}.layers.{layer}.1")
        layer += 1
    return tree


def convert_denoiser_state(sd: Dict, prefix: str = "model") -> Dict:
    """The denoiser `Model` (latent_module.py:709-876) -> the Denoiser params
    tree. `to_time_cond` is a None-filtered Sequential
    (LearnedSinusoidalPosEmb, Linear, SiLU); `init_conv` is a k=1 Conv1d,
    which becomes a Dense. A prompt-conditioned denoiser (`null_prompt_cond`
    present) adds the null embeddings, `to_prompt_cond` (Identity, Linear,
    SiLU), the resampler, and the transformer's cross norms and attentions
    (JAX convert_weights.py:542-549)."""
    params = {
        "time_emb": {"weights": _t(sd[f"{prefix}.to_time_cond.0.weights"])},
        "time_proj": _linear_tree(sd, f"{prefix}.to_time_cond.1"),
        "init_conv": {"kernel": _t(sd[f"{prefix}.init_conv.weight"])[:, :, 0].T,
                      "bias": _t(sd[f"{prefix}.init_conv.bias"])},
        "wavenet": _wavenet_tree(sd, f"{prefix}.wavenet"),
        "transformer": _cond_transformer_tree(sd, f"{prefix}.transformer", cond=True),
        "final_proj": _linear_tree(sd, f"{prefix}.final_proj"),
    }
    if f"{prefix}.null_prompt_cond" in sd:  # condition_on_prompt
        params["null_prompt_cond"] = _t(sd[f"{prefix}.null_prompt_cond"])
        params["null_prompt_tokens"] = _t(sd[f"{prefix}.null_prompt_tokens"])
        params["to_prompt_cond"] = _linear_tree(sd, f"{prefix}.to_prompt_cond.1")
        params["perceiver_resampler"] = _perceiver_tree(sd, f"{prefix}.perceiver_resampler")
    return params


def convert_diffusion_state(sd: Dict) -> Dict:
    """A fairseq `diff_discrete` state dict (LatentDiscreteModel under
    `encoder.`: the frozen VAE at `speech_decoder.`, the denoiser at
    `model.`, diff_discrete.py:71-85) -> the LatentDiffusionModule params
    tree."""
    if any(k.startswith("encoder.model.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    vae_sd = {k[len("speech_decoder."):]: v for k, v in sd.items()
              if k.startswith("speech_decoder.")}
    return {"denoiser": convert_denoiser_state(sd, "model"), "vae": convert_vae_state(vae_sd)}


# ---------------------------------------------------------- NAR S2UT model

def _mha_tree(sd: Dict, prefix: str) -> Dict:
    """fairseq MultiheadAttention (q/k/v/out_proj with biases)."""
    return {p: _linear_tree(sd, f"{prefix}.{p}")
            for p in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _conformer_layer_trees(sd: Dict, prefix: str) -> Tuple[Dict, Dict]:
    """fairseq ConformerEncoderLayer (modules/conformer_layer.py:133-286) ->
    (params, batch_stats) of a ConformerLayer. The conv module's convs have
    no bias; the rel-pos attention adds linear_pos (no bias) and the
    pos_bias_u / pos_bias_v head biases."""
    def ffn(p):
        return {"layer_norm": _ln(sd, f"{p}.layer_norm"), "w_1": _linear_tree(sd, f"{p}.w_1"),
                "w_2": _linear_tree(sd, f"{p}.w_2")}

    a, c = f"{prefix}.self_attn", f"{prefix}.conv_module"
    attn = {p: _linear_tree(sd, f"{a}.{p}")
            for p in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos")}
    attn["pos_bias_u"] = _t(sd[f"{a}.pos_bias_u"])
    attn["pos_bias_v"] = _t(sd[f"{a}.pos_bias_v"])
    conv = {"layer_norm": _ln(sd, f"{c}.layer_norm"),
            "pointwise_conv1": {"kernel": conv_w(sd[f"{c}.pointwise_conv1.weight"])},
            "depthwise_conv": {"kernel": conv_w(sd[f"{c}.depthwise_conv.weight"])},
            "batch_norm": _ln(sd, f"{c}.batch_norm"),
            "pointwise_conv2": {"kernel": conv_w(sd[f"{c}.pointwise_conv2.weight"])}}
    params = {"ffn1": ffn(f"{prefix}.ffn1"),
              "self_attn_layer_norm": _ln(sd, f"{prefix}.self_attn_layer_norm"),
              "self_attn": attn, "conv_module": conv, "ffn2": ffn(f"{prefix}.ffn2"),
              "final_layer_norm": _ln(sd, f"{prefix}.final_layer_norm")}
    stats = {"conv_module": {"batch_norm": {
        "mean": _t(sd[f"{c}.batch_norm.running_mean"]),
        "var": _t(sd[f"{c}.batch_norm.running_var"])}}}
    return params, stats


def convert_nar_state(sd: Dict) -> Dict:
    """A fairseq `nar_s2ut_conformer` state dict (research/TranSpeech
    nar_conformer.py S2SConformerEncoder + nar_transformer.py
    TransformerUnitDecoder) -> the NARS2UTModule variables
    ({"params", "batch_stats"}), as JAX's converter maps it (JAX
    convert_weights.py:640-713). Stacked units (n_frames_per_step > 1): the
    StackedEmbedding's table and `decoder.embed_tokens.project_in_dim`,
    `decoder.out_proj_n_frames`, and `subframe_out` from
    `decoder.output_projection`, which the reference applies per sub-frame.
    Like JAX's, it maps no speaker projection and no aux head: a checkpoint
    holding them fails the key-inventory audit, and so does a stacked one
    whose output projection is its shared embedding table (the audit counts
    that leaf once, the tree holds it twice)."""
    enc: Dict = {"subsample": {}}
    i = 0
    while f"encoder.subsample.conv_layers.{i}.weight" in sd:
        enc["subsample"][f"conv_{i}"] = _conv_tree(sd, f"encoder.subsample.conv_layers.{i}")
        i += 1
    enc["linear"] = _linear_tree(sd, "encoder.linear")
    stats: Dict = {}
    i = 0
    while f"encoder.conformer_layers.{i}.ffn1.w_1.weight" in sd:
        enc[f"layer_{i}"], stats[f"layer_{i}"] = _conformer_layer_trees(
            sd, f"encoder.conformer_layers.{i}")
        i += 1

    table = {"embedding": _t(sd["decoder.embed_tokens.weight"])}
    if "decoder.embed_tokens.project_in_dim.weight" in sd:  # stacked units
        table = {"embed": table,
                 "project_in_dim": _linear_tree(sd, "decoder.embed_tokens.project_in_dim")}
    dec: Dict = {"embed_tokens": table,
                 "embed_length": {"embedding": _t(sd["decoder.embed_length.weight"])}}
    i = 0
    while f"decoder.layers.{i}.self_attn.q_proj.weight" in sd:
        p = f"decoder.layers.{i}"
        dec[f"layer_{i}"] = {
            "self_attn": _mha_tree(sd, f"{p}.self_attn"),
            "self_attn_layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
            "encoder_attn": _mha_tree(sd, f"{p}.encoder_attn"),
            "encoder_attn_layer_norm": _ln(sd, f"{p}.encoder_attn_layer_norm"),
            "fc1": _linear_tree(sd, f"{p}.fc1"),
            "fc2": _linear_tree(sd, f"{p}.fc2"),
            "final_layer_norm": _ln(sd, f"{p}.final_layer_norm"),
        }
        i += 1
    if "decoder.layer_norm.weight" in sd:
        dec["layer_norm"] = _ln(sd, "decoder.layer_norm")
    # --share-decoder-input-output-embed (the released recipe): the output
    # projection is the embedding table, and the decoder reuses the table;
    # an untied one becomes output_proj, which the port's decoder lacks
    out_w = _t(sd["decoder.output_projection.weight"])
    if not np.array_equal(out_w, _t(sd["decoder.embed_tokens.weight"])):
        dec["output_proj"] = {"kernel": out_w.T}
    if "decoder.out_proj_n_frames.weight" in sd:
        dec["out_proj_n_frames"] = {"kernel": dense_w(sd["decoder.out_proj_n_frames.weight"])}
        dec["subframe_out"] = {"kernel": dense_w(sd["decoder.output_projection.weight"])}
    return {"params": {"encoder": enc, "decoder": dec}, "batch_stats": {"encoder": stats}}


# -------------------------------------------- GAN discriminators (MPD / MSD)

def convert_s2t_encoder_state(sd: Dict, layers: int) -> Dict:
    """fairseq S2TTransformerEncoder state dict (s2t_transformer.py:295-376,
    keys under `encoder.` or bare) -> the `S2TTransformerEncoder` tree
    {"params": ...} (JAX convert_weights.py:797-836): the subsampler's
    convs, `layers` pre-LN layers and the final LayerNorm."""
    if any(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    params: Dict = {"subsample": {}}
    i = 0
    while f"subsample.conv_layers.{i}.weight" in sd:
        params["subsample"][f"conv_{i}"] = {
            "kernel": conv_w(sd[f"subsample.conv_layers.{i}.weight"]),
            "bias": _t(sd[f"subsample.conv_layers.{i}.bias"])}
        i += 1
    for n in range(layers):
        p = f"transformer_layers.{n}"
        params[f"layer_{n}"] = {
            "self_attn": {proj: _linear_tree(sd, f"{p}.self_attn.{proj}")
                          for proj in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": _ln(sd, f"{p}.self_attn_layer_norm"),
            "fc1": _linear_tree(sd, f"{p}.fc1"),
            "fc2": _linear_tree(sd, f"{p}.fc2"),
            "final_layer_norm": _ln(sd, f"{p}.final_layer_norm")}
    params["layer_norm"] = _ln(sd, "layer_norm")
    return {"params": params}


def _fold_spectral_norm(orig, u, v) -> np.ndarray:
    """The eval-mode weight of torch's spectral_norm: W / sigma with sigma =
    u^T W_mat v from the stored power-iteration vectors
    (SpectralNorm.compute_weight with do_power_iteration=False)."""
    orig, u, v = _t(orig), _t(u), _t(v)
    w_mat = orig.reshape(orig.shape[0], -1)
    sigma = float(u @ (w_mat @ v))
    return orig / sigma


def _disc_conv(sd: Dict, prefix: str) -> np.ndarray:
    if f"{prefix}.weight_g" in sd:
        return fold_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])
    if f"{prefix}.weight_orig" in sd:
        return _fold_spectral_norm(sd[f"{prefix}.weight_orig"], sd[f"{prefix}.weight_u"],
                                   sd[f"{prefix}.weight_v"])
    return _t(sd[f"{prefix}.weight"])


def convert_gan_discriminators(mpd_sd: Dict, msd_sd: Dict,
                               periods: Sequence[int] = (2, 3, 5, 7, 11),
                               scales: int = 3) -> Dict:
    """TranSpeech hifigan MultiPeriod / MultiScale discriminator state dicts
    (research/TranSpeech/hifigan/models.py:128-249; weight norm folded, the
    spectral norm of the first MSD scale folded at eval semantics) ->
    {"mpd": {"params"}, "msd": {"params"}} of models/hifigan_disc.py."""
    def disc(sd, pre, n, perm):
        d = {f"conv_{j}": {"kernel": _disc_conv(sd, f"{pre}.convs.{j}").transpose(perm),
                           "bias": _t(sd[f"{pre}.convs.{j}.bias"])} for j in range(n)}
        d["conv_post"] = {"kernel": _disc_conv(sd, f"{pre}.conv_post").transpose(perm),
                          "bias": _t(sd[f"{pre}.conv_post.bias"])}
        return d

    # Conv2d [out, in, kh, kw] -> [kh, kw, in, out]; Conv1d [out, in, k] -> [k, in, out]
    mpd = {f"period_{p}": disc(mpd_sd, f"discriminators.{i}", 5, (2, 3, 1, 0))
           for i, p in enumerate(periods)}
    msd = {f"scale_{s}": disc(msd_sd, f"discriminators.{s}", 7, (2, 1, 0))
           for s in range(scales)}
    return {"mpd": {"params": mpd}, "msd": {"params": msd}}


# ------------------------------------------------------------ key inventory

# torch buffers that carry no learned weights (fairseq's save paths emit them)
_BUFFER_SUFFIXES = (".version", "._float_tensor", ".num_batches_tracked")


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape)))


def conversion_inventory(sd: Dict, converted: Mapping,
                         expected_unconsumed: Sequence[str] = ()) -> Tuple[int, int]:
    """Audit a conversion against the source state dict's key inventory:
    every learned element of `sd` must land in the converted tree.

      * buffers (`.version`, the sinusoidal `._float_tensor`, BatchNorm's
        `num_batches_tracked`) carry no weights: ignored
      * a weight-norm pair folds `weight_g` into the kernel: `weight_g` is
        auxiliary, `weight_v` counts as the kernel
      * a spectral-norm triplet (`weight_orig` / `weight_u` / `weight_v`)
        folds to one kernel: `_u` and `_v` are auxiliary
      * a `*.output_projection.weight` equal to an embedding table is the
        shared in/out embedding: one tree leaf covers both keys
      * `expected_unconsumed`: the family's pretraining-only heads (key
        names or prefixes)

    Raises ValueError naming the likely unaccounted keys when the element
    counts differ. Returns (consumed elements, tree elements)."""
    embed_tables = [_t(v) for k, v in sd.items() if k.endswith("embed_tokens.weight")]
    consumed, counted = 0, []
    for k, v in sd.items():
        if k.endswith(_BUFFER_SUFFIXES):
            continue
        if any(k == e or k.startswith(e) for e in expected_unconsumed):
            continue
        base = k.rsplit(".", 1)[0]
        if k.endswith(".weight_g") and f"{base}.weight_v" in sd:
            continue  # weight-norm magnitude, folded
        if k.endswith((".weight_u", ".weight_v")) and f"{base}.weight_orig" in sd:
            continue  # spectral-norm power-iteration vectors, folded
        if k.endswith("output_projection.weight") and any(
                tuple(v.shape) == t.shape and np.array_equal(_t(v), t) for t in embed_tables):
            continue
        consumed += _numel(v)
        counted.append(k)
    tree_elems = sum(_numel(np.asarray(leaf)) for leaf in flatten_tree(converted).values())
    if consumed != tree_elems:
        diff = consumed - tree_elems
        sizes = [(k, _numel(sd[k])) for k in counted]
        exact = [f"{k} ({n})" for k, n in sizes if n == abs(diff)]
        close = [f"{k} ({n})" for k, n in sorted(sizes, key=lambda kv: -kv[1]) if n < abs(diff)]
        suspects = (exact + close)[:20]
        raise ValueError(
            f"conversion inventory mismatch: source carries {consumed} learned elements but "
            f"the converted tree has {tree_elems} (difference {diff}). Unaccounted checkpoint "
            f"keys are likely among: {suspects or '(none <= diff: shape mismatch?)'}; either "
            "the converter must consume them or they belong in expected_unconsumed with a "
            "documented reason.")
    return consumed, tree_elems


# per family, the pretraining-only heads the inference converters leave behind
EXPECTED_UNCONSUMED = {
    # the inference encoder drops the masked-prediction head and target embeddings
    "hubert": ("label_embs_concat", "final_proj.", "mask_emb"),
    # the CTC fine-tune keeps the backbone (and a mask_emb); its pretraining
    # heads stay behind
    "hubert_ctc": ("w2v_encoder.w2v_model.label_embs_concat",
                   "w2v_encoder.w2v_model.final_proj."),
    "vae": (),
    "diffusion": (),
    "nar": (),
    "hifigan": (),
    "gan_discriminators": (),
}
