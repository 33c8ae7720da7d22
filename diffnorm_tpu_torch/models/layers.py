"""Shared building blocks of the DDIM path (PyTorch, batch-first [B, T, C]).

Counterpart of diffnorm_tpu/models/layers.py (reference latent_module.py).
Submodule and parameter names follow the flax tree (`attn_norm_3`,
`to_gamma_beta`, ...), with flax `kernel` as torch `weight`, so weights carry
over by a mechanical path map (`diffnorm_tpu_torch/weights.py`). Every layer
computes in the dtype of its weights, as the flax modules compute in `dtype`;
initialisers follow flax's (lecun-normal kernels, zero biases).

`quant=True` (`quant_int8` on the transformer) is JAX's int8 W8A8 inference
path (ops/quant.py): int8 weight codes and float32 scales are packed from the
float32 parameters into `Int8Pack`s, which `.to(dtype)` moves but never
casts, so they are built before the model is cast to bf16 and survive it.
`knobs` (an `ops.quant.Int8Knobs`) carries JAX's int8 environment switches;
each int8 `Dense`, `CausalConv1d` and self-attention is one activation site
(`ops.quant.QuantSite`) that can hold a calibrated static scale.

Int8 training (`cli.train --quant-int8`) takes the int8 module path with the
gradient JAX's `jax.grad` gives it: the int8 codes, `round` and the integer
products carry none, so the gradient reaches x and w only through their
scales, ax = amax|x| / 127 and ws = amax|w| / 127, in the dequant acc * ax *
ws (no straight-through estimator). A trainer sets `live_int8` on the int8
`Dense` sites of the model it trains: they then quantize their weight as it
is at each call (their float32 master's values, `int8_master`, under a bf16
working copy), not the pack.

Float packs (`FeedForward`'s padded copies, the WaveNet chains) are cached
buffers for inference, rebuilt when a parameter they copy has changed in
place (`param_versions`). A forward that trains (grad mode on, a packed
parameter requiring grad) builds them from the parameters as it runs, so
gradients reach the parameters (`packs_from_params`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.ops import attention as attention_ops
from diffnorm_tpu_torch.ops import ffpipe as ffpipe_ops
from diffnorm_tpu_torch.ops import fused_layer as fused_ops
from diffnorm_tpu_torch.ops import norm as norm_ops
from diffnorm_tpu_torch.ops import quant as quant_ops
from diffnorm_tpu_torch.ops.quant import Int8Knobs, QuantSite
from diffnorm_tpu_torch.parallel.mesh import copy_in, gather_out, reduce_out, split_in

# ConditionableTransformer's int8 routes: JAX's DIFFNORM_FUSED_BLOCK=1,
# DIFFNORM_FFPIPE=1, DIFFNORM_FFPIPE=1 with DIFFNORM_FFPIPE_ROWS=2, and
# neither (the int8 module path)
INT8_ROUTES = ("fused_layer", "ffpipe", "ffpipe2", "module")


def _lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    # flax lecun_normal: truncated normal at +-2 std, variance 1 / fan_in
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def packs_from_params(params: Sequence[torch.Tensor]) -> bool:
    """Whether a forward builds its packed weights from `params` as it runs
    (differentiably): grad mode is on and one of them requires grad.
    Otherwise it reads its cached packs."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in params)


def param_versions(params: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    """The parameters' in-place version counters (an optimizer step or
    `load_state_dict` moves them): a pack built at these versions is current
    while the counters still read so."""
    return tuple(p._version for p in params)


def repack_after_load(module: nn.Module, incompatible_keys=None) -> None:
    """A `load_state_dict` post-hook: a load may replace the parameter
    objects (assign=True), which the version check cannot see, so the float
    packs are rebuilt from the loaded parameters. (Int8 packs are built from
    float32 masters and are left to `weights.pack_all`.)"""
    if not getattr(module, "quant", False):
        module.pack_weights()


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps) along the last axis; the square-sum in f32."""
    sq = x.square().sum(-1, keepdim=True, dtype=torch.float32)
    inv = 1.0 / torch.clamp(sq.sqrt(), min=eps)
    return x * inv.to(x.dtype)


def _master(weight: torch.Tensor) -> torch.Tensor:
    """The float32 parameter an int8 pack is built from (JAX quantizes its
    float32 masters; codes from bf16-rounded weights differ)."""
    if weight.dtype != torch.float32:
        raise TypeError(f"int8 packs are built from the float32 parameters: load "
                        f"the weights before casting the model (got {weight.dtype})")
    return weight.detach()


class Int8Pack(nn.Module):
    """Packed copies of a module's weights (int8 codes, float32 scales and
    biases, bf16 copies) as non-persistent buffers that `.to()` moves to a
    device but never casts: a float32 scale cast to bf16 would change the
    dequantization."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, tensor in tensors.items():
            self.register_buffer(name, tensor.detach().contiguous(), persistent=False)

    def _apply(self, fn, recurse=True):
        for name, buf in self._buffers.items():
            if buf is not None:
                moved = fn(buf)
                self._buffers[name] = moved if moved.dtype == buf.dtype else buf.to(moved.device)
        return self

    def tensors(self) -> Dict[str, torch.Tensor]:
        return dict(self._buffers)


class Dense(QuantSite, nn.Linear):
    """flax nn.Dense, or QDense with `quant=True`: the input is cast to the
    weight's dtype. `weight` is [out, in], the transpose of the flax kernel.

    With `quant` the product is int8 W8A8 (diffnorm_tpu/models/layers.py
    QDense): int8 codes packed from the float32 weight per channel (per
    tensor with `knobs.wscalar`) by `pack_weights`, the input quantized at
    this site (or `pre_quant`, shared between products of one input, which
    bypasses the site as in JAX), exact int32 sums and JAX's dequant
    epilogue; the bias is added in the output dtype."""

    # set by a trainer: quantize the weight at each call, not the pack
    live_int8 = False
    # (the float32 master,) of a bf16 working copy's weight, as JAX
    # quantizes its float32 masters
    int8_master: Tuple[torch.Tensor, ...] = ()
    # tensor parallelism (parallel.sharding_rules.shard_model): the model
    # axis, and "column" (the output split), "gather" (a column product
    # whose output replicated code reads) or "row" (the input split)
    tp_axis = None
    tp_kind: Optional[str] = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 quant: bool = False, knobs: Int8Knobs = Int8Knobs()):
        self.quant, self.knobs = quant, knobs
        super().__init__(in_features, out_features, bias)
        self._init_site()
        self.pack_weights()

    def reset_parameters(self) -> None:
        _lecun_normal_(self.weight, self.in_features)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @torch.no_grad()
    def pack_weights(self) -> None:
        if self.quant:
            wq, ws = quant_ops.quantize_weight(_master(self.weight), self.knobs.granularity)
            self.int8 = Int8Pack({"wq": wq, "ws": ws})

    def forward(self, x: torch.Tensor, pre_quant=None) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.tp_axis is not None:
            return tp_linear(x, self.weight, self.bias, self.tp_axis, self.tp_kind,
                             self.out_features)
        if not self.quant:
            return F.linear(x, self.weight, self.bias)
        if pre_quant is None:
            pre_quant = self.quantize_input(x)
        wq, ws = self.int8.wq, self.int8.ws
        if self.live_int8:
            w = self.weight.float()
            if self.int8_master:
                # the master's float32 values, the gradient to this weight
                # (exact: w is the master rounded to bf16)
                w = w + (self.int8_master[0] - w).detach()
            wq, ws = quant_ops.quantize_weight(w, self.knobs.granularity)
        y = quant_ops.int8_matmul(x, wq, ws, pre_quant=pre_quant,
                                  bf16_epilogue=self.knobs.deq_bf16)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def tp_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], axis,
              kind: str, out_features: int) -> torch.Tensor:
    """A Megatron product over the model axis: a column product takes the
    replicated input (its gradient summed over the ranks) to this rank's
    output slice, gathered whole (`out_features`) for "gather"; a row
    product sums the ranks' partial products of their input slices, then
    adds the bias once."""
    if kind == "row":
        y = reduce_out(F.linear(x, weight), axis)
        return y if bias is None else y + bias
    y = F.linear(copy_in(x, axis), weight, bias)
    return gather_out(y, axis, n=out_features) if kind == "gather" else y


def causal_taps(x: torch.Tensor, taps: torch.Tensor, dilation: int) -> torch.Tensor:
    """The bias-free causal conv of x [B, T, in] with one contiguous [out, in]
    matrix per tap (taps [k, out, in]): tap i reads x[t - (k-1-i) * dilation].
    Each tap is one matmul in x.dtype and the taps sum in that dtype, as the
    JAX module does. Contiguous taps matter: a strided weight[:, :, i] sends
    cuBLAS to an unaligned kernel several times slower."""
    k, t_len = taps.shape[0], x.shape[1]
    out = None
    for i in range(k):
        shift = (k - 1 - i) * dilation
        if shift >= t_len and shift > 0:
            continue  # the whole tap falls before the sequence
        xi = x if shift == 0 else F.pad(x[:, :-shift], (0, 0, shift, 0))
        term = F.linear(xi, taps[i])
        out = term if out is None else out + term
    return out


def _shifted(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x[:, t - shift] with zeros before t = 0 ([B, T, C]; shift < T)."""
    return x if shift == 0 else F.pad(x[:, :-shift], (0, 0, shift, 0))


class CausalConv1d(QuantSite, nn.Module):
    """Left-padded dilated conv over [B, T, C] (pad = dilation * (k - 1)).

    `weight` is torch's conv layout [out, in, k]: weight[:, :, i] is the flax
    kernel[i] transposed, with no flip (see `causal_taps`).

    With `quant` the taps are int8 W8A8 as in the JAX module
    (diffnorm_tpu/models/layers.py:160-248): the input is quantized once at
    this site and the shifted taps reuse its codes; one weight scale per
    output channel over [k, in] (per tensor with `knobs.wscalar`) is shared
    by the taps. With a per-token activation scale each tap's int32 sum is
    scaled by its shifted token scale and the taps sum in the compute dtype
    (a per-tensor weight scale folds into the token scale first); with one
    per-tensor activation scale (`knobs.ascalar` or a static scale) the taps
    sum in int32 and dequantize once, and `knobs.convcat` makes the k taps
    one K = k * in product. Unlike QDense, JAX quantizes the kernel after
    casting it to the compute dtype, so this one quantizes its weight as it
    is at each call."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 dilation: int = 1, quant: bool = False,
                 knobs: Int8Knobs = Int8Knobs()):
        super().__init__()
        self.dilation, self.quant, self.knobs = dilation, quant, knobs
        self.weight = nn.Parameter(_lecun_normal_(
            torch.empty(out_dim, in_dim, kernel_size), in_dim * kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self._init_site()

    def _forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        knobs, dtype = self.knobs, x.dtype
        xq, ax = self.quantize_input(x)
        w = self.weight  # one scale per output channel over [in, k]
        wq, ws = quant_ops.quantize_weight(w.reshape(w.shape[0], -1), knobs.granularity)
        wq, ws = wq.reshape(w.shape).permute(2, 0, 1).contiguous(), ws.reshape(1, -1)
        if ws.numel() == 1 and ax.numel() > 1:
            ax, ws = ax.float() * ws.reshape(()), None  # folds into the token scale
        k, (b, t_len, _) = wq.shape[0], x.shape
        shifts = [(k - 1 - i) * self.dilation for i in range(k)]
        if ax.numel() == 1 and knobs.convcat and k > 1:
            taps = [torch.zeros_like(xq) if s >= t_len else _shifted(xq, s) for s in shifts]
            w_cat = wq.permute(1, 0, 2).reshape(wq.shape[1], -1)  # [out, k * in]
            acc = quant_ops.int_mm(torch.cat(taps, dim=-1).reshape(b * t_len, -1), w_cat)
            return quant_ops.dequant(acc.reshape(b, t_len, -1), ax, ws, dtype, knobs.deq_bf16)
        out = None
        for i, shift in enumerate(shifts):
            if shift >= t_len and shift > 0:
                continue  # the whole tap falls before the sequence
            acc = quant_ops.int_mm(_shifted(xq, shift).reshape(b * t_len, -1),
                                   wq[i]).reshape(b, t_len, -1)
            term = acc if ax.numel() == 1 else acc.to(dtype) * _shifted(ax, shift).to(dtype)
            out = term if out is None else out + term
        if ax.numel() == 1:
            return quant_ops.dequant(out, ax, ws, dtype, knobs.deq_bf16)
        return out if ws is None else out * ws.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.quant:
            return self._forward_int8(x) + self.bias
        taps = self.weight.permute(2, 0, 1).contiguous()
        return causal_taps(x, taps, self.dilation) + self.bias


class RMSNorm(nn.Module):
    """l2norm * sqrt(dim) * gamma, or FiLM-conditioned (no gamma; (gamma,
    beta) from `to_gamma_beta(cond)`, or precomputed as `film`).

    A FiLM norm of a 3-D CUDA tensor runs the fused kernel (ops/norm.py),
    with `film` given or projected here from `cond` (a training forward);
    everything else is the plain module math."""

    def __init__(self, dim: int, scale: bool = True,
                 cond_dim: Optional[int] = None):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim)) if scale else None
        self.to_gamma_beta = (Dense(cond_dim, 2 * dim)
                              if cond_dim is not None else None)

    def film(self, cond: torch.Tensor) -> torch.Tensor:
        """The conditioning projection [..., 2 * dim] (precomputable)."""
        return self.to_gamma_beta(cond)

    def forward(self, x, cond=None, film=None):
        if (self.to_gamma_beta is not None and self.gamma is None
                and x.dim() == 3 and x.is_cuda):
            return norm_ops.rms_norm_film(x, film if film is not None else self.film(cond))
        out = l2norm(x) * math.sqrt(self.dim)
        if self.gamma is not None:
            out = out * self.gamma.to(x.dtype)
        if self.to_gamma_beta is None:
            return out
        gb = film if film is not None else self.to_gamma_beta(cond)
        gamma, beta = gb.chunk(2, dim=-1)
        return out * gamma[:, None, :] + beta[:, None, :]


def geglu(h: torch.Tensor) -> torch.Tensor:
    """x, gate = split(h); gelu(gate) * x. jax.nn.gelu defaults to the tanh
    approximation (diffnorm_tpu/models/layers.py:289), so this one does too."""
    x, gate = h.chunk(2, dim=-1)
    return F.gelu(gate, approximate="tanh") * x


class FeedForward(nn.Module):
    """GEGLU FF with an optional k=3 causal conv at dim_inner =
    int(dim * mult * 2/3).

    It runs on copies of its weights with the inner width zero-padded to a
    multiple of 8 (`pack_weights`, at init and after every weight load): at
    the released width 512 the inner width is 1365, and an odd leading
    dimension sends every cuBLAS product that touches it to an unaligned
    kernel several times slower. The padded channels stay exact zeros
    through GEGLU (gelu(0) * 0) and the conv (zero weights and bias). A
    training forward pads the parameters as it runs, and the cached copies
    are rebuilt when a parameter changed in place (module docstring).

    With `quant` it is JAX's int8 module path instead (QDense proj_in, GEGLU,
    int8 conv, QDense proj_out, unpadded, under `knobs`), and `pack_weights`
    also packs the int8 weights of the fused kernels
    (`ops.ffpipe.pack_ff_weights`, inner width padded to a multiple of 128)
    into `self.int8`.

    Under tensor parallelism (`tp_axis`) proj_in holds this rank's slice of
    the GEGLU's x and of its gate, proj_out the matching input rows: the
    inner width is split, unpadded. The causal conv is replicated and reads
    the whole inner width, so its input is gathered and its output cut to
    this rank's slice again."""

    tp_ready = True
    tp_axis = None

    def __init__(self, dim: int, mult: int = 4, causal_conv: bool = False,
                 quant: bool = False, knobs: Int8Knobs = Int8Knobs()):
        super().__init__()
        self.inner = int(dim * mult * 2 / 3)
        self.quant, self.knobs = quant, knobs
        self.proj_in = Dense(dim, self.inner * 2, quant=quant, knobs=knobs)
        self.conv = (CausalConv1d(self.inner, self.inner, 3, quant=quant, knobs=knobs)
                     if causal_conv else None)
        self.proj_out = Dense(self.inner, dim, quant=quant, knobs=knobs)
        self.pack_weights()
        self.register_load_state_dict_post_hook(repack_after_load)

    def _pack_sources(self) -> list:
        return [p for m in (self.proj_in, self.conv, self.proj_out) if m is not None
                for p in m.parameters()]

    def _float_packs(self) -> Dict[str, torch.Tensor]:
        """The float weights with the inner width padded to a multiple of 8,
        built from the parameters by differentiable ops."""
        pad = (-self.inner) % 8
        halves = [F.pad(w, (0, 0, 0, pad)) for w in self.proj_in.weight.chunk(2)]
        packed = {
            "w_in": torch.cat(halves),
            "b_in": torch.cat([F.pad(b, (0, pad)) for b in self.proj_in.bias.chunk(2)]),
            "w_out": F.pad(self.proj_out.weight, (0, pad)),
        }
        if self.conv is not None:
            packed["w_conv"] = F.pad(self.conv.weight.permute(2, 0, 1), (0, pad, 0, pad))
            packed["b_conv"] = F.pad(self.conv.bias, (0, pad))
        return {name: tensor.contiguous() for name, tensor in packed.items()}

    @torch.no_grad()
    def pack_weights(self) -> None:
        """Rebuild the packed copies from the parameters (buffers: `.to()`
        moves and casts the float copies; not saved)."""
        if self.quant:
            if self.conv is not None:
                self.int8 = Int8Pack(ffpipe_ops.pack_ff_weights(
                    _master(self.proj_in.weight), self.proj_in.bias,
                    _master(self.conv.weight), self.conv.bias,
                    _master(self.proj_out.weight), self.proj_out.bias,
                    self.knobs.granularity))
            return
        for name, tensor in self._float_packs().items():
            self.register_buffer(name, tensor, persistent=False)
        self._pack_params = tuple(self._pack_sources())
        self._packed_versions = param_versions(self._pack_params)

    def _packs(self) -> Dict[str, torch.Tensor]:
        if packs_from_params(self._pack_params):
            return self._float_packs()
        if param_versions(self._pack_params) != self._packed_versions:
            self.pack_weights()
        names = ("w_in", "b_in", "w_out") + (("w_conv", "b_conv") if self.conv is not None else ())
        return {name: getattr(self, name) for name in names}

    def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.tp_axis
        x = copy_in(x.to(self.proj_in.weight.dtype), axis)
        h = geglu(F.linear(x, self.proj_in.weight, self.proj_in.bias))
        if self.conv is not None:
            h = gather_out(h, axis, n=self.inner)
            h = causal_taps(h, self.conv.weight.permute(2, 0, 1), 1) + self.conv.bias
            h = split_in(h, axis)
        return reduce_out(F.linear(h, self.proj_out.weight), axis) + self.proj_out.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_axis is not None:
            return self._tp_forward(x)
        if self.quant:
            h = geglu(self.proj_in(x))
            if self.conv is not None:
                h = self.conv(h)
            return self.proj_out(h)
        w = self._packs()
        h = geglu(F.linear(x.to(w["w_in"].dtype), w["w_in"], w["b_in"]))
        if self.conv is not None:
            h = causal_taps(h, w["w_conv"], 1) + w["b_conv"]
        return F.linear(h, w["w_out"], self.proj_out.bias)


def set_live_int8(model: nn.Module, masters: Optional[nn.Module] = None) -> None:
    """Int8 training: every int8 `Dense` of `model` quantizes its weight at
    each call; with `masters` (the float32 model a bf16 `model` was cast
    from) by the master weight's values."""
    for name, m in model.named_modules():
        if isinstance(m, Dense) and m.quant:
            m.live_int8 = True
            if masters is not None and masters is not model:
                m.int8_master = (masters.get_submodule(name).weight,)


def local_heads(heads: int, n: int) -> int:
    """A rank's heads of `heads` over a model axis of n ranks."""
    if heads % n:
        raise ValueError(f"{heads} heads do not split over --model-parallel {n}")
    return heads // n


class DropoutSite:
    """A module whose training forward drops from `self.generator`, which
    `set_dropout_generator` sets (the trainer's dropout stream)."""

    generator: Optional[torch.Generator] = None


class Attention(QuantSite, DropoutSite, nn.Module):
    """Multi-head attention with a key-padding mask [B, Tk] (True = valid);
    unbiased q / kv / out projections, scale dim_head ** -0.5. Self-attention
    by default; with `context` [B, Tk, dim] cross-attention, q from x and
    k / v from the context (JAX layers.py:316-362).

    With `quant` the projections are int8 QDense, and in self-attention q
    and kv share one quantization of their common input at this module's
    site, as in JAX (diffnorm_tpu/models/layers.py:337-348; with a context
    each projection quantizes its own input); `pack_weights` also keeps the
    bf16 [Wq; Wkv] and Wo of the fused layer kernel in `self.fused`.

    `dropout` drops attention probabilities in training mode (JAX's
    `deterministic=False`), drawn from `self.generator`, which the trainer
    sets (`set_dropout_generator`).

    Under tensor parallelism each rank runs heads / model of the heads
    (`shard_heads`): its slices of to_q and of to_kv's k and v, and of
    to_out's input rows."""

    tp_ready = True
    tp_axis = None

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 quant: bool = False, knobs: Int8Knobs = Int8Knobs(),
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head, self.quant, self.knobs = heads, dim_head, quant, knobs
        self.dropout = dropout
        inner = heads * dim_head
        self.to_q = Dense(dim, inner, bias=False, quant=quant, knobs=knobs)
        self.to_kv = Dense(dim, 2 * inner, bias=False, quant=quant, knobs=knobs)
        self.to_out = Dense(inner, dim, bias=False, quant=quant, knobs=knobs)
        self._init_site()
        self.pack_weights()

    def shard_heads(self, n: int) -> None:
        self.heads = local_heads(self.heads, n)

    @torch.no_grad()
    def pack_weights(self) -> None:
        if self.quant:
            self.fused = Int8Pack(fused_ops.pack_layer_weights(
                _master(self.to_q.weight), _master(self.to_kv.weight),
                _master(self.to_out.weight), {}))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        pq = (self.quantize_input(x.to(self.to_q.weight.dtype))
              if self.quant and context is None else None)
        q = self.to_q(x, pre_quant=pq)
        k, v = self.to_kv(x if context is None else context, pre_quant=pq).chunk(2, dim=-1)
        q, k, v = (t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)
                   for t in (q, k, v))
        drop = self.dropout if self.training else 0.0
        out = attention_ops.masked_attention(q, k, v, mask=mask, dropout=drop,
                                             generator=self.generator, heads_axis=self.tp_axis)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class LearnedSinusoidalPosEmb(nn.Module):
    """Learned-frequency Fourier time embedding: [B] -> [B, dim + 1], raw t
    first, then sin and cos (computed in f32)."""

    def __init__(self, dim: int):
        super().__init__()
        assert dim % 2 == 0
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()[:, None]
        freqs = t * self.weights[None, :] * 2 * math.pi
        return torch.cat([t, freqs.sin(), freqs.cos()], dim=-1)


def sinusoidal_positions(mask: torch.Tensor, dim: int,
                         padding_idx: int = 0) -> torch.Tensor:
    """fairseq SinusoidalPositionalEmbedding: positions padding_idx +
    cumsum(mask) on valid steps, padding_idx elsewhere; the row at
    padding_idx is zeros. mask [B, T] bool -> [B, T, dim] float32."""
    positions = torch.where(mask, mask.int().cumsum(dim=1) + padding_idx,
                            padding_idx)
    half = dim // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=mask.device)
                    * -(math.log(10000.0) / (half - 1)))
    args = positions.float()[..., None] * inv
    emb = torch.cat([args.sin(), args.cos()], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return torch.where((positions == padding_idx)[..., None], 0.0, emb)


def arch_default(cfg: dict, key: str, value) -> None:
    """An architecture's default: cfg[key] = value where the flag was left
    unset (None), as JAX's cfg.setdefault on an absent key."""
    if cfg.get(key) is None:
        cfg[key] = value

class ConditionableTransformer(nn.Module):
    """Pre-norm transformer: per layer RMSNorm -> masked MHA -> residual ->
    RMSNorm -> GEGLU FF -> residual; then RMSNorm and an unbiased `to_pred`.
    With `cond_dim` every per-layer norm is FiLM-conditioned.

    `quant_int8` makes the attention projections and the FF int8 W8A8, and
    `int8_route` picks how a layer runs, as JAX's environment switches do
    (diffnorm_tpu/models/layers.py:480-563):
      "fused_layer"  every layer is one `ops.fused_layer` kernel call
                     (DIFFNORM_FUSED_BLOCK=1);
      "ffpipe"       int8 module attention, then the FF sublayer as one
                     `ops.ffpipe_layer` kernel call (DIFFNORM_FFPIPE=1);
      "ffpipe2"      the same with rows=2 (DIFFNORM_FFPIPE_ROWS=2);
      "module"       the int8 module path throughout.
    A kernel route is taken only where JAX takes it: bf16 weights, `film`
    precomputed, a causal-conv FF, and heads * dim_head == dim for
    "fused_layer"; any other call takes the module path. `int8_knobs` are
    JAX's int8 switches for the module path (the kernel packs take their
    weight granularity). `dropout` is the attention dropout of a training
    forward (JAX's ConditionableTransformer.dropout).

    `cross_attn` adds per layer, between the attention and the FF, an
    adaptive `cross_norm_i` and a float `cross_attn_i` over a `context`
    with no key mask (JAX layers.py:444-453,528-540, the prompt-conditioned
    denoiser); such a transformer takes no kernel route (`:485`)."""

    def __init__(self, dim: int, depth: int, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4, ff_causal_conv: bool = False,
                 cond_dim: Optional[int] = None, quant_int8: bool = False,
                 int8_route: str = "fused_layer", int8_knobs: Int8Knobs = Int8Knobs(),
                 dropout: float = 0.0, cross_attn: bool = False):
        super().__init__()
        if int8_route not in INT8_ROUTES:
            raise ValueError(f"int8_route must be one of {INT8_ROUTES}, got {int8_route!r}")
        self.dim, self.depth, self.dim_head, self.heads = dim, depth, dim_head, heads
        self.ff_causal_conv, self.quant_int8 = ff_causal_conv, quant_int8
        self.int8_route, self.cross_attn = int8_route, cross_attn
        has_cond = cond_dim is not None
        for i in range(depth):
            self.add_module(f"attn_norm_{i}",
                            RMSNorm(dim, scale=not has_cond, cond_dim=cond_dim))
            self.add_module(f"attn_{i}", Attention(dim, dim_head, heads, quant=quant_int8,
                                                   knobs=int8_knobs, dropout=dropout))
            if cross_attn:
                self.add_module(f"cross_norm_{i}",
                                RMSNorm(dim, scale=not has_cond, cond_dim=cond_dim))
                self.add_module(f"cross_attn_{i}",
                                Attention(dim, dim_head, heads, dropout=dropout))
            self.add_module(f"ff_norm_{i}",
                            RMSNorm(dim, scale=not has_cond, cond_dim=cond_dim))
            self.add_module(f"ff_{i}", FeedForward(dim, ff_mult, ff_causal_conv,
                                                   quant=quant_int8, knobs=int8_knobs))
        self.final_norm = RMSNorm(dim)
        self.to_pred = Dense(dim, dim, bias=False)

    def layer(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"{name}_{i}")

    def precompute_film(self, cond: torch.Tensor) -> dict:
        """Every adaptive-norm projection of `cond` [..., cond_dim], hoisted
        out of a sampling loop: {"attn": [...], "ff": [...]} per layer, and
        "cross" with `cross_attn`."""
        kinds = ("attn", "cross", "ff") if self.cross_attn else ("attn", "ff")
        return {kind: [self.layer(f"{kind}_norm", i).film(cond)
                       for i in range(self.depth)] for kind in kinds}

    def route(self, film) -> str:
        """The int8 route a call with this `film` takes ("module" also for a
        model without int8)."""
        if not (self.quant_int8 and film is not None and self.ff_causal_conv
                and not self.cross_attn and self.to_pred.weight.dtype == torch.bfloat16):
            return "module"
        if self.int8_route == "fused_layer" and self.heads * self.dim_head != self.dim:
            return "module"
        return self.int8_route

    def forward(self, x, cond=None, mask=None, film=None, context=None):
        """x [B, T, dim]; `cond` or its precomputed `film`; mask [B, T];
        `context` [B, Tc, dim] for the cross-attention."""
        if self.cross_attn and context is None:
            raise ValueError("a cross-attention transformer needs a context")
        route = self.route(film)
        if route == "fused_layer":
            if mask is None:
                mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
            for i in range(self.depth):
                w = {**self.layer("attn", i).fused.tensors(),
                     **self.layer("ff", i).int8.tensors()}
                x = fused_ops.fused_layer(x, mask, film["attn"][i], film["ff"][i], w,
                                          self.heads, self.dim_head)
            return self.to_pred(self.final_norm(x))
        for i in range(self.depth):
            hn = self.layer("attn_norm", i)(
                x, cond=cond, film=film["attn"][i] if film else None)
            x = x + self.layer("attn", i)(hn, mask=mask)
            if self.cross_attn:
                hn = self.layer("cross_norm", i)(
                    x, cond=cond, film=film["cross"][i] if film else None)
                x = x + self.layer("cross_attn", i)(hn, context=context)
            if route in ("ffpipe", "ffpipe2"):
                x = ffpipe_ops.ffpipe_layer(x, film["ff"][i], self.layer("ff", i).int8.tensors(),
                                            rows=2 if route == "ffpipe2" else 1)
                continue
            hn = self.layer("ff_norm", i)(
                x, cond=cond, film=film["ff"][i] if film else None)
            x = x + self.layer("ff", i)(hn)
        return self.to_pred(self.final_norm(x))


class Dropout(DropoutSite, nn.Module):
    """flax nn.Dropout: in training mode (JAX's `deterministic=False`) each
    element is kept with 1 - p and the kept ones scaled by 1 / (1 - p),
    drawn from `self.generator`; the identity in eval mode or at p = 0.
    `shard` (`ops.attention.tp_shard`): x is a tensor-parallel rank's block,
    whose mask is cut from one drawn over the whole tensor."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        return attention_ops.apply_dropout(x, self.p, self.generator, shard)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """The generator every dropout of `model` draws from (each
    `DropoutSite`: `Dropout`, and the attentions that drop probabilities)."""
    for m in model.modules():
        if isinstance(m, DropoutSite):
            m.generator = generator
