"""One whole transformer layer of the DDIM denoiser, int8 W8A8 feed-forward.

Replaces diffnorm_tpu/ops/pallas_block.py:fused_layer. The kernel is
`csrc/fused_layer.cu`: the attention norm, the q/kv and output projections as
bf16 mma.sync GEMMs, a masked-attention kernel that streams 64-key blocks,
then the int8 FF sublayer of `csrc/int8_ff.cuh` (the kernels behind
`ops/ffpipe.py`). It is bound by operations on an H100: at B64 x T128, C=512,
8 heads x 64, P=1408, 132.9 G int8 ops and 19.3 GFLOP of bf16, 86.7 us.
`models.layers.ConditionableTransformer` routes here on
`int8_route="fused_layer"`.

The function, per batch row (pallas_block.py:69-165):
    hn = bf16(normFiLM(x, film_attn)); q, k, v = bf16(hn Wq), bf16(hn Wkv)
    per head h: p = softmax(q_h k_h^T / sqrt(dh), masked keys -1e30)
                acc += bf16(bf16(p) v_h) Wo[h]                     (f32)
    x1 = x + bf16(acc)
    out = x1 + FF(normFiLM(x1, film_ff))  with the conv output rounded to
          bf16 before its requantization (ffpipe_layer keeps it f32)

The kernel is the custom op `diffnorm::fused_layer` (`fused_layer_op`), so
`torch.export` keeps it as one node of the program it writes.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops.ffpipe import (
    FF_KEYS,
    Pack,
    aligned,
    check_ff_pack,
    ff_sublayer_plain,
    norm_film,
)


@torch.no_grad()
def pack_layer_weights(w_q: torch.Tensor, w_kv: torch.Tensor, w_o: torch.Tensor,
                       ff_pack: Pack) -> Pack:
    """One layer's weights for the kernel (pallas_block.py:168-215): the
    attention projections in bf16 as [out, in] (wqkv = [Wq; Wkv] [3C, C],
    wo [C, C]) from the float32 masters, and the FF sublayer's
    `pack_ff_weights` pack. JAX's pack keeps a per-tensor scale as [1, 1] /
    [3, 1]; this one broadcasts it to [P] / [3, P] / [C], as
    pack_ff_weights does in both."""
    if w_q.dtype != torch.float32:
        raise TypeError(f"pack_layer_weights: packs are built from the float32 masters, "
                        f"got {w_q.dtype}")
    return {"wqkv": torch.cat([w_q, w_kv]).to(torch.bfloat16).contiguous(),
            "wo": w_o.to(torch.bfloat16).contiguous(), **ff_pack}


def attention_plain(x: torch.Tensor, mask: torch.Tensor, film_attn: torch.Tensor,
                    w: Pack, heads: int, dim_head: int) -> torch.Tensor:
    """The attention half: x + bf16(sum_h bf16(softmax(...) v_h) Wo[h])."""
    x = x.to(torch.bfloat16)
    b, t, c = x.shape
    hn = norm_film(x, film_attn).to(torch.bfloat16).float()
    qkv = (hn @ w["wqkv"].float().t()).to(torch.bfloat16).float()

    def split(z):
        return z.reshape(b, t, heads, dim_head).transpose(1, 2)

    q, k, v = (split(z) for z in qkv.split(c, dim=-1))
    s = (q @ k.transpose(-1, -2)) * dim_head ** -0.5
    s = s.masked_fill(~mask.bool()[:, None, None, :], -1e30)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    prob = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    o = (prob @ v).to(torch.bfloat16).float()  # [B, H, T, dh]
    wo = w["wo"].float()
    acc = torch.zeros(b, t, c, device=x.device)
    for h in range(heads):
        acc = acc + o[:, h] @ wo[:, h * dim_head:(h + 1) * dim_head].t()
    return x + acc.to(torch.bfloat16)


def fused_layer_plain(x: torch.Tensor, mask: torch.Tensor, film_attn: torch.Tensor,
                      film_ff: torch.Tensor, w: Pack, heads: int,
                      dim_head: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, step by step, integer products
    exact. Arguments as for `fused_layer`."""
    x1 = attention_plain(x, mask, film_attn, w, heads, dim_head)
    return ff_sublayer_plain(x1, film_ff, w, round_y=True)


LAYER_KEYS = ("wqkv", "wo") + FF_KEYS  # the op's pack order


@torch.library.custom_op("diffnorm::fused_layer", mutates_args=())
def fused_layer_op(x: torch.Tensor, mask: torch.Tensor, film_attn: torch.Tensor,
                   film_ff: torch.Tensor, w: List[torch.Tensor], heads: int,
                   dim_head: int) -> torch.Tensor:
    """The kernel as a custom op, the pack `w` in LAYER_KEYS order: its plain
    version on the CPU, the kernel on the card, shape and type alone under a
    fake tensor (torch.export)."""
    raise ValueError(f"fused_layer: unsupported device {x.device}")


@fused_layer_op.register_kernel("cpu")
def _plain(x, mask, film_attn, film_ff, w, heads, dim_head):
    return fused_layer_plain(x, mask, film_attn, film_ff, dict(zip(LAYER_KEYS, w)), heads,
                             dim_head)


@fused_layer_op.register_fake
def _fake(x, mask, film_attn, film_ff, w, heads, dim_head):
    return x.new_empty(x.shape, dtype=torch.bfloat16)


@fused_layer_op.register_kernel("cuda")
def _kernel(x, mask, film_attn, film_ff, w, heads, dim_head):
    w = dict(zip(LAYER_KEYS, w))
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise TypeError(f"fused_layer: x must be [B, T, C] bf16, got {x.dtype} "
                        f"{tuple(x.shape)}")
    b, t, c = x.shape
    if dim_head != 64 or heads * dim_head != c:
        raise ValueError(f"fused_layer: the kernel takes heads x 64 == C, got "
                         f"{heads} x {dim_head} for C={c}")
    for name, f in (("film_attn", film_attn), ("film_ff", film_ff)):
        if f.shape != (b, 2 * c) or f.device != x.device:
            raise ValueError(f"fused_layer: {name} must be [{b}, {2 * c}] on {x.device}")
    if mask.shape != (b, t) or mask.device != x.device:
        raise ValueError(f"fused_layer: mask must be [{b}, {t}] on {x.device}")
    p = check_ff_pack(w, c, x.device, "fused_layer")
    for name, shape in (("wqkv", (3 * c, c)), ("wo", (c, c))):
        wt = w[name]
        if tuple(wt.shape) != shape or wt.dtype != torch.bfloat16 or wt.device != x.device:
            raise ValueError(f"fused_layer: {name} must be bf16 {shape} on {x.device}")
        if not wt.is_contiguous() or wt.data_ptr() % 16:
            raise ValueError(f"fused_layer: {name} must be contiguous and aligned")
    x = aligned(x)
    mask = aligned(mask.to(torch.bool))
    film_bf16 = film_attn.dtype == film_ff.dtype == torch.bfloat16  # else read as f32
    film_type = torch.bfloat16 if film_bf16 else torch.float32
    fa, ffm = aligned(film_attn.to(film_type)), aligned(film_ff.to(film_type))
    m = b * t
    bf16 = dict(dtype=torch.bfloat16, device=x.device)
    hn, oh, x1 = (torch.empty(m, c, **bf16) for _ in range(3))
    qkv = torch.empty(m, 3 * c, **bf16)
    q = torch.empty(m, max(c, p), dtype=torch.int8, device=x.device)
    a = torch.empty(m, dtype=torch.float32, device=x.device)
    g, y = torch.empty(m, p, **bf16), torch.empty(m, p, **bf16)
    out = torch.empty_like(x)
    fn = _build.function("fused_layer", "fused_layer_bf16",
                         [ctypes.c_void_p] * 27 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), mask.data_ptr(), fa.data_ptr(), ffm.data_ptr(),
                    w["wqkv"].data_ptr(), w["wo"].data_ptr(),
                    *(w[k].data_ptr() for k in FF_KEYS),
                    hn.data_ptr(), qkv.data_ptr(), oh.data_ptr(), x1.data_ptr(),
                    q.data_ptr(), a.data_ptr(), g.data_ptr(), y.data_ptr(), out.data_ptr(),
                    b, t, c, p, heads, dim_head, int(film_bf16), stream), "fused_layer")
    _build.launch_counts["fused_layer"] += 1
    return out


@torch.no_grad()
def fused_layer(x: torch.Tensor, mask: torch.Tensor, film_attn: torch.Tensor,
                film_ff: torch.Tensor, w: Pack, heads: int, dim_head: int) -> torch.Tensor:
    """One layer: x [B, T, C] bf16; mask [B, T] bool (True = valid key);
    film_attn / film_ff [B, 2C]; w from `pack_layer_weights`. Returns bf16.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16, dim_head 64, heads * 64 == C, P a multiple of 64) or raises.
    Inference only: no gradient, as JAX serves its int8 routes."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_layer: unsupported device {x.device}")
    return fused_layer_op(x, mask, film_attn, film_ff, [w[k] for k in LAYER_KEYS], heads,
                          dim_head)
