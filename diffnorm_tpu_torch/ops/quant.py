"""Int8 W8A8 inference arithmetic (counterpart of diffnorm_tpu/ops/quant.py).

Symmetric scales: per output channel (or per tensor) for weights, per token
for activations. The rounding is JAX's to the bit: the scale is
max|.| / 127 as a true division, floored at 1e-12, and codes are
round-half-to-even of v / scale, again a true division. PyTorch turns
`scalar / tensor` (and, on CUDA, `tensor / python scalar`) into a product
with a reciprocal, which flips codes; `_div` divides by a tensor on the
operand's device instead.

Integer products are exact: `int_mm` is `torch._int_mm` (int8 x int8 ->
int32, on the CPU and on CUDA), never a float matmul: 1408 * 127^2 = 2.27e7
is past float32's 2^24.

The module route (`models/layers.py` with `int8_route="module"`) computes
its products here; the fused kernels (`ops/ffpipe.py`, `ops/fused_layer.py`)
compute theirs in their own CUDA code and use these functions only in their
plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

GRANULARITIES = ("channel", "tensor")


def _div(num: torch.Tensor, den) -> torch.Tensor:
    """num / den as an IEEE division (den a tensor or a Python number, which
    becomes a 0-d tensor filled on num's device: no host copy, so a CUDA
    graph can capture it)."""
    if not isinstance(den, torch.Tensor):
        den = num.new_full((), den)
    return torch.div(num, den)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(_div(amax, 127.0), min=1e-12)


def quantize_weight(w: torch.Tensor, granularity: str = "channel"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [out, in] (the torch Linear layout, the transpose of the flax
    kernel) -> (int8 [out, in], float32 scale [out, 1]; [1, 1] per tensor).

    "channel" is JAX's default; "tensor" is its DIFFNORM_INT8_WSCALAR=1.
    Call it on the float32 masters: codes from bf16-rounded weights differ."""
    if granularity not in GRANULARITIES:
        raise ValueError(f"granularity must be one of {GRANULARITIES}, got {granularity!r}")
    wf = w.float()
    if granularity == "tensor":
        amax = wf.abs().amax().reshape(1, 1)
    else:
        amax = wf.abs().amax(dim=-1, keepdim=True)
    ws = _scale(amax)
    return torch.round(_div(wf, ws)).to(torch.int8), ws


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., in] -> (int8 [..., in], float32 per-token scale [..., 1])."""
    xf = x.float()
    ax = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(_div(xf, ax)).to(torch.int8), ax


def int_mm(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """Exact int8 product a [M, K] @ b_nk[N, K]^T -> int32 [M, N].

    On CUDA `torch._int_mm` wants M > 16 and K, N multiples of 8; the
    operands are zero-padded to that (exact for integers)."""
    m, k = a.shape
    n = b_nk.shape[0]
    if a.is_cuda:
        pad_k, pad_n, pad_m = (-k) % 8, (-n) % 8, max(17 - m, 0)
        if pad_k or pad_m:
            a = F.pad(a, (0, pad_k, 0, pad_m))
        if pad_k or pad_n:
            b_nk = F.pad(b_nk, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), b_nk.contiguous().t())
    return out[:m, :n]


def dequant(acc: torch.Tensor, ax: torch.Tensor, ws: torch.Tensor,
            out_dtype: torch.dtype, bf16_epilogue: bool = True) -> torch.Tensor:
    """int32 accumulator x per-token scale x weight scale -> out_dtype.

    With a bf16 output the whole epilogue runs in bf16 (JAX's default,
    DIFFNORM_INT8_DEQ_BF16=1); `bf16_epilogue=False` is its f32 epilogue.
    A one-element scale folds into the other before touching `acc`."""
    bf16 = bf16_epilogue and out_dtype == torch.bfloat16
    if ws.numel() == 1 or ax.numel() == 1:
        scale = ax * ws.reshape(()) if ws.numel() == 1 else ws * ax.reshape(())
        if bf16:
            return acc.to(torch.bfloat16) * scale.to(torch.bfloat16)
        return (acc.float() * scale).to(out_dtype)
    if bf16:
        return acc.to(torch.bfloat16) * ax.to(torch.bfloat16) * ws.to(torch.bfloat16)
    return (acc.float() * ax * ws).to(out_dtype)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                pre_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                bf16_epilogue: bool = True) -> torch.Tensor:
    """x [..., in] float; wq [out, in] int8 and ws [out, 1] (or [1, 1]) from
    `quantize_weight`. Returns [..., out] in x.dtype. `pre_quant=(xq, ax)`
    reuses an input quantized once for several products (q and kv)."""
    xq, ax = pre_quant if pre_quant is not None else quantize_act(x)
    lead = xq.shape[:-1]
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*lead, wq.shape[0])
    return dequant(acc, ax, ws.reshape(1, -1), x.dtype, bf16_epilogue)
