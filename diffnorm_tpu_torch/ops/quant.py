"""Int8 W8A8 inference arithmetic (counterpart of diffnorm_tpu/ops/quant.py).

Symmetric scales: per output channel (or per tensor) for weights, per token
(or per tensor) for activations. The rounding is JAX's to the bit: the scale is
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

JAX switches its int8 variants with environment variables read at trace
time; the port takes them as one `Int8Knobs` value per model. Static
activation scales (JAX's `site_quantize`, DIFFNORM_INT8_CALIB /
DIFFNORM_INT8_STATIC) are module state: every int8 activation site (a
`QuantSite`: `Dense(quant)`, `CausalConv1d(quant)`, the self-attention's
shared q/kv quantization) holds an `act_amax` buffer, recorded under
`calibrating(model)` and read once `set_static_scales(model, True)` is on.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GRANULARITIES = ("channel", "tensor")


@dataclasses.dataclass(frozen=True)
class Int8Knobs:
    """JAX's int8 environment switches, with JAX's defaults.

    wscalar     DIFFNORM_INT8_WSCALAR=1: per-tensor weight scales
    ascalar     DIFFNORM_INT8_ASCALAR=1: per-tensor activation scales
    quant_bf16  DIFFNORM_INT8_QUANT_BF16=1: the abs-max / divide chain in bf16
    deq_bf16    DIFFNORM_INT8_DEQ_BF16 (on by default): the dequant in bf16
    convcat     DIFFNORM_INT8_CONVCAT=1: a k-tap conv as one K = k * C
                product where the activation scale is per tensor"""

    wscalar: bool = False
    ascalar: bool = False
    quant_bf16: bool = False
    deq_bf16: bool = True
    convcat: bool = False

    @property
    def granularity(self) -> str:
        return "tensor" if self.wscalar else "channel"


# bench.py:38-49, the JAX DDIM serving headline: per-tensor weight and
# activation scales (with calibrated static activation scales on top)
HEADLINE_KNOBS = Int8Knobs(wscalar=True, ascalar=True)


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


def quantize_act(x: torch.Tensor, per_tensor: bool = False,
                 bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., in] -> (int8 [..., in], per-token scale [..., 1]; one scale
    shaped [1, ..., 1] with `per_tensor`, JAX's DIFFNORM_INT8_ASCALAR=1).

    The scale is float32, except with `bf16` (DIFFNORM_INT8_QUANT_BF16=1) on
    a bf16 x: then the abs-max, its product with bf16(1/127) and the
    quotient stay bf16, the codes clamped to [-127, 127] before the cast, and
    the scale is bf16 (quant.py:80-89)."""
    dims = tuple(range(x.dim())) if per_tensor else (-1,)
    if bf16 and x.dtype == torch.bfloat16:
        amax = x.abs().amax(dim=dims, keepdim=True)
        ax = amax * torch.tensor(1.0 / 127.0, dtype=torch.bfloat16, device=x.device)
        ax = torch.clamp(ax, min=1e-12)
        return torch.clamp(torch.round(torch.div(x, ax)), -127, 127).to(torch.int8), ax
    xf = x.float()
    ax = _scale(xf.abs().amax(dim=dims, keepdim=True))
    return torch.round(_div(xf, ax)).to(torch.int8), ax


def quantize_act_static(x: torch.Tensor, amax: torch.Tensor,
                        bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize with a calibrated per-tensor amax, no abs-max reduce
    (quant.py:105-123): the scale is max(amax, 1e-10) / 127 in float32,
    shaped [1, ..., 1]; codes round(x / scale) clamped to [-127, 127]. With
    `bf16` on a bf16 x the quotient is taken in bf16 by the bf16-rounded
    scale."""
    ax = _div(torch.clamp(amax.float(), min=1e-10).reshape((1,) * x.dim()), 127.0)
    if bf16 and x.dtype == torch.bfloat16:
        q = torch.round(torch.div(x, ax.to(torch.bfloat16)))
    else:
        q = torch.round(_div(x.float(), ax))
    return torch.clamp(q, -127, 127).to(torch.int8), ax


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
        # float32, as JAX promotes a bf16 scale (QUANT_BF16) by a float32 one
        scale = ax.float() * ws.reshape(()) if ws.numel() == 1 else ws * ax.reshape(())
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


# ------------------------------------------------------------ sites

class QuantSite:
    """An int8 activation site (JAX's `site_quantize` on one module), mixed
    into a module with `quant` and `knobs`: its calibrated amax is the
    non-persistent float32 buffer `act_amax` (None until recorded or loaded;
    `weights.from_jax_variables` / `to_jax_variables` carry it as the flax
    `quant_stats/<path>/act_amax`), kept float32 when the module is cast."""

    def _init_site(self) -> None:
        self.register_buffer("act_amax", None, persistent=False)
        self.act_static = False       # DIFFNORM_INT8_STATIC for this site
        self.act_calibrating = False  # DIFFNORM_INT8_CALIB for this site

    def _apply(self, fn, recurse=True):
        amax = self._buffers.get("act_amax")
        out = super()._apply(fn, recurse)
        moved = self._buffers.get("act_amax")
        if amax is not None and moved.dtype != torch.float32:
            self._buffers["act_amax"] = amax.to(moved.device)
        return out

    def quantize_input(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX's site_quantize (quant.py:126-143): the static scale when on
        and recorded, else dynamic quantization, recording the running max
        of max(scale) * 127 while calibrating."""
        knobs = self.knobs
        if self.act_static and self.act_amax is not None:
            return quantize_act_static(x, self.act_amax.to(x.device), knobs.quant_bf16)
        xq, ax = quantize_act(x, knobs.ascalar, knobs.quant_bf16)
        if self.act_calibrating:
            seen = ax.max().float() * 127.0
            self.act_amax = seen if self.act_amax is None else torch.maximum(self.act_amax, seen)
        return xq, ax


def quant_sites(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """(name, module) of every int8 activation site of `model`."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, QuantSite) and m.quant]


def set_static_scales(model: nn.Module, on: bool = True) -> None:
    """JAX's DIFFNORM_INT8_STATIC=1 for every site of `model`: a site with a
    recorded amax quantizes by it; one without stays dynamic."""
    for _, site in quant_sites(model):
        site.act_static = on


@contextlib.contextmanager
def calibrating(model: nn.Module) -> Iterator[None]:
    """JAX's DIFFNORM_INT8_CALIB=1 around the enclosed forwards: every site
    of `model` quantizes dynamically and records its running amax."""
    sites = [site for _, site in quant_sites(model)]
    saved = [(site.act_static, site.act_calibrating) for site in sites]
    for site in sites:
        site.act_static, site.act_calibrating = False, True
    try:
        yield
    finally:
        for site, (static, calib) in zip(sites, saved):
            site.act_static, site.act_calibrating = static, calib

