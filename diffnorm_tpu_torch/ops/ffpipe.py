"""The int8 W8A8 feed-forward sublayer: x + FF(normFiLM(x)), bf16.

Replaces diffnorm_tpu/ops/pallas_ffpipe.py:ffpipe_layer and its two-row
twin _ffpipe_layer2. The kernel is `csrc/int8_ff.cu` (design in
`csrc/int8_ff.cuh`): six launches over the B*T tokens, the three products
on int8 mma.sync with exact int32 sums. It is bound by operations on an
H100: 132.9 G int8 ops at B64 x T128, C=512, P=1408, 67 us at 1979 TOP/s.
`models.layers.ConditionableTransformer` routes here on `int8_route="ffpipe"`
(rows 1) and `"ffpipe2"` (rows 2).

The function, per token (pallas_ffpipe.py:59-107):
    h  = normFiLM(x) in f32; q2, a2 = int8(h)
    g  = bf16(gelu(q2 Wx a2 sx + bx) * (q2 Wg a2 sg + bg)); q3, a3 = int8(g)
    y  = sum_i (shift_i(q3) Wc_i) shift_i(a3) sc_i + bc      (f32)
    q4, a4 = int8(y); out = x + bf16(q4 Wf a4 sf + bf)
with per-token activation scales and the weights packed by
`pack_ff_weights`. The TPU kernel's row pipeline (rows 1 or 2 batch rows per
grid step) is a scheduling device of that machine; here `rows` sets how many
128-token row groups one block's M tile spans, and both give the same bits.

The kernel is the custom op `diffnorm::ffpipe_layer` (`ffpipe_layer_op`), so
`torch.export` keeps it as one node of the program it writes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops.quant import _div, int_mm, quantize_act, quantize_weight

Pack = Dict[str, torch.Tensor]
FF_KEYS = ("wxq", "wxs", "bx", "wgq", "wgs", "bg", "wcq", "wcs", "bc", "wfq", "wfs", "bf")
_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@torch.no_grad()
def pack_ff_weights(w_in: torch.Tensor, b_in: torch.Tensor, w_conv: torch.Tensor,
                    b_conv: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
                    granularity: str = "channel") -> Pack:
    """Quantize and pad one FF sublayer for the kernel (pallas_ffpipe.py:208-251).

    Torch layouts, float32 masters: w_in [2 * inner, C] (x half then gate
    half), w_conv [inner, inner, 3] ([out, in, k]), w_out [C, inner]. The inner
    width is zero-padded to P = round_up(inner, 128). Returns int8 weights as
    [out, in] (wxq, wgq [P, C]; wcq [3, P, P]; wfq [C, P]) with float32 scales
    wxs, wgs [P], wcs [3, P], wfs [C] (a per-tensor scale is broadcast, as
    the JAX pack does) and float32 biases bx, bg, bc [P], bf [C]."""
    if w_in.dtype != torch.float32:
        raise TypeError(f"pack_ff_weights: int8 packs are built from the float32 "
                        f"masters (load weights before casting the model), got {w_in.dtype}")
    inner = w_in.shape[0] // 2
    c = w_in.shape[1]
    p = round_up(inner, 128)
    pad = p - inner

    def quant(w, n_out):
        wq, ws = quantize_weight(w, granularity)
        return wq.contiguous(), ws.reshape(-1).expand(n_out).contiguous()

    wxq, wxs = quant(F.pad(w_in[:inner].float(), (0, 0, 0, pad)), p)
    wgq, wgs = quant(F.pad(w_in[inner:].float(), (0, 0, 0, pad)), p)
    taps = [quant(F.pad(w_conv[:, :, i].float(), (0, pad, 0, pad)), p) for i in range(3)]
    wfq, wfs = quant(F.pad(w_out.float(), (0, pad)), c)
    return {
        "wxq": wxq, "wxs": wxs, "bx": F.pad(b_in[:inner].float(), (0, pad)).contiguous(),
        "wgq": wgq, "wgs": wgs, "bg": F.pad(b_in[inner:].float(), (0, pad)).contiguous(),
        "wcq": torch.stack([t[0] for t in taps]), "wcs": torch.stack([t[1] for t in taps]),
        "bc": F.pad(b_conv.float(), (0, pad)).contiguous(),
        "wfq": wfq, "wfs": wfs, "bf": b_out.float().contiguous(),
    }


def norm_film(x: torch.Tensor, film: torch.Tensor) -> torch.Tensor:
    """The kernels' adaptive RMSNorm in f32 (pallas_block.py:57-66):
    x * (sqrt(C) / max(||x||, 1e-12)) * gamma + beta; film [B, 2C]."""
    xf = x.float()
    c = xf.shape[-1]
    denom = torch.clamp(torch.sqrt((xf * xf).sum(-1, keepdim=True)), min=1e-12)
    n = xf * _div(torch.full_like(denom, math.sqrt(c)), denom)
    gamma, beta = film.float()[:, None, :].chunk(2, dim=-1)
    return n * gamma + beta


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) operation by operation:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))."""
    return x * (0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))))


def _shift(t: torch.Tensor, shift: int, fill: float) -> torch.Tensor:
    """t[:, i - shift] along time, `fill` before t = 0 ([B, T, D])."""
    if shift == 0:
        return t
    return F.pad(t[:, :-shift], (0, 0, shift, 0), value=fill)


def ff_sublayer_plain(x: torch.Tensor, film: torch.Tensor, w: Pack,
                      round_y: bool) -> torch.Tensor:
    """The kernels' FF arithmetic step by step, integer products exact.
    `round_y` rounds the conv output to bf16 before its requantization
    (fused_layer); without it the f32 output is requantized (ffpipe_layer)."""
    x = x.to(torch.bfloat16)
    b, t, c = x.shape
    p = w["wxq"].shape[0]
    q2, a2 = quantize_act(norm_film(x, film).reshape(-1, c))
    hx = int_mm(q2, w["wxq"]).float() * a2 * w["wxs"] + w["bx"]
    hg = int_mm(q2, w["wgq"]).float() * a2 * w["wgs"] + w["bg"]
    g = (gelu_tanh(hg) * hx).to(torch.bfloat16)
    q3, a3 = quantize_act(g.float())
    q3, a3 = q3.reshape(b, t, p), a3.reshape(b, t, 1)
    y = torch.zeros(b * t, p, device=x.device)
    for i in range(3):
        shift = 2 - i
        if shift >= t:
            continue  # the whole tap falls before the sequence
        qi = _shift(q3, shift, 0).reshape(-1, p)
        ai = _shift(a3, shift, 1.0).reshape(-1, 1)
        y = y + int_mm(qi, w["wcq"][i]).float() * ai * w["wcs"][i]
    y = y + w["bc"]
    if round_y:
        y = y.to(torch.bfloat16).float()
    q4, a4 = quantize_act(y)
    out = int_mm(q4, w["wfq"]).float() * a4 * w["wfs"] + w["bf"]
    return x + out.to(torch.bfloat16).reshape(b, t, c)


def ffpipe_layer_plain(x: torch.Tensor, film_ff: torch.Tensor, w: Pack) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (any rows: they agree bit for bit)."""
    return ff_sublayer_plain(x, film_ff, w, round_y=False)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned, as the kernels' vector loads need."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous().clone()


def check_ff_pack(w: Pack, c: int, device: torch.device, what: str) -> int:
    """Raise unless `w` is a pack_ff_weights pack for width C on `device`;
    returns P."""
    p = w["wxq"].shape[0]
    shapes = {"wxq": (p, c), "wgq": (p, c), "wcq": (3, p, p), "wfq": (c, p),
              "wxs": (p,), "wgs": (p,), "wcs": (3, p), "wfs": (c,),
              "bx": (p,), "bg": (p,), "bc": (p,), "bf": (c,)}
    for name, shape in shapes.items():
        t = w[name]
        dtype = torch.int8 if name.endswith("q") else torch.float32
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and aligned on {device}")
    if c % 64 or p % 64:
        raise ValueError(f"{what}: C={c} and P={p} must be multiples of 64")
    return p


@torch.library.custom_op("diffnorm::ffpipe_layer", mutates_args=())
def ffpipe_layer_op(x: torch.Tensor, film_ff: torch.Tensor, w: List[torch.Tensor],
                    rows: int) -> torch.Tensor:
    """The kernel as a custom op, the pack `w` in FF_KEYS order: its plain
    version on the CPU, the kernel on the card, shape and type alone under a
    fake tensor (torch.export). The kernel takes rows 2 only where the batch
    it is given is even and >= 4, so an exported program with a symbolic
    batch decides it at each call."""
    raise ValueError(f"ffpipe_layer: unsupported device {x.device}")


@ffpipe_layer_op.register_kernel("cpu")
def _plain(x, film_ff, w, rows):
    return ffpipe_layer_plain(x, film_ff, dict(zip(FF_KEYS, w)))


@ffpipe_layer_op.register_fake
def _fake(x, film_ff, w, rows):
    return x.new_empty(x.shape, dtype=torch.bfloat16)


@ffpipe_layer_op.register_kernel("cuda")
def _kernel(x, film_ff, w, rows):
    w = dict(zip(FF_KEYS, w))
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise TypeError(f"ffpipe_layer: x must be [B, T, C] bf16, got {x.dtype} "
                        f"{tuple(x.shape)}")
    b, t, c = x.shape
    if film_ff.shape != (b, 2 * c) or film_ff.device != x.device:
        raise ValueError(f"ffpipe_layer: film_ff must be [{b}, {2 * c}] on {x.device}")
    p = check_ff_pack(w, c, x.device, "ffpipe_layer")
    if rows == 2 and not (b % 2 == 0 and b >= 4):
        rows = 1
    x = aligned(x)
    film_bf16 = film_ff.dtype == torch.bfloat16  # else read as f32
    film = aligned(film_ff if film_bf16 else film_ff.float())
    m = b * t
    out = torch.empty_like(x)
    q = torch.empty(m, max(c, p), dtype=torch.int8, device=x.device)
    a = torch.empty(m, dtype=torch.float32, device=x.device)
    g = torch.empty(m, p, dtype=torch.bfloat16, device=x.device)
    y = torch.empty(m, p, dtype=torch.float32, device=x.device)
    fn = _build.function("int8_ff", "int8_ff_bf16",
                         [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), film.data_ptr(), *(w[k].data_ptr() for k in FF_KEYS),
                    q.data_ptr(), a.data_ptr(), g.data_ptr(), y.data_ptr(), out.data_ptr(),
                    b, t, c, p, rows, int(film_bf16), stream), "ffpipe_layer")
    _build.launch_counts["ffpipe_layer2" if rows == 2 else "ffpipe_layer"] += 1
    return out


@torch.no_grad()
def ffpipe_layer(x: torch.Tensor, film_ff: torch.Tensor, w: Pack,
                 rows: int = 1) -> torch.Tensor:
    """x [B, T, C] bf16 (the post-attention residual stream); film_ff
    [B, 2C]; w from `pack_ff_weights`. Returns x + FF(normFiLM(x)) in bf16.

    rows=2 is JAX's DIFFNORM_FFPIPE_ROWS=2; as there, it applies when B is
    even and >= 4, and rows 1 runs otherwise. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16, C and P multiples of
    64) or raises. Inference only: no gradient, as JAX serves its int8
    routes."""
    if rows not in (1, 2):
        raise ValueError(f"ffpipe_layer: rows must be 1 or 2, got {rows}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ffpipe_layer: unsupported device {x.device}")
    return ffpipe_layer_op(x, film_ff, [w[k] for k in FF_KEYS], rows)
