"""Fused RMSNorm + FiLM: y = l2norm(x) * sqrt(C) * gamma_b + beta_b.

Replaces diffnorm_tpu/ops/pallas_norm.py:rms_norm_film. The kernel is
`csrc/rms_norm_film.cu`: one warp per (b, t) row, f32 math, one read and one
write of x, in bf16 or float32. It is bound by bytes on an H100: 16.9 MB at
the DDIM shape [64, 128, 512] bf16, 5.0 us at 3.35 TB/s.
`models.layers.RMSNorm` routes here for every FiLM-conditioned norm on a
CUDA tensor (24 per DDIM step).

The kernel is the custom op `diffnorm::rms_norm_film` (`rms_norm_film_op`),
so `torch.export` keeps it as one node of the program it writes.
"""

from __future__ import annotations

import ctypes
import math

import torch

from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops._autograd import with_plain_backward

SYMBOLS = {torch.bfloat16: "rms_norm_film_bf16", torch.float32: "rms_norm_film_f32"}


def rms_norm_film_plain(x: torch.Tensor, film: torch.Tensor,
                        eps: float = 1e-12) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: f32 math, result in x.dtype.
    x [B, T, C]; film [B, 2C] (gamma ++ beta)."""
    c = x.shape[-1]
    xf = x.float()
    ss = xf.square().sum(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(ss, min=eps * eps)) * math.sqrt(c)
    gamma, beta = film.float()[:, None, :].chunk(2, dim=-1)
    return ((xf * inv) * gamma + beta).to(x.dtype)


@torch.library.custom_op("diffnorm::rms_norm_film", mutates_args=())
def rms_norm_film_op(x: torch.Tensor, film: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel as a custom op: its plain version on the CPU, the kernel on
    the card, shape and type alone under a fake tensor (torch.export)."""
    raise ValueError(f"rms_norm_film: unsupported device {x.device}")


@rms_norm_film_op.register_kernel("cpu")
def _plain(x, film, eps):
    return rms_norm_film_plain(x, film, eps)


@rms_norm_film_op.register_kernel("cuda")
def _kernel(x, film, eps):
    if x.dim() != 3:
        raise ValueError(f"rms_norm_film: x must be [B, T, C], got {tuple(x.shape)}")
    b, t, c = x.shape
    if film.shape != (b, 2 * c):
        raise ValueError(
            f"rms_norm_film: film must be [{b}, {2 * c}], got {tuple(film.shape)}")
    if x.dtype not in SYMBOLS or film.dtype != x.dtype:
        raise TypeError(f"rms_norm_film: the kernel takes bf16 or float32 x and film of "
                        f"one type, got {x.dtype} / {film.dtype}")
    if film.device != x.device:
        raise ValueError("rms_norm_film: x and film on different devices")
    if not (x.is_contiguous() and film.is_contiguous()):
        raise ValueError("rms_norm_film: x and film must be contiguous")
    if c % 8:
        raise ValueError(f"rms_norm_film: C={c} is not a multiple of 8")
    out = torch.empty_like(x)
    fn = _build.function("rms_norm_film", SYMBOLS[x.dtype], [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), film.data_ptr(), out.data_ptr(), b * t, t, c,
                    eps, stream), "rms_norm_film")
    _build.launch_counts["rms_norm_film"] += 1
    return out


@rms_norm_film_op.register_fake
def _fake(x, film, eps):
    return x.new_empty(x.shape)


def _launch(x: torch.Tensor, film: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rms_norm_film: unsupported device {x.device}")
    return rms_norm_film_op(x, film, eps)


def rms_norm_film(x: torch.Tensor, film: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """x [B, T, C]; film [B, 2C] (gamma ++ beta). Returns x.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 or float32 x and film of one type, contiguous, C % 8 == 0) or
    raises. Where an input needs a gradient, the backward is the plain
    version's."""
    return with_plain_backward(_launch, rms_norm_film_plain, (x, film), eps=eps)
