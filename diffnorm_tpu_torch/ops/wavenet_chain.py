"""One WaveNet chain: every stack at one dilation, then the skip projection.

Replaces diffnorm_tpu/ops/pallas_wavenet.py:wavenet_chain. The kernels are in
`csrc/wavenet_chain.cu`: for bf16, a persistent warp-specialized kernel on
wgmma fed by a TMA ring (the causal shift by TMA's zero fill, the residual
product from the unshifted tap's A tile, FiLM / gated activation / residual
in the epilogue); for float32, a SIMT FMA kernel with the same epilogue. One
launch per stack and one for the skip.
It is bound by operations on an H100: a denoiser chain at B64 x T128, C=512,
S=4, k=3 is 73 GFLOP, 74 us at 989 TFLOP/s dense bf16. `models.wavenet.Wavenet`
runs each of its chains through here: 8 per DDIM step, 3 per VAE WaveNet.

Per stack s (module semantics, diffnorm_tpu/models/wavenet.py:55-67):
    res = x W_res[s]^T + b_res[s]
    h   = sum_i shift(x, (k-1-i) d) W_conv[s, i]^T
    h   = h * gamma[:, s] + beta[:, s]      with beta = beta_film + gamma * b_conv
    x   = tanh(h) * sigmoid(h) + res        (rounded to x.dtype)
then skip = x W_skip^T + b_skip. Weights are [out, in], torch's Linear
layout (the kernel's K-major operands). Folding the conv bias as
beta + gamma * b_conv keeps (conv(x) + b_conv) * gamma + beta exact; the
callers fold it.

The kernel is the custom op `diffnorm::wavenet_chain` (`wavenet_chain_op`),
so `torch.export` keeps it as one node of the program it writes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops._autograd import with_plain_backward
from diffnorm_tpu_torch.ops.ffpipe import aligned

SYMBOLS = {torch.bfloat16: "wavenet_chain_bf16", torch.float32: "wavenet_chain_f32"}


def _shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x[:, t - shift] with zeros before t = 0 ([B, T, C])."""
    if shift == 0:
        return x
    return F.pad(x[:, :-shift], (0, 0, shift, 0))


def wavenet_chain_plain(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta,
                        dilation: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: products and sums in f32, each
    stack's output rounded to x.dtype. Arguments as for `wavenet_chain`."""
    s_count, k = w_conv.shape[0], w_conv.shape[1]
    t_len = x.shape[1]
    h_in = x
    for s in range(s_count):
        xf = h_in.float()
        res = F.linear(xf, w_res[s].float(), b_res[s].float())
        h = None
        for i in range(k):
            shift = (k - 1 - i) * dilation
            if shift >= t_len:
                continue  # the whole tap falls before the sequence
            term = F.linear(_shift(xf, shift), w_conv[s, i].float())
            h = term if h is None else h + term
        h = h * gamma[:, s, None, :] + beta[:, s, None, :]
        h_in = (torch.tanh(h) * torch.sigmoid(h) + res).to(x.dtype)
    return F.linear(h_in.float(), w_skip.float(), b_skip.float()).to(x.dtype)


@torch.library.custom_op("diffnorm::wavenet_chain", mutates_args=())
def wavenet_chain_op(x: torch.Tensor, w_conv: torch.Tensor, w_res: torch.Tensor,
                     w_skip: torch.Tensor, b_res: torch.Tensor, b_skip: torch.Tensor,
                     gamma: torch.Tensor, beta: torch.Tensor, dilation: int) -> torch.Tensor:
    """The kernel as a custom op: its plain version on the CPU, the kernel on
    the card, shape and type alone under a fake tensor (torch.export)."""
    raise ValueError(f"wavenet_chain: unsupported device {x.device}")


@wavenet_chain_op.register_kernel("cpu")
def _plain(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta, dilation):
    return wavenet_chain_plain(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta,
                               dilation)


@wavenet_chain_op.register_fake
def _fake(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta, dilation):
    return x.new_empty(x.shape)


@wavenet_chain_op.register_kernel("cuda")
def _kernel(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta, dilation):
    if x.dim() != 3 or w_conv.dim() != 4:
        raise ValueError("wavenet_chain: x must be [B, T, C], w_conv [S, k, C, C]")
    if x.dtype not in SYMBOLS:
        raise TypeError(f"wavenet_chain: the kernels take bf16 or float32, got {x.dtype}")
    b, t, c = x.shape
    s_count, k = w_conv.shape[:2]
    shapes = {
        "x": (x, (b, t, c), x.dtype),
        "w_conv": (w_conv, (s_count, k, c, c), x.dtype),
        "w_res": (w_res, (s_count, c, c), x.dtype),
        "w_skip": (w_skip, (c, c), x.dtype),
        "b_res": (b_res, (s_count, c), x.dtype),
        "b_skip": (b_skip, (c,), x.dtype),
        "gamma": (gamma, (b, s_count, c), torch.float32),
        "beta": (beta, (b, s_count, c), torch.float32),
    }
    for name, (tensor, shape, dtype) in shapes.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(
                f"wavenet_chain: {name} must be {shape}, got {tuple(tensor.shape)}")
        if tensor.dtype != dtype:
            raise TypeError(f"wavenet_chain: {name} must be {dtype}, got {tensor.dtype}")
        if tensor.device != x.device or not tensor.is_contiguous():
            raise ValueError(f"wavenet_chain: {name} must be contiguous on {x.device}")
    if c % 8:
        raise ValueError(f"wavenet_chain: C={c} is not a multiple of 8")
    if dilation < 1:
        raise ValueError(f"wavenet_chain: dilation {dilation} < 1")
    x, w_conv, w_res, w_skip = map(aligned, (x, w_conv, w_res, w_skip))  # TMA reads them
    out = torch.empty_like(x)
    buf0 = torch.empty_like(x)
    buf1 = torch.empty_like(x) if s_count > 1 else buf0
    fn = _build.function("wavenet_chain", SYMBOLS[x.dtype],
                         [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(
        x.data_ptr(), w_conv.data_ptr(), w_res.data_ptr(), w_skip.data_ptr(),
        b_res.data_ptr(), b_skip.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        buf0.data_ptr(), buf1.data_ptr(), out.data_ptr(), b, t, c, s_count, k,
        dilation, stream), "wavenet_chain")
    _build.launch_counts["wavenet_chain"] += 1
    return out


def _launch(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta,
            dilation: int) -> torch.Tensor:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wavenet_chain: unsupported device {x.device}")
    return wavenet_chain_op(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta, dilation)


def wavenet_chain(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta,
                  dilation: int) -> torch.Tensor:
    """One chain through all S stacks; returns its skip [B, T, C] in x.dtype.

    x [B, T, C]; w_conv [S, k, C, C], w_res [S, C, C], w_skip [C, C] as
    [out, in]; b_res [S, C], b_skip [C] in x.dtype; gamma, beta [B, S, C]
    float32 with the conv bias folded into beta. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16 or float32, contiguous,
    C % 8 == 0) or raises. Where an input needs a gradient, the backward is
    the plain version's."""
    return with_plain_backward(_launch, wavenet_chain_plain,
                               (x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta),
                               dilation=dilation)
