"""Non-causal attention with a key-padding mask, online softmax, f32 sums.

Replaces diffnorm_tpu/ops/pallas_attention.py:flash_attention. The kernel is
`csrc/flash_attention.cu`: for bf16 with D 64/128, one warpgroup per 64
queries on wgmma, K/V in 64-key tiles streamed by TMA through a ring of
stages, P split into bf16 hi + lo (so the probabilities keep f32 precision
as on the TPU); where the grid would leave the card under-filled, the key
tiles are split into ranges (`split_plan`) whose partial results a second
launch merges. D 32/96 keep an mma.sync kernel. float32 inputs (D <= 128)
take tf32 wgmma in three passes per product (hi hi' + hi lo' + lo hi', each
operand and P split into tf32 hi + lo), which keeps float32's accuracy;
prologue launches write the split Q, K and V^T into scratch the wrapper
allocates. At the S2ST decoder's encoder attention (q [2,8,256,64], k/v
[2,8,2112,64], bf16) it is bound by bytes on an H100: 9.7 MB, 2.9 us at
3.35 TB/s; at HuBERT's float32 long form ([1,12,3499,64]) by operations,
three tf32 passes of 37.6 GFLOP, 0.228 ms.
`ops.attention.masked_attention` routes here for keys of length >= 2048 on
the card where `supports` says the kernel takes the inputs.

The function (pallas_attention.py:26-80), in f32:
    s = (q / sqrt(D)) k^T, s = -1e30 where the key is masked
    out = softmax(s) v = exp(s - max) v / max(sum exp(s - max), 1e-30)
Keys past Tk take no part, so a fully masked row is the mean of v over the
Tk keys, as `masked_attention` gives. The TPU kernel pads Tk to its block
and masks the padding like real keys, which gives sum(v) / Tk_pad on such a
row (ROADMAP Queue 3).

The kernel is the custom op `diffnorm::flash_attention`
(`flash_attention_op`), so `torch.export` keeps it as one node of the
program it writes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops._autograd import with_plain_backward

MASKED = -1.0e30  # pallas_attention.py NEG_INF
BF16_DIMS = (32, 64, 96, 128)
SPLIT_DIMS = (64, 128)  # the wgmma kernel's head widths, which split the keys
BLOCK = 64  # query rows per block and keys per tile
BLOCKS_PER_SM = 2  # split until the grid has about this many blocks per SM


def split_plan(bh: int, tq: int, tk: int, sms: int):
    """(n_splits, tiles_per_split) of the bf16 wgmma kernel: the Tk keys in
    64-key tiles, cut into contiguous ranges only where (query tiles x B*H)
    blocks would leave the card under BLOCKS_PER_SM blocks per SM. Every
    range holds at least one key below Tk."""
    tiles = -(-tk // BLOCK)
    blocks = -(-tq // BLOCK) * bh
    want = min(tiles, max(1, -(-BLOCKS_PER_SM * sms // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch, f32 products and sums; arguments as
    for `flash_attention`."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(~mask.bool()[:, None, None, :], MASKED)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def flash_attention_plain_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                mask: Optional[torch.Tensor], n_splits: int) -> torch.Tensor:
    """The split-key form of the kernel in PyTorch, f32: the keys cut into
    contiguous ranges of ceil(Tk / n_splits) (so no range is empty), each
    range's unnormalized o_i with its row max m_i and sum l_i, merged as the
    kernel's merge launch does:
        m* = max_i m_i,  o = sum_i e^(m_i - m*) o_i / max(sum_i e^(m_i - m*) l_i, 1e-30)
    A range whose keys are all masked has m_i = -1e30 and weighs nothing
    beside a range with a valid key; a row with no valid key is the mean of
    v over the Tk keys. For the tests: no path calls it."""
    tk = k.shape[2]
    chunk = -(-tk // n_splits)
    scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    parts = []
    for k0 in range(0, tk, chunk):
        s = torch.matmul(qf, k[:, :, k0:k0 + chunk].float().transpose(-1, -2))
        if mask is not None:
            s = s.masked_fill(~mask.bool()[:, None, None, k0:k0 + chunk], MASKED)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((torch.matmul(p, v[:, :, k0:k0 + chunk].float()), m, p.sum(-1, keepdim=True)))
    m_star = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    o = sum(torch.exp(m - m_star) * o_i for o_i, m, _ in parts)
    l = sum(torch.exp(m - m_star) * l_i for _, m, l_i in parts)
    return (o / l.clamp(min=1e-30)).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor]) -> Optional[Exception]:
    """Why the kernel cannot take these inputs (the error the wrapper
    raises), or None where it can. The device type is not checked here."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return ValueError(f"flash_attention: q, k, v must be [B, H, T, D], got "
                          f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        return ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        return TypeError(f"flash_attention: q, k, v differ in type: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16:
        if d not in BF16_DIMS:
            return ValueError(f"flash_attention: the bf16 kernel takes D in {BF16_DIMS}, got {d}")
    elif q.dtype == torch.float32:
        if not 0 < d <= 128:
            return ValueError(f"flash_attention: the f32 kernel takes D <= 128, got {d}")
    else:
        return TypeError(f"flash_attention: the kernel takes bf16 or float32, got {q.dtype}")
    if not (q.device == k.device == v.device):
        return ValueError("flash_attention: q, k, v on different devices")
    if b * h > 65535 or tq == 0 or tk == 0:
        return ValueError(f"flash_attention: unsupported shape B*H={b * h}, Tq={tq}, Tk={tk}")
    if mask is not None and (mask.shape != (b, tk) or mask.device != q.device):
        return ValueError(f"flash_attention: mask must be [{b}, {tk}] on {q.device}, "
                          f"got {tuple(mask.shape)}")
    return None


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> bool:
    """Whether `flash_attention` launches its kernel for these tensors on the
    card rather than raising: the wrapper's own checks of shapes, types and
    devices (both read `_refusal`). Callers that route to the kernel check
    this before any launch."""
    return _refusal(q, k, v, mask) is None


@torch.library.custom_op("diffnorm::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel as a custom op (bf16 or float32 by q's dtype): its plain
    version on the CPU, the kernel on the card, shape and type alone under a
    fake tensor (torch.export)."""
    raise ValueError(f"flash_attention: unsupported device {q.device}")


@flash_attention_op.register_kernel("cpu")
def _plain(q, k, v, mask):
    return flash_attention_plain(q, k, v, mask)


@flash_attention_op.register_fake
def _fake(q, k, v, mask):
    return q.new_empty(q.shape)


@flash_attention_op.register_kernel("cuda")
def _kernel(q, k, v, mask):
    refusal = _refusal(q, k, v, mask)
    if refusal is not None:
        raise refusal
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if mask is not None:
        mask = mask.to(torch.bool).contiguous()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr())
    if q.dtype == torch.float32:
        # the tf32 hi/lo halves of Q, K and V^T, padded as the kernel pads
        # them: their sizes come from the library, which owns the layout
        sizing = _build.function("flash_attention", "flash_attention_f32_scratch",
                                 [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)])
        counts = (ctypes.c_longlong * 3)()
        _build.check(sizing(b * h, h, tq, tk, d, counts), "flash_attention")
        scratch = [torch.empty(n, dtype=torch.float32, device=q.device) for n in counts]
        fn = _build.function("flash_attention", "flash_attention_f32", [ctypes.c_void_p] * 8
                             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        err = fn(*ptrs, *(t.data_ptr() for t in scratch), b * h, h, tq, tk, d, d ** -0.5,
                 stream)
    else:
        n_splits, per = 1, -(-tk // BLOCK)
        o_part = ml_part = None
        if d in SPLIT_DIMS:
            sms = torch.cuda.get_device_properties(q.device).multi_processor_count
            n_splits, per = split_plan(b * h, tq, tk, sms)
        if n_splits > 1:
            o_part = torch.empty(n_splits, b * h, tq, d, dtype=torch.float32, device=q.device)
            ml_part = torch.empty(n_splits, b * h, tq, 2, dtype=torch.float32, device=q.device)
        fn = _build.function("flash_attention", "flash_attention_bf16", [ctypes.c_void_p] * 7
                             + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2
                             + [ctypes.c_void_p])
        err = fn(*ptrs, None if o_part is None else o_part.data_ptr(),
                 None if ml_part is None else ml_part.data_ptr(),
                 b * h, h, tq, tk, d, d ** -0.5, n_splits, per, stream)
    _build.check(err, "flash_attention")
    _build.launch_counts["flash_attention"] += 1
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_op(q, k, v, mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, Tq, D]; k/v [B, H, Tk, D]; mask [B, Tk] bool (True = valid
    key) or None. Returns [B, H, Tq, D] in q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 with D in 32/64/96/128, or float32 with D <= 128: see `supports`)
    or raises. Where an input needs a gradient, the backward is the plain
    version's."""
    return with_plain_backward(_launch, flash_attention_plain, (q, k, v, mask))
