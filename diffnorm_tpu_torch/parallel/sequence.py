"""Sequence parallelism: ring attention over a "seq" axis of ranks (the
port's copy of diffnorm_tpu/parallel/sequence.py).

Activations split over time: each rank holds a [B, H, T/n, D] shard of q, k
and v, and attention runs as n ring steps of an online-softmax accumulation
while the K/V blocks rotate one rank on at each step (`mesh.ring_shift`:
send to the next rank and receive from the previous one, posted together).
Memory per rank is O(T/n x T/n) score tiles instead of O(T^2).

Everything is differentiable: the shift's backward is the reverse shift, so
the same functions train. k and v rotate as one stacked tensor, so every
rank's backward runs the shifts of one chain in one order. A rank whose
tensor a shift brings is not used (the halo at a sequence edge) still
depends on it through a zero factor, so the backward's shifts pair up on
every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from diffnorm_tpu_torch.models.conformer import rel_positional_encoding, rel_shift
from diffnorm_tpu_torch.parallel.mesh import (
    Axis,
    copy_in,
    gather_out,
    make_seq_mesh,  # noqa: F401 (JAX's sequence.make_seq_mesh, here too)
    ring_shift,
    split_in,
)

NEG = torch.finfo(torch.float32).min


def _probs_at_v(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p @ v in float32; bf16 v takes the probabilities rounded to bf16 (JAX's
    bf16 x bf16 -> f32 einsum: the products are exact in float32)."""
    if v.dtype == torch.bfloat16:
        return torch.matmul(p.to(torch.bfloat16).float(), v.float())
    return torch.matmul(p, v.float())


def _online_step(sim, m_c, v_c, run_max, run_sum, acc):
    """One block of the online softmax: sim [B, H, Tq, Tk] float32, m_c
    [B, Tk] the block's key mask."""
    keep = m_c[:, None, None, :]
    sim = torch.where(keep, sim, NEG)
    new_max = torch.maximum(run_max, sim.amax(dim=-1, keepdim=True))
    corr = torch.exp(run_max - new_max)
    # an explicit 0 at masked keys: exp(NEG - new_max) is 1 while new_max is
    # still NEG (a fully masked first block would pollute the sums)
    p = torch.where(keep, torch.exp(sim - new_max), 0.0)
    run_sum = run_sum * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + _probs_at_v(p, v_c)
    return new_max, run_sum, acc


def _finish(run_sum, acc, dtype):
    """A fully masked query row gives 0 (JAX sequence.py:122-125)."""
    out = torch.where(run_sum > 0.0, acc / torch.clamp(run_sum, min=1e-30), 0.0)
    return out.to(dtype)


def _ring(q_like, k, v, mask, axis: Axis, scores):
    """The ring loop: `scores(step, k_block)` -> float32 sim of the local
    queries against the block that arrived at `step`."""
    b, h, tl, d = v.shape
    if mask is None:
        mask = torch.ones(b, tl, dtype=torch.bool, device=v.device)
    run_max = torch.full((b, h, q_like.shape[2], 1), NEG, device=v.device)
    run_sum = torch.zeros((b, h, q_like.shape[2], 1), device=v.device)
    acc = torch.zeros((b, h, q_like.shape[2], d), device=v.device)
    kv, m_c = torch.stack([k, v]), mask
    for step in range(axis.size):
        run_max, run_sum, acc = _online_step(scores(step, kv[0]), m_c, kv[1], run_max,
                                             run_sum, acc)
        if step < axis.size - 1:  # the block for the next step, one rank on
            kv = ring_shift(kv, axis)
            m_c = axis.shift(m_c.to(torch.uint8)).bool()
    return run_sum, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, axis: Axis = None) -> torch.Tensor:
    """Attention over time-sharded q / k / v [B, H, Tl, D] (global T =
    n * Tl), mask [B, Tl] bool (True = a valid key) this rank's shard;
    returns this rank's shard of ops.attention.masked_attention's output
    (f32 softmax, bf16 probs @ v for bf16 v)."""
    qf = q.float() * q.shape[-1] ** -0.5
    run_sum, acc = _ring(qf, k, v, mask, axis,
                         lambda step, k_c: torch.matmul(qf, k_c.float().transpose(-1, -2)))
    return _finish(run_sum, acc, q.dtype)


def sequence_parallel_attention(q, k, v, mask=None, axis: Axis = None) -> torch.Tensor:
    """masked_attention of whole q / k / v [B, H, T, D] (T divisible by the
    axis) and mask [B, T], computed with time split over `axis`; the whole
    output on every rank (its gradient flows back to the whole inputs)."""
    t, n = q.shape[-2], axis.size
    if t % n:
        raise ValueError(f"sequence length {t} does not split over {n} ranks")
    q, k, v = (split_in(x, axis, 2) for x in (q, k, v))
    if mask is not None:
        lo = axis.index * (t // n)
        mask = mask[:, lo:lo + t // n]
    return gather_out(ring_attention(q, k, v, mask, axis), axis, 2)


def ring_rel_pos_attention(q_u, q_v, k, v, pos, mask=None, axis: Axis = None) -> torch.Tensor:
    """ESPnet rel-pos attention (the Transformer-XL bias) over time-sharded
    q / k / v, the sequence-parallel form of models/conformer.py
    RelPosSelfAttention.

    q_u, q_v: [B, H, Tl, d] the queries plus pos_bias_u / pos_bias_v; k, v:
    [B, H, Tl, d] this rank's shards; pos: [H, 2T - 1, d] the projected
    whole position table (row m is relative position T - 1 - m); mask:
    [B, Tl] the local key mask. Returns [B, H, Tl, d]: (ac + rel_shift(bd))
    / sqrt(d), softmax, @ v, to float32 reassociation."""
    n, r = axis.size, axis.index
    tl, d = k.shape[2], k.shape[3]
    t_global = (pos.shape[1] + 1) // 2
    scale = 1.0 / math.sqrt(d)
    q_u, q_v = q_u.float(), q_v.float()

    def scores(step, k_c):
        k_shard = (r - step) % n  # the block here at `step` left rank r - step
        d0 = (r - k_shard) * tl  # the queries' start less the keys' start
        p_s = pos[:, t_global - tl - d0:t_global - tl - d0 + 2 * tl - 1].float()
        ac = torch.matmul(q_u, k_c.float().transpose(-1, -2))
        bd = torch.matmul(q_v, p_s.transpose(-1, -2))
        return (ac + rel_shift(bd)) * scale

    run_sum, acc = _ring(q_u, k, v, mask, axis, scores)
    return _finish(run_sum, acc, k.dtype)


def halo_pad(x: torch.Tensor, left: int, right: int, axis: Axis) -> torch.Tensor:
    """x [B, Tl, C] -> [B, left + Tl + right, C]: the edge frames of the ring
    neighbours on either side; the ranks at the sequence's ends pad with
    zeros (the unsharded conv's zero padding). Runs a temporal conv (the
    conformer's depthwise conv) on a time shard."""
    tl = x.shape[1]
    if max(left, right) > tl:
        raise ValueError(f"a halo of {max(left, right)} frames is wider than the shard of "
                         f"{tl}: use fewer sequence shards")
    parts = []
    if left > 0:  # my last frames are the next rank's left halo
        parts.append(ring_shift(x[:, -left:], axis, 1) * float(axis.index != 0))
    parts.append(x)
    if right > 0:
        parts.append(ring_shift(x[:, :right], axis, -1) * float(axis.index != axis.size - 1))
    return torch.cat(parts, dim=1)


def conformer_encode_sp(encoder, src: torch.Tensor, src_lengths: torch.Tensor,
                        axis: Axis):
    """A models/conformer.py ConformerEncoder with its layer stack
    sequence-parallel over `axis`: the subsampler and input projection run
    whole on every rank (4x downsampled, cheap), then each rank runs the
    layers on its time shard (ring rel-pos attention, halo-exchanged
    depthwise conv). Returns the whole (features [B, T', C], mask [B, T'])
    on every rank, as `encoder(src, src_lengths)` gives them to float32
    reassociation. A T' the axis does not divide is padded (`conv_keep`
    zeroes the padded frames before each depthwise conv) and cut after.
    Differentiable: each layer parameter enters through `copy_in`, so its
    gradient sums the ranks' shards."""
    n = axis.size
    x, mask, pos = encoder.embed(src, src_lengths)
    t = x.shape[1]
    pad_t = (-t) % n
    keep = None
    if pad_t:
        x = F.pad(x, (0, 0, 0, pad_t))
        mask = F.pad(mask, (0, pad_t))
        pos = torch.from_numpy(rel_positional_encoding(t + pad_t, pos.shape[-1])).to(
            device=pos.device, dtype=pos.dtype)
        keep = (torch.arange(t + pad_t, device=x.device)[None, :] < t).expand(mask.shape)
    tl = (t + pad_t) // n
    lo = axis.index * tl
    x = split_in(x, axis, 1)
    mask_l = mask[:, lo:lo + tl]
    keep_l = keep[:, lo:lo + tl] if keep is not None else None
    for i in range(encoder.n_layers):
        layer = getattr(encoder, f"layer_{i}")
        args = (x, pos, mask_l, axis, keep_l)
        if torch.is_grad_enabled() and any(p.requires_grad for p in layer.parameters()):
            params = {name: copy_in(p, axis) for name, p in layer.named_parameters()}
            x = torch.func.functional_call(layer, params, args)
        else:
            x = layer(*args)
    out = gather_out(x, axis, 1)
    return out[:, :t], mask[:, :t]
