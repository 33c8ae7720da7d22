"""The port's flash attention on the CPU (its plain version) against the JAX
Pallas kernel in interpret mode, and the route from masked_attention. The
CUDA kernel itself is held to this plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.ops.attention import masked_attention as jax_masked_attention
from diffnorm_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops.attention import FLASH_MIN_LEN, masked_attention
from diffnorm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_plain_split,
    split_plan,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


def _inputs(seed, b, h, tq, tk, d, lengths):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32) for t in (tq, tk, tk))
    mask = np.arange(tk)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("tk, d", [(70, 64), (45, 96)])
def test_plain_matches_pallas_kernel(wide, tk, d):
    """Small blocks, Tk not a multiple of the key block, ragged masks (every
    row keeps a key), float32."""
    q, k, v, mask = _inputs(tk + d, 2, 2, 40, tk, d, [tk, tk // 3])
    mask[0, 5:9] = False
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, mask)), block_q=16,
                                         block_k=32, interpret=True, wide=wide))
    before = _build.launch_counts["flash_attention"]
    got = flash_attention(*map(torch.from_numpy, (q, k, v, mask)))
    assert _build.launch_counts["flash_attention"] == before  # CPU: no launch
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_fully_masked_row_is_the_mean_over_the_keys():
    """A row whose keys are all masked: the port gives masked_attention's
    uniform mean over the Tk keys. The JAX kernel pads Tk to its block and
    masks the padding like real keys, so it gives sum(v) / Tk_pad there
    (ROADMAP Queue 3); a port that padded the same way fails here."""
    tk, block_k = 70, 128
    q, k, v, mask = _inputs(3, 2, 2, 24, tk, 64, [tk, 0])
    mask[0, 10:30] = False
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    want = np.asarray(jax_masked_attention(*map(jnp.asarray, (q, k, v, mask))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                       got[1].shape), atol=1e-6)
    port_masked = masked_attention(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, port_masked, atol=1e-5, rtol=1e-5)

    jax_kernel = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, mask)),
                                                block_q=8, block_k=block_k, interpret=True))
    np.testing.assert_allclose(jax_kernel[0], got[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(jax_kernel[1], got[1] * tk / block_k, atol=1e-5, rtol=1e-5)


SPLIT_CASES = {  # n_splits, Tq, Tk, key lengths, keys masked per row ([start, stop) or None)
    "1 split": (1, 40, 70, [70, 23], None),
    "2 splits": (2, 40, 70, [70, 23], None),
    "3 splits, Tk not a multiple": (3, 40, 70, [70, 45], None),
    "5 splits, a short last split": (5, 24, 67, [67, 60], None),
    "a split whose keys are all masked": (2, 24, 64, [64, 64], [(32, 64), (0, 32)]),
    "a fully masked row": (3, 24, 64, [64, 0], None),
    "Tq = 1": (2, 1, 70, [70, 31], None),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES), ids=list(SPLIT_CASES))
def test_split_merge_matches_plain_and_pallas_kernel(case):
    """The kernel's split-key merge, in its plain form, against the one-pass
    plain version and the JAX kernel in interpret mode. block_k = Tk keeps
    the JAX kernel from padding the keys, so a fully masked row is the mean
    over the Tk keys there too."""
    n_splits, tq, tk, lengths, masked = SPLIT_CASES[case]
    q, k, v, mask = _inputs(n_splits * 100 + tq + tk, 2, 2, tq, tk, 64, lengths)
    for row, span in enumerate(masked or ()):
        mask[row, span[0]:span[1]] = False
    tq_, tk_, tv_, tm_ = map(torch.from_numpy, (q, k, v, mask))
    got = flash_attention_plain_split(tq_, tk_, tv_, tm_, n_splits).numpy()
    np.testing.assert_allclose(got, flash_attention_plain(tq_, tk_, tv_, tm_).numpy(),
                               atol=1e-5, rtol=1e-5)
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, mask)), block_q=8,
                                         block_k=tk, interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    if not mask[1].any():
        np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                           got[1].shape), atol=1e-6)


@pytest.mark.parametrize("bh, tq, tk", [(16, 256, 2112), (16, 256, 2100), (16, 4096, 4096),
                                        (16, 256, 1), (16, 256, 65), (1, 1, 70),
                                        (1, 64, 64 * 400)])
def test_split_plan_covers_the_keys_without_an_empty_range(bh, tq, tk):
    """The kernel's key ranges: contiguous runs of 64-key tiles that cover Tk,
    none starting at or past it, and a split only where the query tiles x
    B*H blocks are under two per SM of a 132-SM card."""
    n_splits, per = split_plan(bh, tq, tk, sms=132)
    tiles = -(-tk // 64)
    assert n_splits >= 1 and (n_splits - 1) * per < tiles <= n_splits * per
    blocks = -(-tq // 64) * bh
    if blocks >= 2 * 132:
        assert n_splits == 1
    else:  # ranges as long as cutting the tiles into the wanted count needs
        assert per == -(-tiles // min(tiles, -(-2 * 132 // blocks)))


def test_masked_attention_stays_plain_on_the_cpu_at_long_keys():
    q, k, v, mask = _inputs(4, 1, 2, 8, FLASH_MIN_LEN, 32, [FLASH_MIN_LEN - 100])
    before = _build.launch_counts["flash_attention"]
    got = masked_attention(*map(torch.from_numpy, (q, k, v, mask)))
    assert _build.launch_counts["flash_attention"] == before
    want = np.asarray(jax_masked_attention(*map(jnp.asarray, (q, k, v, mask))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_wrapper_launches_or_raises_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version."""
    x = torch.zeros(1, 2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(x, x, x, None)


# The float32 kernel's arithmetic (csrc/flash_attention.cu, attn_tf32_kernel)
# on the CPU: tf32 operands split into hi + lo, three passes per product.
KEY_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # V^T's keys in each group of 8
FLASH_RTOL, FLASH_ATOL = 2e-3, 2e-4  # chip_smoke.py's tolerance of the kernel


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 as cvt.rna.tf32.f32 rounds: add 0x1000 to the
    bits, clear the low 13."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with tf32 operands and float32 sums: one pass (tf32(a) tf32(b))
    or three (hi hi' + hi lo' + lo hi')."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if passes == 1:
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


def _tf32_attention(q, k, v, passes):
    """The kernel's computation at no mask: 64-key tiles, keys of each group
    of 8 in V^T's stored order, the online softmax in the log2 domain, P
    split like the operands."""
    tk, d = k.shape[2], q.shape[-1]
    order = torch.from_numpy((np.arange(tk) // 8 * 8 + KEY_ORDER[np.arange(tk) % 8]))
    k, v = k[:, :, order], v[:, :, order]
    scale_log2 = d ** -0.5 * np.log2(np.e)
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, tk, 64):
        s = _tf32_matmul(q, k[:, :, k0:k0 + 64].transpose(-1, -2), passes) * scale_log2
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _tf32_matmul(p, v[:, :, k0:k0 + 64], passes)
        m = m_new
    return o / l


@pytest.mark.parametrize("score_std", [1, 9])
def test_three_pass_tf32_keeps_float32_accuracy(score_std):
    """Three passes of tf32 per product hold the kernel's function to float32
    accuracy at HuBERT's head width: within 1e-5 of the output's scale of
    the float32 plain version, at score std 1 and 9."""
    rng = np.random.default_rng(score_std)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 1024, 64)).astype(np.float32))
               for _ in range(3))
    q, k = q * score_std ** 0.5, k * score_std ** 0.5
    ref = flash_attention_plain(q, k, v)
    got = _tf32_attention(q, k, v, passes=3)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


def test_one_pass_tf32_breaks_the_kernel_tolerance():
    """Why three passes: one tf32 pass per product (operands and P rounded
    to tf32 once) is off by far more than chip_smoke.py's tolerance of the
    kernel at score std 9."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 1024, 64)).astype(np.float32))
               for _ in range(3))
    q, k = q * 3, k * 3
    ref = flash_attention_plain(q, k, v)
    got = _tf32_attention(q, k, v, passes=1)
    assert ((got - ref).abs() > FLASH_ATOL + FLASH_RTOL * ref.abs()).sum() > 1000


def test_score_accumulators_feed_pv_as_a_fragments():
    """The P.V step's register mapping for one 64 x 64 tile: the wgmma
    accumulator layout of S (thread: rows g, g + 8 of its warp's 16; keys
    8 ni + 2 c, + 1), handed over as the tf32 A fragment of k-step ni
    (a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)) in the
    kernel's order (e = 0, 2, 1, 3), against V^T stored with the keys of
    each group of 8 as 0, 2, 4, 6, 1, 3, 5, 7, gives P V."""
    rng = np.random.default_rng(0)
    p, v = rng.normal(size=(64, 64)), rng.normal(size=(64, 32))
    vt = v.T[:, np.arange(64) // 8 * 8 + KEY_ORDER[np.arange(64) % 8]]  # stored V^T
    a = np.full((64, 64), np.nan)  # the A operand the tensor cores read, [row, k index]
    for warp in range(4):
        for lane in range(32):
            g, c = lane // 4, lane % 4
            for ni in range(8):
                sc = [p[16 * warp + g + 8 * (e // 2), 8 * ni + 2 * c + e % 2] for e in range(4)]
                regs = [sc[0], sc[2], sc[1], sc[3]]
                for j, (row, col) in enumerate([(g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4)]):
                    a[16 * warp + row, 8 * ni + col] = regs[j]
    np.testing.assert_allclose(a @ vt.T, p @ v, rtol=1e-12, atol=1e-12)


def _rz_matmul(a_parts, b_parts, acc):
    """acc + the sum of a_i @ b_j over the passes (i, j) = (hi, lo'), (lo,
    hi'), (hi, hi') in that order, k-steps of 8 products each added exactly
    and the sum truncated to float32, as a model of the tensor cores'
    accumulation. float64 holds the tf32 products exactly."""
    for i, j in ((0, 1), (1, 0), (0, 0)):
        for k0 in range(0, a_parts[i].shape[-1], 8):
            x = acc + a_parts[i][..., k0:k0 + 8] @ b_parts[j][k0:k0 + 8]
            f = x.float()
            over = f.double().abs() > x.abs()
            f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
            acc = f.double()
    return acc


def test_pv_per_tile_bounds_the_truncated_accumulation():
    """Why the kernel adds each tile's P V to its output in float32 rather
    than leaving it in the tensor cores' accumulators: with every k-step's
    sum truncated, a sum over all the keys in place drifts by about half an
    ulp a step where the terms share a sign (HuBERT's frames are alike), and
    the drift grows with the keys; a fresh sum per 64-key tile added with
    rounding to nearest stays at float32 accuracy."""
    rng = np.random.default_rng(0)
    tk, d = 2048, 64
    p = torch.from_numpy(rng.uniform(0.5, 1.0, size=(16, tk)).astype(np.float32))
    v = torch.from_numpy((1.0 + 0.1 * rng.normal(size=(tk, d))).astype(np.float32))
    ref = p.double() @ v.double()
    ps = [t.double() for t in _split(p)]
    vs = [t.double() for t in _split(v)]
    in_place = torch.zeros(16, d, dtype=torch.float64)
    per_tile = torch.zeros(16, d, dtype=torch.float32)
    for k0 in range(0, tk, 64):
        tile = [t[:, k0:k0 + 64] for t in ps], [t[k0:k0 + 64] for t in vs]
        in_place = _rz_matmul(*tile, in_place)
        per_tile = per_tile + _rz_matmul(*tile, torch.zeros_like(in_place)).float()
    scale = ref.abs().max()
    assert ((in_place - ref).abs().max() / scale).item() > 1e-5
    assert ((per_tile.double() - ref).abs().max() / scale).item() < 2e-6
