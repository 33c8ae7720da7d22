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
