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
from diffnorm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain


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
