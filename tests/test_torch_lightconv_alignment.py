"""The port's lightconv / dynamicconv (ops/lightconv.py) and MMA expected
alignment (ops/alignment.py) against the JAX package on the CPU: the
convolutions causal and "same", softmax-normalized or not, float32 within
1e-5 and bf16 within 1e-2; the alignment with and without a padding mask,
and the port's host twin, within 1e-6 of JAX's expected_alignment_from_p_choose
and of JAX's C ABI host twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.ops import alignment as JA
from diffnorm_tpu.ops import lightconv as JL
from diffnorm_tpu_torch.ops import alignment as PA
from diffnorm_tpu_torch.ops import lightconv as PL
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

B, T, C, H, K = 2, 19, 16, 4, 7
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _jax(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(x: np.ndarray, dtype: str):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["causal", "same"])
@pytest.mark.parametrize("kind", ["lightconv", "dynamicconv"])
def test_convolutions_match_jax(kind, padding, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    shape = (H, K) if kind == "lightconv" else (B, T, H, K)
    w = rng.normal(size=shape).astype(np.float32)
    for normalize in (True, False):
        want = getattr(JL, kind)(_jax(x, dtype), jnp.asarray(w), padding=padding,
                                 softmax_normalize=normalize)
        got = getattr(PL, kind)(_torch(x, dtype), torch.from_numpy(w), padding=padding,
                                softmax_normalize=normalize)
        assert got.dtype == getattr(torch, dtype) and got.shape == (B, T, C)
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL[dtype], rtol=0)


def test_convolutions_against_a_direct_sum():
    """The window each padding reads, from the definition: causal
    out[t] = sum_k w[k] x[t - (K - 1) + k], same x[t - K // 2 + k]."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, T, C))
    w = rng.normal(size=(B, T, H, K))[:1]
    for padding, base in (("causal", -(K - 1)), ("same", -(K // 2))):
        got = PL.dynamicconv(torch.from_numpy(x), torch.from_numpy(w), padding=padding,
                             softmax_normalize=False).numpy()
        want = np.zeros_like(x)
        for t in range(T):
            for k in range(K):
                if 0 <= t + base + k < T:
                    want[0, t] += np.repeat(w[0, t, :, k], C // H) * x[0, t + base + k]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        PL.lightconv(torch.zeros(1, 4, 6), torch.zeros(4, 3))


def _p_choose(rng, b=3, tgt=9, src=13):
    return rng.uniform(0.0, 1.0, size=(b, tgt, src)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_expected_alignment_matches_jax(masked):
    rng = np.random.default_rng(2 + masked)
    p = _p_choose(rng)
    p[0, :, :3] = 1e-7  # the cumprod clamp at eps
    mask = None
    if masked:
        lengths = np.array([13, 7, 1])
        mask = np.arange(13)[None, :] >= lengths[:, None]
    want = np.asarray(JA.expected_alignment_from_p_choose(
        jnp.asarray(p), None if mask is None else jnp.asarray(mask)))
    got = PA.expected_alignment_from_p_choose(
        torch.from_numpy(p), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == p.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if masked:
        assert (got.numpy()[1, :, 7:] == 0).all()
    # the host twins, on the masked columns zeroed where a mask is given
    p_host = np.where(mask[:, None, :], 0.0, p).astype(np.float32) if masked else p
    jax_host = JA.expected_alignment_host(p_host)  # JAX's C ABI where it builds
    np.testing.assert_allclose(PA.expected_alignment_host(p_host), jax_host, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), jax_host, atol=1e-6, rtol=0)


def test_expected_alignment_keeps_its_type():
    p = _p_choose(np.random.default_rng(4), 2, 5, 6)
    got = PA.expected_alignment_from_p_choose(torch.from_numpy(p).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = PA.expected_alignment_host(torch.from_numpy(p).to(torch.bfloat16).float().numpy())
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=0)
