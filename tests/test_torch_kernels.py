"""The port's kernel modules on the CPU (their plain versions) against the
JAX Pallas kernels in interpret mode, and the port's WaveNet against the JAX
module path with non-zero biases and gamma != 1. The CUDA kernels themselves
are checked against these plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.models.wavenet import Wavenet as JWavenet
from diffnorm_tpu.ops.pallas_norm import rms_norm_film as jax_rms_norm_film
from diffnorm_tpu.ops.pallas_wavenet import wavenet_chain as jax_wavenet_chain
from diffnorm_tpu_torch.models.layers import RMSNorm
from diffnorm_tpu_torch.models.wavenet import Wavenet
from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops.norm import rms_norm_film, rms_norm_film_plain
from diffnorm_tpu_torch.ops.wavenet_chain import wavenet_chain
from diffnorm_tpu_torch.weights import from_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


def test_rms_norm_film_matches_pallas_kernel():
    rng = np.random.default_rng(5)
    b, t, c = 2, 8, 128
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    film = rng.normal(size=(b, 2 * c)).astype(np.float32)
    ref = np.asarray(jax_rms_norm_film(jnp.asarray(x), jnp.asarray(film),
                                       interpret=True))
    before = _build.launch_counts["rms_norm_film"]
    got = rms_norm_film(torch.from_numpy(x), torch.from_numpy(film))
    assert _build.launch_counts["rms_norm_film"] == before  # CPU: no launch
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_rms_norm_module_agrees_with_plain_kernel_math():
    """The FiLM RMSNorm module path (CPU) and the kernel's arithmetic are the
    same function."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32))
    film = torch.from_numpy(rng.normal(size=(3, 128)).astype(np.float32))
    norm = RMSNorm(64, scale=False, cond_dim=8)
    np.testing.assert_allclose(norm(x, film=film).detach().numpy(),
                               rms_norm_film_plain(x, film).numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 4, 16])
def test_wavenet_chain_matches_pallas_kernel(dilation):
    """Identical packed inputs to both; dilation 16 = T leaves only the
    unshifted tap, as the denoiser's chain 7 does at T=128."""
    rng = np.random.default_rng(dilation)
    b, t, c, s, k = 2, 16, 32, 2, 3
    f32 = np.float32
    x = rng.normal(size=(b, t, c)).astype(f32)
    w_conv = (rng.normal(size=(s, k, c, c)) / np.sqrt(k * c)).astype(f32)
    w_res = (rng.normal(size=(s, c, c)) / np.sqrt(c)).astype(f32)
    w_skip = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(f32)
    b_res = rng.normal(size=(s, c)).astype(f32) * 0.3
    b_skip = rng.normal(size=(c,)).astype(f32) * 0.3
    gamma = (1.0 + 0.5 * rng.normal(size=(b, s, c))).astype(f32)
    beta = rng.normal(size=(b, s, c)).astype(f32) * 0.3

    biases = np.zeros((s, 2 * c), f32)
    biases[:, :c] = b_res
    biases[-1, c:] = b_skip
    biases8 = np.broadcast_to(biases[:, None], (s, 8, 2 * c))
    film8 = np.broadcast_to(np.concatenate([gamma, beta], -1)[:, :, None],
                            (b, s, 8, 2 * c))
    ref = np.asarray(jax_wavenet_chain(
        *map(jnp.asarray, (x, w_conv, w_res, w_skip, biases8, film8)),
        dilation=dilation, interpret=True))
    # the port takes every weight as [out, in], the JAX kernel as [in, out]
    got = wavenet_chain(*map(torch.from_numpy, (
        x, np.ascontiguousarray(w_conv.transpose(0, 1, 3, 2)),
        np.ascontiguousarray(w_res.transpose(0, 2, 1)), np.ascontiguousarray(w_skip.T),
        b_res, b_skip, gamma, beta)), dilation=dilation)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)


def _shift_biases(tree, delta):
    """Every conv / Dense bias of a params tree plus `delta` (numpy)."""
    return {k: _shift_biases(a, delta) if isinstance(a, dict)
            else np.asarray(a) + (delta if k == "bias" else 0.0)
            for k, a in tree.items()}


@pytest.mark.parametrize("cond", [12, None])
def test_wavenet_matches_jax_module_with_biases_and_film(cond):
    """The port folds the conv bias as beta + gamma * b_conv and so follows
    the module, (conv(x) + b) * gamma + beta, with non-zero biases and
    gamma != 1: the case an init-time comparison (all biases zero) misses."""
    rng = np.random.default_rng(0)
    b, t, dim = 2, 16, 32
    x = rng.normal(size=(b, t, dim)).astype(np.float32)
    args = (x,) if cond is None else (
        x, rng.normal(size=(b, cond)).astype(np.float32))
    jm = JWavenet(dim=dim, stacks=2, layers=3, cond_dim=cond)
    v = jm.init(jax.random.PRNGKey(0), *args)
    params = _shift_biases(v["params"], 0.3)
    ref = np.asarray(jm.apply({"params": params}, *args))

    tm = from_jax_params(Wavenet(dim, dim, 2, 3, cond_dim=cond), params)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
