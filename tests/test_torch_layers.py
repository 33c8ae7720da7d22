"""The port's building blocks (diffnorm_tpu_torch/models/layers.py) against
their flax counterparts on shared weights and inputs, in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffnorm_tpu.models.layers as JL
from diffnorm_tpu_torch.models import layers as TL
from diffnorm_tpu_torch.weights import from_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(_np(x))


def _carry(module, variables):
    return from_jax_params(module, jax.tree_util.tree_map(np.asarray,
                                                          variables["params"]))


def test_l2norm_matches_flax():
    x = np.random.default_rng(0).normal(size=(2, 5, 16)).astype(np.float32)
    x[0, 0] = 0.0  # the eps floor
    np.testing.assert_allclose(TL.l2norm(_t(x)).numpy(), _np(JL.l2norm(x)), **TOL)


@pytest.mark.parametrize("form", ["scale", "film", "cond"])
def test_rms_norm_matches_flax(form):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    cond = rng.normal(size=(2, 12)).astype(np.float32)
    if form == "scale":
        jm, tm = JL.RMSNorm(dim=16), TL.RMSNorm(16)
        v = jm.init(jax.random.PRNGKey(0), x)
        v = {"params": {"gamma": rng.normal(size=16).astype(np.float32)}}
        ref, args = jm.apply(v, x), ()
    else:
        jm = JL.RMSNorm(dim=16, scale=False, cond_dim=12)
        tm = TL.RMSNorm(16, scale=False, cond_dim=12)
        v = jm.init(jax.random.PRNGKey(0), x, cond)
        ref = jm.apply(v, x, cond)
    _carry(tm, v)
    if form == "scale":
        got = tm(_t(x))
    elif form == "cond":
        got = tm(_t(x), cond=_t(cond))
    else:
        film = tm.film(_t(cond))
        np.testing.assert_allclose(
            film.detach().numpy(), _np(jm.apply(v, cond, method=jm.film)), **TOL)
        got = tm(_t(x), film=film)
    np.testing.assert_allclose(got.detach().numpy(), _np(ref), **TOL)


@pytest.mark.parametrize("dilation", [1, 4, 8])
def test_causal_conv_matches_flax(dilation):
    """T=6 is shorter than the receptive field: at dilation 4 the first tap
    is partly and at 8 wholly before the sequence."""
    rng = np.random.default_rng(dilation)
    x = rng.normal(size=(2, 6, 12)).astype(np.float32)
    jm = JL.CausalConv1d(features=10, kernel_size=3, dilation=dilation)
    v = jm.init(jax.random.PRNGKey(dilation), x)
    v = jax.tree_util.tree_map(lambda a: a + 0.1, v)  # non-zero bias
    tm = _carry(TL.CausalConv1d(12, 10, 3, dilation), v)
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(), _np(jm.apply(v, x)), **TOL)


def test_feedforward_causal_conv_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    jm = JL.FeedForward(dim=24, mult=4, causal_conv=True)
    v = jm.init(jax.random.PRNGKey(3), x)
    tm = _carry(TL.FeedForward(24, 4, causal_conv=True), v)
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(), _np(jm.apply(v, x)), **TOL)


def test_attention_with_fully_masked_row_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 9, 32)).astype(np.float32)
    mask = rng.random((3, 9)) > 0.3
    mask[0, 0] = True
    mask[1] = False  # fully masked: uniform attention, never NaN
    jm = JL.Attention(dim=32, dim_head=8, heads=2)
    v = jm.init(jax.random.PRNGKey(4), x, mask=mask)
    tm = _carry(TL.Attention(32, 8, 2), v)
    got = tm(_t(x), mask=torch.from_numpy(mask)).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _np(jm.apply(v, x, mask=mask)), **TOL)


def test_time_embedding_and_positions_match_flax():
    rng = np.random.default_rng(5)
    t = np.asarray([0.0, 3.0, 17.0, 49.0], np.float32)
    jm = JL.LearnedSinusoidalPosEmb(dim=16)
    v = jm.init(jax.random.PRNGKey(5), t)
    tm = _carry(TL.LearnedSinusoidalPosEmb(16), v)
    got = tm(_t(t)).detach().numpy()
    assert got.shape == (4, 17)
    np.testing.assert_allclose(got, _np(jm.apply(v, t)), **TOL)

    mask = rng.random((3, 20)) > 0.2
    for dim in (16, 15):
        np.testing.assert_allclose(
            TL.sinusoidal_positions(torch.from_numpy(mask), dim).numpy(),
            _np(JL.sinusoidal_positions(mask, dim)), **TOL)


def test_conditionable_transformer_precomputed_film_matches_flax():
    rng = np.random.default_rng(6)
    b, t, dim, cond_dim = 2, 10, 32, 24
    x = rng.normal(size=(b, t, dim)).astype(np.float32)
    cond = rng.normal(size=(b, cond_dim)).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[1, 7:] = False
    jm = JL.ConditionableTransformer(
        dim=dim, depth=2, dim_head=8, heads=2, ff_causal_conv=True,
        cond_dim=cond_dim, dropout=0.0)
    v = jm.init(jax.random.PRNGKey(6), x, cond=cond, mask=mask)
    film = jm.apply(v, cond, method=jm.precompute_film)
    ref = jm.apply(v, x, mask=mask, film=film)
    tm = _carry(TL.ConditionableTransformer(
        dim, 2, dim_head=8, heads=2, ff_causal_conv=True, cond_dim=cond_dim), v)
    with torch.no_grad():
        got = tm(_t(x), mask=torch.from_numpy(mask),
                 film=tm.precompute_film(_t(cond)))
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)
