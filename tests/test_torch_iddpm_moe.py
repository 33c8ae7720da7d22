"""The IDDPM toolkit and the BASE MoE layer in the port against the JAX
package on the CPU, float32: `space_timesteps` and the respaced float64
tables equal; q_sample, q_posterior, p_mean_variance (three mean and three
variance types), vb_term, ddim_step, ddim_reverse_step, training_losses
(four loss types), prior_bpd, and the three loops on JAX's own noises, over
one denoise_fn written in both, within 1e-5 (TOL); create_diffusion's
defaults. `balanced_assignment_host` equal to JAX's (its native library) on
random and strong-preference scores, `sinkhorn_routing` equal on random and
tied scores, and `BaseLayer` within 1e-5 on shared weights, whose expert
parameters keep JAX's layouts.

JAX's loops draw their noises inside a lax.scan; the tests draw the same
numbers from the same keys (split, or folded for calc_bpd_loop) and hand
them to the port's `noise`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.models import gaussian_diffusion as jgd
from diffnorm_tpu.models import moe as jmoe
from diffnorm_tpu_torch.models import gaussian_diffusion as gd
from diffnorm_tpu_torch.models import moe
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_params, to_jax_params
from tests.test_torch_sedd import _close, _perturbed
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

TOL = 1e-5
SHAPE = (3, 5, 4)  # N, T, C
MEANS, VARS = ("eps", "x_start", "prev_x"), ("fixed_small", "fixed_large", "learned_range")


def test_respacing_and_tables_match_jax():
    for n, counts in ((1000, "ddim25"), (100, "10,15"), (100, "7"), (40, ""), (100, [3, 5])):
        assert gd.space_timesteps(n, counts) == jgd.space_timesteps(n, counts)
    for schedule, respacing in (("linear", "ddim25"), ("cosine", "10,5"), ("linear", "")):
        got = gd.GaussianDiffusion.create(100, schedule, respacing)
        want = jgd.GaussianDiffusion.create(100, schedule, respacing)
        for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_recipm1_ac",
                     "posterior_variance", "posterior_log_variance_clipped",
                     "posterior_mean_coef1", "posterior_mean_coef2"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        if respacing:
            t = torch.arange(got.num_timesteps, dtype=torch.int32)
            np.testing.assert_array_equal(got.map_t(t).numpy(),
                                          np.asarray(want.map_t(jnp.asarray(t.numpy()))))
    (got, cfg), (want, jcfg) = gd.create_diffusion(), jgd.create_diffusion()
    assert cfg == jcfg and got.num_timesteps == 1000
    np.testing.assert_array_equal(got.betas, want.betas)
    for kw in (dict(learn_sigma=False, timestep_respacing="ddim25"), dict(use_kl=True),
               dict(sigma_small=True, learn_sigma=False, predict_xstart=True)):
        assert gd.create_diffusion(**kw)[1] == jgd.create_diffusion(**kw)[1]


def _inputs(seed, channels=SHAPE[2]):
    """x0 on the decoder likelihood's grid (multiples of 1/255 in [-1, 1]),
    a model output, a noise."""
    rng = np.random.default_rng(seed)
    x0 = (np.round(np.tanh(rng.normal(size=SHAPE)) * 255) / 255).astype(np.float32)
    out = rng.normal(size=SHAPE[:2] + (channels,)).astype(np.float32)
    noise = rng.normal(size=SHAPE).astype(np.float32)
    return x0, out, noise


def test_step_functions_match_jax():
    got, want = gd.GaussianDiffusion.create(50, "linear", "10"), \
        jgd.GaussianDiffusion.create(50, "linear", "10")
    T = torch.from_numpy
    t = np.asarray([0, 4, 9], np.int32)
    x0, _, noise = _inputs(0)
    # x_t drawn from q(x_t | x0), as training_losses and calc_bpd_loop draw
    # it: at t = 0 the discretized decoder term is ill-conditioned for an
    # x_t far from x0 (its CDF differences cancel, and XLA's and torch's
    # float32 tanh differ in the last bits there)
    x_t = np.asarray(want.q_sample(x0, t, noise))
    _close(got.q_sample(T(x0), T(t), T(noise)), want.q_sample(x0, t, noise), TOL)
    for a, b in zip(got.q_posterior(T(x0), T(x_t), T(t)), want.q_posterior(x0, x_t, t)):
        _close(a, b, TOL)
    _close(got.prior_bpd(T(x0)), want.prior_bpd(x0), TOL)
    for var in VARS:
        _, out_v, _ = _inputs(1, 2 * SHAPE[2] if var == "learned_range" else SHAPE[2])
        out_v = np.tanh(out_v)
        for mean in MEANS:
            for clip in (False, True):
                for a, b in zip(got.p_mean_variance(T(out_v), T(x_t), T(t), mean, var, clip),
                                want.p_mean_variance(out_v, x_t, t, mean, var, clip)):
                    _close(a, b, TOL)
            for freeze in (True, False):
                _close(got.vb_term(T(out_v), T(x0), T(x_t), T(t), mean, var, freeze_mean=freeze),
                       want.vb_term(out_v, x0, x_t, t, mean, var, freeze_mean=freeze), TOL)
            for a, b in zip(got.ddim_step(T(out_v), T(x_t), T(t), T(noise), mean, var, eta=0.5),
                            want.ddim_step(out_v, x_t, t, noise, mean, var, eta=0.5)):
                _close(a, b, TOL)
            _close(got.ddim_reverse_step(T(out_v), T(x_t), T(t), mean, var),
                   want.ddim_reverse_step(out_v, x_t, t, mean, var), TOL)


def _denoisers(channels_out):
    """One denoise_fn(x, t) in torch and in JAX: h = tanh(x W + 0.01 t);
    the mean head x + 0.05 h (near the identity, so at t = 0 the model's
    mean lies within a few standard deviations of x0, where the
    discretized decoder term is well conditioned: far off, it is the log of
    a difference of two saturated CDFs within a float32 ulp of 0, where
    XLA's and torch's tanh differ by an ulp), and the learned_range
    variance head h itself."""
    w = np.random.default_rng(5).normal(size=(SHAPE[2], channels_out)).astype(np.float32)
    c = SHAPE[2]

    def torch_fn(x, t):
        h = torch.tanh(x @ torch.from_numpy(w) + 0.01 * t.float()[:, None, None])
        return torch.cat([x + 0.05 * h[..., :c], h[..., c:]], dim=-1)

    def jax_fn(x, t):
        h = jnp.tanh(x @ w + 0.01 * t.astype(jnp.float32)[:, None, None])
        return jnp.concatenate([x + 0.05 * h[..., :c], h[..., c:]], axis=-1)

    return torch_fn, jax_fn


@pytest.mark.parametrize("loss_type", ["mse", "rescaled_mse", "kl", "rescaled_kl"])
def test_training_losses_match_jax(loss_type):
    got, want = gd.GaussianDiffusion.create(40, "cosine", "ddim8"), \
        jgd.GaussianDiffusion.create(40, "cosine", "ddim8")
    x0, _, noise = _inputs(2)
    t = np.asarray([0, 3, 7], np.int32)
    for mean, var in (("eps", "learned_range"), ("x_start", "fixed_large"),
                      ("prev_x", "learned_range")):
        fn, jfn = _denoisers(2 * SHAPE[2] if var == "learned_range" else SHAPE[2])
        losses, x_t = got.training_losses(fn, torch.from_numpy(x0), torch.from_numpy(t),
                                          loss_type, mean, var, noise=torch.from_numpy(noise))
        jlosses, jx_t = want.training_losses(jfn, x0, t, None, loss_type, mean, var,
                                             noise=noise)
        assert set(losses) == set(jlosses)
        for k in losses:
            _close(losses[k], jlosses[k], TOL)
        _close(x_t, jx_t, TOL)


def _loop_noises(key, steps):
    """p_sample_loop's and ddim_sample_loop's start and per-step noises."""
    r0, r = jax.random.split(key)
    out = [jax.random.normal(r0, SHAPE)]
    for _ in range(steps):
        r, rn = jax.random.split(r)
        out.append(jax.random.normal(rn, SHAPE))
    return [torch.from_numpy(np.asarray(z)) for z in out]


def test_loops_match_jax():
    got, want = gd.GaussianDiffusion.create(30, "linear", "6"), \
        jgd.GaussianDiffusion.create(30, "linear", "6")
    key = jax.random.PRNGKey(11)
    noises = _loop_noises(key, got.num_timesteps)
    for var in ("fixed_small", "learned_range"):
        fn, jfn = _denoisers(2 * SHAPE[2] if var == "learned_range" else SHAPE[2])
        _close(got.p_sample_loop(fn, SHAPE, model_var_type=var, noise=noises),
               want.p_sample_loop(jfn, SHAPE, key, model_var_type=var), TOL)
        _close(got.ddim_sample_loop(fn, SHAPE, model_var_type=var, eta=0.3, noise=noises),
               want.ddim_sample_loop(jfn, SHAPE, key, model_var_type=var, eta=0.3), TOL)
    x0, _, _ = _inputs(3)
    bpd_noise = [torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(0), i), SHAPE))) for i in range(got.num_timesteps)]
    fn, jfn = _denoisers(2 * SHAPE[2])
    out = got.calc_bpd_loop(fn, torch.from_numpy(x0), noise=bpd_noise)
    ref = want.calc_bpd_loop(jfn, x0)
    for k in ("total_bpd", "prior_bpd", "vb", "mse"):
        _close(out[k], ref[k], TOL)
    g = torch.Generator().manual_seed(0)  # the port's own draws run the same loop
    assert torch.isfinite(got.ddim_sample_loop(fn, SHAPE, model_var_type="learned_range",
                                               generator=g)).all()


def test_balanced_assignment_host_matches_jax():
    rng = np.random.default_rng(12)
    strong = np.full((16, 4), -10.0, np.float32)
    for i in range(4):
        strong[4 * i:4 * i + 4, 3 - i] = 10.0
    for scores in (rng.normal(size=(64, 8)).astype(np.float32),
                   rng.normal(size=(24, 6)).astype(np.float32),
                   np.round(rng.normal(size=(32, 4)), 1).astype(np.float32),  # ties
                   strong):
        got = moe.balanced_assignment_host(scores)
        np.testing.assert_array_equal(got, jmoe.balanced_assignment_host(scores))
        e = scores.shape[1]
        np.testing.assert_array_equal(np.bincount(got, minlength=e),
                                      [len(scores) // e] * e)
    np.testing.assert_array_equal(moe.balanced_assignment_host(strong),
                                  np.repeat([3, 2, 1, 0], 4))


def test_sinkhorn_routing_matches_jax():
    rng = np.random.default_rng(13)
    for scores in (rng.normal(size=(64, 8)), np.zeros((16, 4)),  # all tied
                   np.round(rng.normal(size=(48, 6)), 1)):
        scores = scores.astype(np.float32)
        got = moe.sinkhorn_routing(torch.from_numpy(scores)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmoe.sinkhorn_routing(
            jnp.asarray(scores))))
        e = scores.shape[1]
        np.testing.assert_array_equal(np.bincount(got, minlength=e), [len(scores) // e] * e)


def test_base_layer_matches_jax():
    dim, ffn, e, n = 8, 16, 4, 32
    layer = jmoe.BaseLayer(dim=dim, ffn_dim=ffn, num_experts=e)
    x = jnp.asarray(np.random.default_rng(14).normal(size=(n, dim)), jnp.float32)
    want = jax.eval_shape(lambda: layer.init(jax.random.PRNGKey(0), x))["params"]
    torch.manual_seed(0)
    params = to_jax_params(moe.BaseLayer(dim, ffn, e))
    assert ({k: tuple(np.shape(v)) for k, v in flatten_tree(params).items()}
            == {k: tuple(v.shape) for k, v in flatten_tree(want).items()}
            == {("expert_centroids",): (e, dim), ("experts_w1",): (e, dim, ffn),
                ("experts_w2",): (e, ffn, dim)})
    params = _perturbed(params, np.random.default_rng(15))
    model = from_jax_params(moe.BaseLayer(dim, ffn, e), params)
    np.testing.assert_array_equal(model.experts_w1.detach().numpy(), params["experts_w1"])
    with torch.no_grad():
        out = model(torch.from_numpy(np.asarray(x)))
    _close(out, layer.apply({"params": params}, x), TOL)
