"""The port's prompt-conditioned denoiser (diffnorm_tpu_torch/models/
{layers,diffusion}.py: cross-attention, PerceiverResampler, the
conditioned Denoiser with classifier-free dropout and guidance,
LatentDiffusionModule(use_cond)) and its fairseq map, against the JAX
package on shared weights, in float32 on the CPU, at the tolerances of
tests/test_prompt_cond.py and tests/test_convert_vae_diffusion.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.models.diffusion import Denoiser as JDenoiser
from diffnorm_tpu.models.diffusion import LatentDiffusionModule as JLatentDiffusionModule
from diffnorm_tpu.models.diffusion import PerceiverResampler as JPerceiverResampler
from diffnorm_tpu.models.layers import ConditionableTransformer as JTransformer
from diffnorm_tpu.utils import convert_weights as jcw
from diffnorm_tpu_torch.models.diffusion import (
    Denoiser,
    LatentDiffusionModule,
    PerceiverResampler,
    ddim_sample,
)
from diffnorm_tpu_torch.models.layers import ConditionableTransformer
from diffnorm_tpu_torch.utils import convert_weights as cw
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_prompt_cond.py
DECODED_TOL = 1e-3  # decoded features, tests/test_convert_vae_diffusion.py:385-390
DEN = dict(dim=16, latent_dim=3, depth=1, dim_head=8, heads=2, wavenet_layers=2,
           wavenet_stacks=1)
PROMPT = dict(condition_on_prompt=True, dim_prompt=24, num_latents_m=4, resampler_depth=1)
B, T, TP = 3, 6, 5


def _perturbed(params, seed):
    """The params with every leaf moved by a seeded 0.05-scale normal draw
    (biases, null embeddings and gammas away from their init)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, 3)).astype(np.float32)
    times = np.asarray([3.0, 7.0, 11.0], np.float32)
    mask = np.ones((B, T), bool)
    mask[2, 4:] = False
    prompt = rng.normal(size=(B, TP, 24)).astype(np.float32)
    prompt_mask = np.ones((B, TP), bool)
    prompt_mask[1, 3:] = False
    prompt_mask[2, 1:] = False
    return x, times, mask, prompt, prompt_mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def denoisers():
    """The JAX conditioned Denoiser with perturbed params, and the port's
    carrying them, in eval mode."""
    jden = JDenoiser(**DEN, **PROMPT)
    x, times, mask, prompt, pm = _inputs()
    v = jax.jit(lambda: jden.init({"params": jax.random.PRNGKey(0)}, x, times, mask,
                                  prompt=prompt, prompt_mask=pm))()
    params = _perturbed(v["params"], 1)
    port = from_jax_params(Denoiser(**DEN, **PROMPT), params).eval()
    return jden, params, port


def test_perceiver_resampler_with_ragged_prompt_masks():
    jm = JPerceiverResampler(dim=16, depth=2, dim_context=24, num_latents=4, dim_head=8,
                             heads=2)
    _, _, _, prompt, pm = _inputs(2)
    params = _perturbed(jax.jit(lambda: jm.init(jax.random.PRNGKey(3), prompt, pm))()["params"],
                        4)
    want = jax.jit(lambda p: jm.apply({"params": p}, prompt, pm))(params)
    port = from_jax_params(PerceiverResampler(16, 2, 24, 4, 8, 2), params).eval()
    got = port(*_t(prompt, pm))
    assert got.shape == (B, 4, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the masked prompt frames do not reach the tokens
    moved = prompt.copy()
    moved[~pm] += 5.0
    np.testing.assert_allclose(port(*_t(moved, pm)).detach().numpy(), got.detach().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_cross_attention_transformer():
    jm = JTransformer(dim=16, depth=2, dim_head=8, heads=2, ff_causal_conv=True,
                      cond_dim=32, cross_attn=True)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, 16)).astype(np.float32)
    cond = rng.normal(size=(B, 32)).astype(np.float32)
    ctx = rng.normal(size=(B, 4, 16)).astype(np.float32)
    _, _, mask, _, _ = _inputs()
    params = _perturbed(
        jax.jit(lambda: jm.init(jax.random.PRNGKey(6), x, cond, mask, ctx))()["params"], 7)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, cond, mask, ctx))(params)
    port = from_jax_params(ConditionableTransformer(16, 2, 8, 2, ff_causal_conv=True,
                                                    cond_dim=32, cross_attn=True), params).eval()
    got = port(*_t(x), cond=torch.from_numpy(cond), mask=torch.from_numpy(mask),
               context=torch.from_numpy(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the precomputed FiLM (with its "cross" entries) gives the same output
    film = port.precompute_film(torch.from_numpy(cond))
    assert set(film) == {"attn", "cross", "ff"} and port.route(film) == "module"
    again = port(*_t(x), mask=torch.from_numpy(mask), film=film, context=torch.from_numpy(ctx))
    np.testing.assert_allclose(again.detach().numpy(), got.detach().numpy(), rtol=1e-6,
                               atol=1e-6)


def test_conditioned_denoiser_drop_0_1_and_an_injected_mix(denoisers):
    jden, params, port = denoisers
    x, times, mask, prompt, pm = _inputs()
    outs = {}
    japply = jax.jit(lambda p: jden.apply({"params": params}, x, times, mask, prompt=prompt,
                                          prompt_mask=pm, cond_drop_prob=p), static_argnums=0)
    for p in (0.0, 1.0):
        want = japply(p)
        got = port(*_t(x, times, mask), prompt=torch.from_numpy(prompt),
                   prompt_mask=torch.from_numpy(pm), cond_drop_prob=p)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        outs[p] = np.asarray(want)
    drop = np.asarray([True, False, True])
    got = port(*_t(x, times, mask), prompt=torch.from_numpy(prompt),
               prompt_mask=torch.from_numpy(pm), cond_drop=torch.from_numpy(drop))
    for row, dropped in enumerate(drop):
        np.testing.assert_allclose(got[row].detach().numpy(), outs[float(dropped)][row],
                                   rtol=RTOL, atol=ATOL)
    # a drawn drop is a draw of the generator it is given, and needs one
    g = torch.Generator().manual_seed(0)
    want_drop = torch.rand(B, generator=torch.Generator().manual_seed(0)) < 0.5
    drawn = port(*_t(x, times, mask), prompt=torch.from_numpy(prompt),
                 prompt_mask=torch.from_numpy(pm), cond_drop_prob=0.5, generator=g)
    for row in range(B):
        np.testing.assert_allclose(drawn[row].detach().numpy(),
                                   outs[float(want_drop[row])][row], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="generator"):
        port(*_t(x, times, mask), prompt=torch.from_numpy(prompt), cond_drop_prob=0.5)
    with pytest.raises(ValueError, match="prompt"):
        port(*_t(x, times, mask))


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_forward_with_cond_scale(denoisers, scale):
    jden, params, port = denoisers
    x, times, mask, prompt, pm = _inputs(8)
    want = jax.jit(lambda: jden.apply({"params": params}, x, times, mask, prompt=prompt,
                                      prompt_mask=pm, cond_scale=scale,
                                      method=JDenoiser.forward_with_cond_scale))()
    got = port.forward_with_cond_scale(*_t(x, times, mask), prompt=torch.from_numpy(prompt),
                                       prompt_mask=torch.from_numpy(pm), cond_scale=scale)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


TINY = dict(dim=16, latent_dim=3, feature_dim=24, vocab_size=20, timesteps=20,
            denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, vae_decoder_depth=1,
            vae_decoder_dim_head=8, vae_decoder_heads=2, chan_mults=(4,))


@pytest.fixture(scope="module")
def cond_models():
    jm = JLatentDiffusionModule(**TINY, use_cond=True)
    x, _, mask, prompt, pm = _inputs()
    feature = np.random.default_rng(9).normal(size=(B, T, 24)).astype(np.float32)
    v = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(10), "cg": jax.random.PRNGKey(11)},
                                feature, mask, jax.random.PRNGKey(12), prompt=prompt,
                                prompt_mask=pm))()
    params = _perturbed(v["params"], 13)
    port = from_jax_params(LatentDiffusionModule(**TINY, use_cond=True), params).eval()
    return jm, params, port


def test_use_cond_training_forward_with_injected_draws(cond_models, monkeypatch):
    """The training forward (drop probability 0.1) with its times, noises
    and per-row drop injected: JAX's drop is its "cg" bernoulli draw, set
    here to the injected mask."""
    jm, params, port = cond_models
    rng = np.random.default_rng(14)
    _, _, mask, prompt, pm = _inputs()
    feature = rng.normal(size=(B, T, 24)).astype(np.float32)
    draws = dict(times=np.asarray([1, 9, 17], np.int32),
                 **{k: rng.normal(size=(B, T, 3)).astype(np.float32)
                    for k in ("enc_noise", "x1_noise", "q_noise")})
    drop = np.asarray([False, True, False])
    bernoulli = jax.random.bernoulli

    def fixed_drop(key, p=0.5, shape=None):
        if shape == (B,) and p == pytest.approx(0.1):
            return jnp.asarray(drop)
        return bernoulli(key, p, shape)

    monkeypatch.setattr(jax.random, "bernoulli", fixed_drop)
    want = jax.jit(lambda: jm.apply({"params": params}, feature, mask, jax.random.PRNGKey(15),
                                    deterministic=True, prompt=prompt, prompt_mask=pm,
                                    rngs={"cg": jax.random.PRNGKey(16)}, **draws))()
    got = port(torch.from_numpy(feature), torch.from_numpy(mask),
               prompt=torch.from_numpy(prompt), prompt_mask=torch.from_numpy(pm),
               cond_drop=torch.from_numpy(drop), **{k: torch.from_numpy(v)
                                                     for k, v in draws.items()})
    for key in ("pred_noise", "true_noise", "loss_weight"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for key in ("recon_feature", "lm_logits"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   rtol=DECODED_TOL, atol=DECODED_TOL, err_msg=key)
    # the model's draw takes its cg_generator, which the trainer sets
    port.cg_generator = torch.Generator().manual_seed(1)
    port(torch.from_numpy(feature), torch.from_numpy(mask), prompt=torch.from_numpy(prompt),
         **{k: torch.from_numpy(v) for k, v in draws.items()})
    port.cg_generator = None


def test_ddim_sample_refuses_a_conditioned_model(cond_models):
    _, _, port = cond_models
    with pytest.raises(ValueError, match="prompt-conditioned"):
        ddim_sample(port, torch.zeros(1, 4, 24), torch.ones(1, 4, dtype=torch.bool),
                    start_step=3, device="cpu")
    with pytest.raises(ValueError, match="per step"):
        port.precompute_step_conds(torch.ones(2, 1))


def _fairseq_conditioned_state(seed):
    """A fairseq diff_discrete state dict whose denoiser is prompt-conditioned,
    from the torch reference modules of tests/test_convert_vae_diffusion.py."""
    from tests.test_convert_vae_diffusion import TVAE, TDenoiser

    torch.manual_seed(seed)
    tden = TDenoiser(32, 8, prompt=True)
    tvae = TVAE(48, (3,))
    sd = {f"encoder.model.{k}": v for k, v in tden.state_dict().items()}
    sd.update({f"encoder.speech_decoder.{k}": v for k, v in tvae.state_dict().items()})
    return sd, tden


def test_fairseq_map_of_a_conditioned_denoiser(tmp_path):
    """Both packages' maps of a prompt-conditioned fairseq normalizer are
    equal bit for bit and pass the key-inventory audit; cli.convert_checkpoint
    writes that tree, and the port's Denoiser loaded from it equals JAX's
    converted forward (and the torch reference) at drop 0 and 1."""
    from diffnorm_tpu_torch.cli import convert_checkpoint
    from diffnorm_tpu_torch.train.checkpoint import load_params

    sd, tden = _fairseq_conditioned_state(17)
    got, want = cw.convert_diffusion_state(sd), jcw.convert_diffusion_state(sd)
    flat_got, flat_want = flatten_tree(got), flatten_tree(want)
    assert sorted(flat_got) == sorted(flat_want)
    assert ("denoiser", "perceiver_resampler", "latents") in flat_got
    assert ("denoiser", "transformer", "cross_attn_1", "to_kv", "kernel") in flat_got
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg="/".join(k))
    cw.conversion_inventory(sd, got)
    torch.save({"model": sd}, tmp_path / "cond.pt")
    out = tmp_path / "cond_dir"
    assert convert_checkpoint.main(["--type", "diffusion", "--input", str(tmp_path / "cond.pt"),
                                    "--output", str(out)]) == 0
    params = load_params(str(out))["denoiser"]
    widths = dict(dim=32, latent_dim=8, depth=2, dim_head=8, heads=2, wavenet_layers=2,
                  wavenet_stacks=2, dim_cond_mult=2, condition_on_prompt=True, dim_prompt=12,
                  num_latents_m=4, resampler_depth=1)
    port = from_jax_params(Denoiser(**widths), params).eval()
    jden = JDenoiser(**widths)
    rng = np.random.default_rng(18)
    x = rng.normal(size=(2, 10, 8)).astype(np.float32)
    prompt = rng.normal(size=(2, 6, 12)).astype(np.float32)
    times, mask = np.asarray([3.0, 7.0], np.float32), np.ones((2, 10), bool)
    japply = jax.jit(lambda p, drop: jden.apply({"params": p}, x, times, mask, prompt=prompt,
                                                cond_drop_prob=drop), static_argnums=1)
    for drop in (False, True):
        jout = japply(want["denoiser"], float(drop))
        mine = port(*_t(x, times, mask), prompt=torch.from_numpy(prompt),
                    cond_drop_prob=float(drop))
        np.testing.assert_allclose(mine.detach().numpy(), np.asarray(jout), rtol=RTOL,
                                   atol=ATOL)
        with torch.no_grad():
            ref = tden(*_t(x, times, mask), prompt=torch.from_numpy(prompt), drop=drop)
        np.testing.assert_allclose(mine.detach().numpy(), ref.numpy(), rtol=2e-3, atol=2e-3)

