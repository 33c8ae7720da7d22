"""The port's DDIM normalization (diffnorm_tpu_torch/models/diffusion.py)
against the JAX ddim_sample at a tiny configuration, with the VAE posterior
eps and the start noise injected into both, in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.models.diffusion import LatentDiffusionModel
from diffnorm_tpu.models.diffusion import ddim_sample as jax_ddim_sample
from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
from diffnorm_tpu_torch.weights import from_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

# the shape of tests/test_diffusion.py's tiny config
TINY = dict(hidden_dim=16, latent_dim=3, feature_dim=24, chan_mults=[4],
            vae_decoder_depth=1, vae_decoder_dim_head=8, vae_decoder_heads=2,
            denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1,
            timesteps=20, vocab_size=20)


def port_model(params) -> LatentDiffusionModule:
    model = LatentDiffusionModule(
        dim=TINY["hidden_dim"], latent_dim=TINY["latent_dim"],
        feature_dim=TINY["feature_dim"], vocab_size=TINY["vocab_size"],
        timesteps=TINY["timesteps"], denoiser_depth=TINY["denoiser_depth"],
        wavenet_layers=TINY["wavenet_layers"],
        wavenet_stacks=TINY["wavenet_stacks"],
        vae_decoder_depth=TINY["vae_decoder_depth"],
        vae_decoder_dim_head=TINY["vae_decoder_dim_head"],
        vae_decoder_heads=TINY["vae_decoder_heads"],
        chan_mults=TINY["chan_mults"])
    return from_jax_params(model, params).eval()


@pytest.fixture(scope="module")
def built():
    """The JAX model with random non-zero biases (so every bias path is
    live) and the port model carrying the same weights."""
    jmodel = LatentDiffusionModel.build_model(Config(**TINY))
    feat = jnp.zeros((2, 10, TINY["feature_dim"]))
    v = jmodel.module.init({"params": jax.random.PRNGKey(0)}, feat,
                           jnp.ones((2, 10), bool), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + (0.05 * rng.normal(size=a.shape)
                                    if a.ndim == 1 else 0.0)).astype(np.float32),
        v["params"])
    return jmodel, {"params": params}, port_model(params)


@pytest.mark.parametrize("stride", [1, 4])
def test_ddim_sample_matches_jax(built, stride):
    jmodel, variables, model = built
    rng = np.random.default_rng(stride)
    b, t, start_step = 3, 12, 6
    feature = rng.normal(size=(b, t, TINY["feature_dim"])).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[1, 9:] = False
    enc_noise = rng.normal(size=(b, t, TINY["latent_dim"])).astype(np.float32)
    init_noise = rng.normal(size=(b, t, TINY["latent_dim"])).astype(np.float32)

    ref_units, ref_recon = jax_ddim_sample(
        jmodel, variables, jnp.asarray(feature), jnp.asarray(mask),
        jax.random.PRNGKey(0), start_step=start_step, stride=stride,
        enc_noise=jnp.asarray(enc_noise), init_noise=jnp.asarray(init_noise))
    units, recon = ddim_sample(
        model, torch.from_numpy(feature), torch.from_numpy(mask),
        start_step=start_step, stride=stride,
        enc_noise=torch.from_numpy(enc_noise),
        init_noise=torch.from_numpy(init_noise), device="cpu")

    assert units.dtype == torch.int32
    np.testing.assert_array_equal(units.numpy(), np.asarray(ref_units))
    np.testing.assert_allclose(recon.numpy(), np.asarray(ref_recon),
                               rtol=2e-4, atol=2e-4)
