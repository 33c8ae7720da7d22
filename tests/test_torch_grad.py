"""Gradients of the port against jax.grad of the JAX modules, in float32 on
the CPU, on weights carried by weights.from_jax_params.

On the card a kernel's forward is opaque to autograd, and the wrappers take
their gradients from the plain version's backward. These tests make the
forward of each kernel they reach opaque in the same way (its result
computed under no_grad, so it carries no graph), so what they check is the
gradient the card gives. They also pin the inference packs: rebuilt after an
in-place parameter change or a load, and no autograd graph where nothing
needs one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffnorm_tpu.models.layers as JL
from diffnorm_tpu.models.diffusion import Denoiser as JDenoiser
from diffnorm_tpu.models.wavenet import Wavenet as JWavenet
from diffnorm_tpu.ops.attention import masked_attention as jax_masked_attention
from diffnorm_tpu_torch.models import layers as TL
from diffnorm_tpu_torch.models.diffusion import Denoiser
from diffnorm_tpu_torch.models.wavenet import Wavenet
from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops import flash_attention as flash_ops
from diffnorm_tpu_torch.ops import norm as norm_ops
from diffnorm_tpu_torch.ops import wavenet_chain as chain_ops
from diffnorm_tpu_torch.ops.attention import FLASH_MIN_LEN, masked_attention
from diffnorm_tpu_torch.weights import from_jax_params, to_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

# float32 on both sides: the same function with sums taken in other orders
GRAD_REL = 1e-4


@pytest.fixture
def opaque_kernels(monkeypatch):
    """Every kernel wrapper's forward computed under no_grad, as a CUDA
    kernel's result carries no autograd graph."""
    for module in (chain_ops, norm_ops, flash_ops):
        launch = module._launch

        def opaque(*args, _launch=launch, **kwargs):
            with torch.no_grad():
                return _launch(*args, **kwargs)

        monkeypatch.setattr(module, "_launch", opaque)


def _grads_tree(model: torch.nn.Module) -> dict:
    """The parameters' .grad as a JAX params tree (to_jax_params' layout)."""
    grads = copy.deepcopy(model)
    for p, g in zip(model.parameters(), grads.parameters()):
        assert p.grad is not None, "a parameter got no gradient"
        g.data = p.grad.detach().clone()
    return to_jax_params(grads)


def _assert_trees_close(got: dict, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, f"{path}: the JAX gradient is all zeros"
    rel = np.abs(got - want).max() / scale
    assert rel <= GRAD_REL, f"{path}: max-abs / scale {rel:.3e} > {GRAD_REL}"


def _shift_biases(tree, delta):
    """Every bias of a params tree plus `delta` (numpy), so every bias path
    carries a gradient that depends on it."""
    return {k: _shift_biases(a, delta) if isinstance(a, dict)
            else np.asarray(a) + (delta if k == "bias" else 0.0)
            for k, a in tree.items()}


@pytest.mark.parametrize("cond", [12, None], ids=["conditioned", "unconditioned"])
def test_wavenet_grads_match_jax(opaque_kernels, cond):
    """C=32, 2 stacks x 3 chains, non-zero biases: every parameter's gradient,
    the block convs' through the chain wrapper's backward."""
    rng = np.random.default_rng(1)
    b, t, dim = 2, 16, 32
    x = rng.normal(size=(b, t, dim)).astype(np.float32)
    args = (x,) if cond is None else (x, rng.normal(size=(b, cond)).astype(np.float32))
    r = rng.normal(size=(b, t, dim)).astype(np.float32)
    jm = JWavenet(dim=dim, stacks=2, layers=3, cond_dim=cond)
    params = _shift_biases(jm.init(jax.random.PRNGKey(0), *args)["params"], 0.3)
    want = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, *args) * r))(params)

    tm = from_jax_params(Wavenet(dim, dim, 2, 3, cond_dim=cond), params)
    before = _build.launch_counts["wavenet_chain"]
    (tm(*map(torch.from_numpy, args)) * torch.from_numpy(r)).sum().backward()
    assert _build.launch_counts["wavenet_chain"] == before  # CPU: no launch
    _assert_trees_close(_grads_tree(tm), want)


def test_denoiser_grads_match_jax(opaque_kernels):
    """A small Denoiser (WaveNet 2 x 2 chains, 1 transformer layer, masked
    padding): every parameter's gradient, the FF's padded packs and the
    WaveNet's chain packs included."""
    rng = np.random.default_rng(2)
    b, t, dim, latent = 2, 12, 32, 4
    x = rng.normal(size=(b, t, latent)).astype(np.float32)
    times = np.array([3.0, 11.0], np.float32)
    mask = np.arange(t)[None, :] < np.array([t, 8])[:, None]
    r = rng.normal(size=(b, t, latent)).astype(np.float32)
    jm = JDenoiser(dim=dim, latent_dim=latent, depth=1, wavenet_layers=2, wavenet_stacks=2)
    params = jm.init(jax.random.PRNGKey(0), x, times, mask)["params"]
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + (0.05 * rng.normal(size=a.shape) if a.ndim == 1 else 0.0)
                   ).astype(np.float32), params)
    want = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x, times, mask) * r))(params)

    tm = from_jax_params(Denoiser(dim, latent, depth=1, wavenet_layers=2, wavenet_stacks=2),
                         params)
    out = tm(torch.from_numpy(x), torch.from_numpy(times), torch.from_numpy(mask))
    (out * torch.from_numpy(r)).sum().backward()
    _assert_trees_close(_grads_tree(tm), want)


def test_rms_norm_film_grads_match_jax(opaque_kernels):
    """The norm kernel's wrapper with film: gradients of x and of the FiLM
    projection's parameters against the JAX module's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    cond = rng.normal(size=(2, 12)).astype(np.float32)
    r = rng.normal(size=(2, 6, 16)).astype(np.float32)
    jm = JL.RMSNorm(dim=16, scale=False, cond_dim=12)
    params = _shift_biases(jm.init(jax.random.PRNGKey(0), x, cond)["params"], 0.2)

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x, cond) * r)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(params, x)
    tm = from_jax_params(TL.RMSNorm(16, scale=False, cond_dim=12), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = norm_ops.rms_norm_film(xt, tm.film(torch.from_numpy(cond)))
    (out * torch.from_numpy(r)).sum().backward()
    _assert_trees_close(_grads_tree(tm), want_p)
    _assert_trees_close({"x": xt.grad.numpy()}, {"x": want_x})
    # where nothing needs a gradient the call is the forward alone: no graph
    film = tm.film(torch.from_numpy(cond)).detach()
    assert norm_ops.rms_norm_film(torch.from_numpy(x), film).grad_fn is None
    with torch.no_grad():
        assert norm_ops.rms_norm_film(xt, film).grad_fn is None


def test_attention_grads_match_jax_at_long_keys(opaque_kernels):
    """At Tk >= FLASH_MIN_LEN, small B*H: q, k, v gradients of the flash
    wrapper (its plain version's backward) and of masked_attention's module
    math against jax.grad of JAX's masked_attention."""
    rng = np.random.default_rng(4)
    b, h, tq, tk, d = 2, 1, 8, FLASH_MIN_LEN + 5, 16
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (tq, tk, tk))
    mask = np.arange(tk)[None, :] < np.array([tk, tk - 700])[:, None]
    r = rng.normal(size=(b, h, tq, d)).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_masked_attention(q, k, v, mask) * r),
                    argnums=(0, 1, 2))(q, k, v)
    for fn in (flash_ops.flash_attention, masked_attention):
        qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        (fn(*qkv, torch.from_numpy(mask)) * torch.from_numpy(r)).sum().backward()
        _assert_trees_close({n: a.grad.numpy() for n, a in zip("qkv", qkv)},
                            dict(zip("qkv", want)))


@pytest.mark.parametrize("change", ["optimizer_step", "load_state_dict", "load_assign"])
def test_packs_follow_parameter_changes(change):
    """After an optimizer step or load_state_dict (copying, or assigning new
    parameter objects), a no_grad forward uses packs of the new parameters
    (WaveNet chains and FF padding), as a freshly packed model does."""
    torch.manual_seed(0)
    model = Denoiser(16, 3, depth=1, wavenet_layers=2, wavenet_stacks=2)
    x, times = torch.randn(2, 7, 3), torch.tensor([2.0, 5.0])
    if change == "optimizer_step":
        packed = (model.wavenet.stack_0.block_1.conv.weight, model.transformer.ff_0.proj_in.weight)
        before = [p.detach().clone() for p in packed]
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        model(x, times).square().sum().backward()
        opt.step()
        assert all(not torch.equal(p, b) for p, b in zip(packed, before))  # they trained
    else:
        other = Denoiser(16, 3, depth=1, wavenet_layers=2, wavenet_stacks=2)
        model.load_state_dict(other.state_dict(), assign=change == "load_assign")
    fresh = from_jax_params(Denoiser(16, 3, depth=1, wavenet_layers=2, wavenet_stacks=2),
                            to_jax_params(model))
    with torch.no_grad():
        got, want = model(x, times), fresh(x, times)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_block_parameter_changed_in_place_repacks():
    """A block parameter changed in place under no_grad: the next no_grad
    forward repacks (the chain's conv weight here)."""
    torch.manual_seed(1)
    model = Wavenet(6, 8, stacks=2, layers=2, cond_dim=4)
    x, t = torch.randn(2, 5, 6), torch.randn(2, 4)
    with torch.no_grad():
        model.stack_1.block_0.conv.weight.add_(0.25)
        model.stack_0.block_1.conv.bias.sub_(0.5)
        got = model(x, t)
    fresh = from_jax_params(Wavenet(6, 8, stacks=2, layers=2, cond_dim=4),
                            to_jax_params(model))
    with torch.no_grad():
        want = fresh(x, t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype, d, want", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 80, False),
    (torch.float16, 64, False), (torch.float32, 160, False), (torch.float32, 80, True)])
def test_flash_supports_mirrors_the_wrapper(dtype, d, want):
    """`supports` is True exactly where the wrapper would launch: bf16 with D
    in 32/64/96/128, float32 with D <= 128."""
    q = torch.zeros(1, 2, 3, d, dtype=dtype)
    k = torch.zeros(1, 2, 5, d, dtype=dtype)
    mask = torch.ones(1, 5, dtype=torch.bool)
    assert flash_ops.supports(q, k, k, mask) is want
    assert flash_ops.supports(q, k, k, None) is want
    assert not flash_ops.supports(q, k, k, torch.ones(1, 4, dtype=torch.bool))
