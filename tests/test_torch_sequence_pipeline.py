"""The port's sequence and pipeline parallelism (parallel/sequence.py,
parallel/pipeline.py) on 4 gloo ranks on the CPU (tests/torch_dist_worker.py
job "sp"), each held to JAX's own functions on 4 of the conftest's virtual
devices at JAX's tolerances (tests/test_sequence_parallel.py,
tests/test_pipeline_parallel.py): ring attention masked, unmasked, with bf16
probs @ v, and its gradients; conformer_encode_sp on an even and a ragged
length and its parameters' gradients; pipeline_apply and its gradients."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.models.conformer import ConformerEncoder as JConformerEncoder
from diffnorm_tpu.parallel.pipeline import make_stage_mesh as jax_stage_mesh
from diffnorm_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from diffnorm_tpu.parallel.sequence import conformer_encode_sp as jax_conformer_encode_sp
from diffnorm_tpu.parallel.sequence import make_seq_mesh as jax_seq_mesh
from diffnorm_tpu.parallel.sequence import (
    sequence_parallel_attention as jax_sp_attention,
)
from diffnorm_tpu_torch.models.conformer import ConformerEncoder
from diffnorm_tpu_torch.weights import flatten_tree, save_npz, to_jax_params
from tests import torch_dist_worker as W
from tests.test_torch_distributed import run_ranks
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

# the JAX tests' inputs and the conformers' lengths (even, ragged: T' = 11
# over 4 ranks, and the gradients')
ENC_INPUT = {"even": (64, [64, 41], 0), "ragged": (44, [44, 30], 1), "grad": (32, [32, 21], 2)}


def _qkv(rng, b=2, h=3, t=32, d=8):
    return [rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3)]


def _mask(rng, b, t):
    lens = rng.integers(t // 2, t + 1, size=b)
    return np.arange(t)[None, :] < lens[:, None]


def _encoder_variables(enc, src, lens, seed):
    """Seeded variables in the init's shapes (`jax.eval_shape`, no compiled
    init): kernels normal over sqrt(fan-in), scales 1, biases 0 perturbed,
    batch statistics of mean 0.1 and var 1.2."""
    shapes = jax.eval_shape(lambda: enc.init(jax.random.PRNGKey(0), src, lens))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "mean":
            return np.full(a.shape, 0.1, np.float32)
        if name == "var":
            return np.full(a.shape, 1.2, np.float32)
        if name == "scale":
            return (1.0 + 0.05 * rng.normal(size=a.shape)).astype(np.float32)
        if len(a.shape) <= 1 or name.startswith("pos_bias"):
            return (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's results, and the port's from the 4 ranks on the same inputs."""
    root = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    seq, ref, inputs = jax_seq_mesh(4), {}, {}
    attention = jax.jit(lambda q, k, v, mask=None: jax_sp_attention(q, k, v, mask, mesh=seq))
    q, k, v = _qkv(rng)
    mask = _mask(rng, 2, 32)
    inputs.update(q_f32=q, k_f32=k, v_f32=v, q_bf16=q, k_bf16=k, v_bf16=v, mask=mask)
    ref["attn_f32"] = attention(*map(jnp.asarray, (q, k, v, mask)))
    ref["attn_bf16"] = attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                 jnp.asarray(mask)).astype(jnp.float32)
    ref["attn_nomask"] = attention(*map(jnp.asarray, (q, k, v)))
    qg, kg, vg = _qkv(rng, t=16)
    mask_g = _mask(rng, 2, 16)
    inputs.update(q_g=qg, k_g=kg, v_g=vg, mask_g=mask_g)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(attention(q, k, v, jnp.asarray(mask_g))
                                                     ** 2), argnums=(0, 1, 2)))(
        *map(jnp.asarray, (qg, kg, vg)))
    ref.update({f"attn_grad_{n}": g for n, g in zip("qkv", grads)})
    for case, (t, lens, seed) in ENC_INPUT.items():
        cfg = W.SP_ENCODERS[case]
        enc = JConformerEncoder(**cfg)
        src = np.random.default_rng(seed).normal(size=(2, t, 80)).astype(np.float32)
        lens = np.asarray(lens)
        variables = _encoder_variables(enc, jnp.asarray(src), jnp.asarray(lens), seed)
        save_npz(str(root / f"sp_enc_{case}.npz"), variables)
        inputs[f"src_{case}"], inputs[f"lens_{case}"] = src, lens
        if case != "grad":
            out, out_mask = jax_conformer_encode_sp(enc, variables, jnp.asarray(src),
                                                    jnp.asarray(lens), seq)
            ref[f"enc_{case}"], ref[f"mask_{case}"] = out, out_mask
            continue

        def loss_sp(params):
            out, m = jax_conformer_encode_sp(enc, {**variables, "params": params},
                                             jnp.asarray(src), jnp.asarray(lens), seq)
            return jnp.sum((out * m[:, :, None]) ** 2)

        ref["enc_grad"] = jax.jit(jax.grad(loss_sp))(variables["params"])
    s, m, mb, d = 4, 6, 2, 8
    w = (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32)
    b = rng.normal(size=(s, d)).astype(np.float32)
    x = rng.normal(size=(m, mb, d)).astype(np.float32)
    inputs.update(pp_w=w, pp_b=b, pp_x=x)
    stages = jax_stage_mesh(s)

    def pp_loss(params, x):
        out = jax_pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), params, x, stages)
        return jnp.sum(out ** 2), out

    (_, ref["pp"]), (pg, ref["pp_grad_x"]) = jax.jit(jax.value_and_grad(
        pp_loss, argnums=(0, 1), has_aux=True))({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                                jnp.asarray(x))
    ref["pp_grad_w"], ref["pp_grad_b"] = pg["w"], pg["b"]
    np.savez(root / "sp_in.npz", **inputs)
    run_ranks(4, "sp", root)
    got = dict(np.load(root / "sp_out.npz"))
    ref = {k: v if isinstance(v, dict) else np.asarray(v, np.float32)
           for k, v in jax.device_get(ref).items()}
    return types.SimpleNamespace(got=got, ref=ref, inputs=inputs)


def test_ring_attention_matches_jax(runs):
    got, ref = runs.got, runs.ref
    valid = runs.inputs["mask"][:, None, :, None]
    # a fully masked query row: both rings emit 0 (compare valid rows, as JAX)
    np.testing.assert_allclose(got["attn_f32"] * valid, ref["attn_f32"] * valid, atol=2e-6)
    np.testing.assert_allclose(got["attn_nomask"], ref["attn_nomask"], atol=2e-6)
    assert np.abs((got["attn_bf16"] - ref["attn_bf16"]) * valid).max() < 3e-2


def test_ring_attention_gradients_match_jax(runs):
    for n in "qkv":
        np.testing.assert_allclose(runs.got[f"attn_grad_{n}"], runs.ref[f"attn_grad_{n}"],
                                   atol=1e-4, err_msg=n)


@pytest.mark.parametrize("case", ["even", "ragged"])
def test_conformer_encode_sp_matches_jax(runs, case):
    got, ref = runs.got, runs.ref
    np.testing.assert_array_equal(got[f"mask_{case}"].astype(bool), ref[f"mask_{case}"])
    valid = ref[f"mask_{case}"][:, :, None]
    np.testing.assert_allclose(got[f"enc_{case}"] * valid, ref[f"enc_{case}"] * valid,
                               atol=5e-5)


def test_conformer_encode_sp_gradients_match_jax(runs):
    """The layer parameters' gradients sum the ranks' shards (and the
    subsampler's are whole on every rank), as JAX's shard_map transposes."""
    want = {"/".join(k): np.asarray(v) for k, v in flatten_tree(runs.ref["enc_grad"]).items()}
    enc = ConformerEncoder(**W.SP_ENCODERS["grad"])
    with torch.no_grad():
        for name, p in enc.named_parameters():
            p.copy_(torch.from_numpy(runs.got[f"enc_grad/{name}"]))
    mine = {"/".join(k): v for k, v in flatten_tree(to_jax_params(enc)).items()}
    assert set(mine) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(mine[key], ref, atol=5e-4, err_msg=key)


def test_pipeline_apply_and_gradients_match_jax(runs):
    got, ref = runs.got, runs.ref
    np.testing.assert_allclose(got["pp"], ref["pp"], rtol=1e-5, atol=1e-6)
    x, w, b = (runs.inputs[k] for k in ("pp_x", "pp_w", "pp_b"))
    seq = x
    for i in range(4):
        seq = np.tanh(seq @ w[i] + b[i])
    np.testing.assert_allclose(got["pp"], seq, rtol=1e-5, atol=1e-6)
    for key in ("pp_grad_x", "pp_grad_w", "pp_grad_b"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)
