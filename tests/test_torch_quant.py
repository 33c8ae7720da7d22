"""The port's int8 arithmetic (diffnorm_tpu_torch/ops/quant.py) and the
kernels' weight packs against the JAX package, bit for bit, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffnorm_tpu.models.layers as JL
from diffnorm_tpu.ops import quant as jq
from diffnorm_tpu.ops.pallas_block import pack_layer_weights as jax_pack_layer
from diffnorm_tpu.ops.pallas_ffpipe import pack_ff_weights as jax_pack_ff
from diffnorm_tpu_torch.models import layers as TL
from diffnorm_tpu_torch.ops import quant
from diffnorm_tpu_torch.ops.ffpipe import pack_ff_weights
from diffnorm_tpu_torch.ops.fused_layer import pack_layer_weights
from diffnorm_tpu_torch.weights import from_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

DIM, HEADS, DIM_HEAD = 128, 2, 64
INNER = int(DIM * 4 * 2 / 3)  # 341 -> P = 384


def _weights(seed, shape=(96, 40)):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 3] = 0.0      # an all-zero output channel: the 1e-12 floor
    w[5, 7] = 40.0     # an outlier
    return w


@pytest.mark.parametrize("granularity", ["channel", "tensor"])
def test_quantize_weight_matches_jax_bit_for_bit(monkeypatch, granularity):
    monkeypatch.setattr(jq, "_W_SCALAR", granularity == "tensor")
    w = _weights(0)  # JAX layout [in, out]
    ref_q, ref_s = (np.asarray(a) for a in jq.quantize_weight(jnp.asarray(w)))
    got_q, got_s = quant.quantize_weight(torch.from_numpy(w.T.copy()), granularity)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy().T, ref_q)
    np.testing.assert_array_equal(got_s.numpy().reshape(-1), ref_s.reshape(-1))
    with pytest.raises(ValueError, match="granularity"):
        quant.quantize_weight(torch.zeros(2, 2), "row")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_act_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(3, 17, 64)) * rng.uniform(0.1, 30, (3, 17, 1)), dtype)
    ref_q, ref_a = (np.asarray(a) for a in jq.quantize_act(x))
    xt = torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got_q, got_a = quant.quantize_act(xt)
    np.testing.assert_array_equal(got_q.numpy(), ref_q)
    np.testing.assert_array_equal(got_a.numpy(), ref_a)


@pytest.mark.parametrize("deq_bf16", [True, False])
@pytest.mark.parametrize("granularity", ["channel", "tensor"])
def test_dequant_and_int8_matmul_match_jax(monkeypatch, deq_bf16, granularity):
    """int8_matmul (exact int32 products, then JAX's bf16 or f32 dequant
    epilogue) equals jax int8_matmul bit for bit."""
    monkeypatch.setattr(jq, "_DEQ_BF16", deq_bf16)
    monkeypatch.setattr(jq, "_W_SCALAR", granularity == "tensor")
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(4, 9, 40)), jnp.bfloat16)
    w = _weights(3, (40, 72))
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jq.int8_matmul(x, wq, ws), np.float32)
    acc_ref = np.asarray(jax.lax.dot_general(
        jq.quantize_act(x)[0], wq, (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))

    xt = torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
    twq, tws = quant.quantize_weight(torch.from_numpy(w.T.copy()), granularity)
    xq, ax = quant.quantize_act(xt)
    acc = quant.int_mm(xq.reshape(-1, 40), twq).reshape(4, 9, 72)
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    got = quant.int8_matmul(xt, twq, tws, bf16_epilogue=deq_bf16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(
        quant.dequant(acc, ax, tws.reshape(1, -1), torch.bfloat16, deq_bf16).float().numpy(), ref)


def test_quantize_edge_cases():
    """tests/test_pallas_ops.py:233-250 and :273-281: all-zero tensors
    quantize to zeros with finite scales; one huge outlier reconstructs
    within int8 resolution; the row max lands on exactly 127."""
    zq, za = quant.quantize_act(torch.zeros(2, 4, 8))
    assert (zq == 0).all() and torch.isfinite(za).all()
    wq, ws = quant.quantize_weight(torch.zeros(16, 8))
    assert (wq == 0).all() and (ws == 1e-12).all()

    x = torch.zeros(1, 1, 8)
    x[0, 0, 3] = 1e4
    xq, ax = quant.quantize_act(x)
    rec = xq.float() * ax
    np.testing.assert_allclose(rec[0, 0, 3].item(), 1e4, rtol=1e-2)
    assert rec[0, 0, :3].abs().max() <= ax.max()

    x = torch.linspace(1e-3, 3.0, 8192)[:, None]
    q = quant.quantize_act(x)[0].int()
    assert q.max() == 127 and q.min() >= 0
    q_ref = np.asarray(jq.quantize_act(jnp.linspace(1e-3, 3.0, 8192, dtype=jnp.float32)[:, None])[0])
    np.testing.assert_array_equal(q.numpy(), q_ref)


def test_int_mm_is_exact_past_float32():
    """1408 * 127^2 = 2.27e7 > 2^24: a float32 product would round."""
    a = torch.full((3, 1408), 127, dtype=torch.int8)
    b = torch.full((5, 1408), -127, dtype=torch.int8)
    b[0, 0] = -126
    out = quant.int_mm(a, b)
    assert out.dtype == torch.int32
    assert out[1, 1].item() == -1408 * 127 * 127
    assert out[0, 0].item() == -1408 * 127 * 127 + 127  # odd: not a float32 value


@pytest.mark.parametrize("dilation", [1, 4])
def test_int8_causal_conv_matches_jax_module(dilation):
    """CausalConv1d(quant=True) in bf16: one per-out-channel scale over
    [k, in], shifted taps reusing one per-token quantization, the tap sums
    in bf16 (diffnorm_tpu/models/layers.py:160-248). T=6 < the receptive
    field at dilation 4."""
    rng = np.random.default_rng(dilation)
    x = jnp.asarray(rng.normal(size=(2, 6, 24)), jnp.bfloat16)
    jm = JL.CausalConv1d(features=16, kernel_size=3, dilation=dilation, quant=True,
                         dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(dilation), x)
    v = {"params": {"kernel": np.asarray(v["params"]["kernel"]),
                    "bias": rng.normal(size=16).astype(np.float32)}}
    ref = np.asarray(jm.apply(v, x), np.float32)
    tm = from_jax_params(TL.CausalConv1d(24, 16, 3, dilation, quant=True), v["params"])
    with torch.no_grad():
        got = tm.to(torch.bfloat16)(torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), ref)


# ------------------------------------------------------------------ packs

def _ff_params(seed):
    """A JAX FF param subtree with non-zero biases, float32."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"proj_in": {"kernel": n(DIM, 2 * INNER, scale=DIM ** -0.5),
                        "bias": n(2 * INNER, scale=0.05)},
            "conv": {"kernel": n(3, INNER, INNER, scale=(3 * INNER) ** -0.5),
                     "bias": n(INNER, scale=0.05)},
            "proj_out": {"kernel": n(INNER, DIM, scale=INNER ** -0.5),
                         "bias": n(DIM, scale=0.05)}}


def _torch_ff(ffp):
    """The port's pack_ff_weights arguments from a JAX FF subtree."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(ffp["proj_in"]["kernel"].T), t(ffp["proj_in"]["bias"]),
            t(ffp["conv"]["kernel"].transpose(2, 1, 0)), t(ffp["conv"]["bias"]),
            t(ffp["proj_out"]["kernel"].T), t(ffp["proj_out"]["bias"]))


def assert_ff_pack_equal(got, ref):
    p = got["wxq"].shape[0]
    assert p == 384
    for k in ("wxq", "wgq", "wfq"):
        np.testing.assert_array_equal(got[k].numpy().T, np.asarray(ref[k]), k)
    np.testing.assert_array_equal(
        got["wcq"].numpy(), np.asarray(ref["wcq"]).reshape(3, p, p).transpose(0, 2, 1))
    for k in ("wxs", "wgs", "wcs", "wfs", "bx", "bg", "bc", "bf"):
        assert got[k].dtype == torch.float32, k
        g = got[k].numpy().reshape(3 if k == "wcs" else 1, -1)
        r = np.asarray(ref[k]).reshape(g.shape[0], -1)
        np.testing.assert_array_equal(g, np.broadcast_to(r, g.shape), k)


@pytest.mark.parametrize("granularity", ["channel", "tensor"])
def test_ff_and_layer_packs_match_jax_bit_for_bit(monkeypatch, granularity):
    """Both packs equal JAX's: int8 codes equal, float32 scales equal (a
    per-tensor scale broadcast, which pack_ff_weights does and
    pack_layer_weights leaves [1, 1] / [3, 1])."""
    monkeypatch.setattr(jq, "_W_SCALAR", granularity == "tensor")
    ffp = _ff_params(4)
    got = pack_ff_weights(*_torch_ff(ffp), granularity=granularity)
    assert_ff_pack_equal(got, jax_pack_ff(ffp, INNER))

    rng = np.random.default_rng(5)
    attn = {name: {"kernel": rng.normal(size=(DIM, n * DIM)).astype(np.float32)}
            for name, n in (("to_q", 1), ("to_kv", 2), ("to_out", 1))}
    ref = jax_pack_layer(attn, ffp, INNER)
    got = pack_layer_weights(*(torch.from_numpy(attn[k]["kernel"].T.copy())
                               for k in ("to_q", "to_kv", "to_out")), got)
    assert_ff_pack_equal(got, ref)
    np.testing.assert_array_equal(
        got["wqkv"].float().numpy(),
        np.concatenate([np.asarray(ref["wq"], np.float32),
                        np.asarray(ref["wkv"], np.float32)], axis=1).T)
    np.testing.assert_array_equal(got["wo"].float().numpy(),
                                  np.asarray(ref["wo"], np.float32).T)


def test_packs_survive_from_jax_params_and_the_bf16_cast():
    """The model's packs are built from the float32 masters when the weights
    load and keep their codes and float32 scales through `.to(bf16)`; codes
    packed from bf16-rounded weights would differ, so packing a bf16 model
    raises."""
    jm = JL.ConditionableTransformer(
        dim=DIM, depth=1, dim_head=DIM_HEAD, heads=HEADS, ff_causal_conv=True,
        cond_dim=DIM * 4, dropout=0.0, quant_int8=True, dtype=jnp.bfloat16)
    x = jnp.zeros((2, 8, DIM), jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), x, cond=jnp.zeros((2, DIM * 4)))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    params["ff_0"] = _ff_params(6)
    tm = from_jax_params(TL.ConditionableTransformer(
        DIM, 1, DIM_HEAD, HEADS, ff_causal_conv=True, cond_dim=DIM * 4, quant_int8=True),
        params).to(torch.bfloat16)
    ff, attn = tm.layer("ff", 0), tm.layer("attn", 0)
    assert ff.proj_in.weight.dtype == torch.bfloat16
    ref = jax_pack_layer(params["attn_0"], params["ff_0"], INNER)
    got = {**attn.fused.tensors(), **ff.int8.tensors()}
    assert_ff_pack_equal(got, ref)
    assert got["wqkv"].dtype == torch.bfloat16
    q_ref, s_ref = jq.quantize_weight(jnp.asarray(params["attn_0"]["to_q"]["kernel"]))
    np.testing.assert_array_equal(attn.to_q.int8.wq.numpy().T, np.asarray(q_ref))
    assert attn.to_q.int8.ws.dtype == torch.float32
    np.testing.assert_array_equal(attn.to_q.int8.ws.numpy().reshape(-1),
                                  np.asarray(s_ref).reshape(-1))

    # the trap: the same weights rounded to bf16 give other codes
    bf = pack_ff_weights(*(t.to(torch.bfloat16).float() for t in _torch_ff(params["ff_0"])))
    assert (bf["wcq"] != got["wcq"]).any()
    with pytest.raises(TypeError, match="float32"):
        ff.pack_weights()
