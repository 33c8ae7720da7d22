"""The port's int8 kernel modules (their plain versions, on the CPU) against
the JAX Pallas kernels in interpret mode, the transformer's int8 routes
against JAX's, and the int8 DDIM slice as a whole. The CUDA kernels are
checked against these plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffnorm_tpu.models.layers as JL
from diffnorm_tpu.config import Config
from diffnorm_tpu.models.diffusion import LatentDiffusionModel
from diffnorm_tpu.models.diffusion import ddim_sample as jax_ddim_sample
from diffnorm_tpu.models.wavenet import Wavenet as JWavenet
from diffnorm_tpu.ops import quant as jq
from diffnorm_tpu.ops.pallas_block import fused_layer as jax_fused_layer
from diffnorm_tpu.ops.pallas_block import pack_layer_weights as jax_pack_layer
from diffnorm_tpu.ops.pallas_ffpipe import ffpipe_layer as jax_ffpipe_layer
from diffnorm_tpu.ops.pallas_ffpipe import pack_ff_weights as jax_pack_ff
from diffnorm_tpu_torch.models import layers as TL
from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops.ffpipe import ffpipe_layer, pack_ff_weights
from diffnorm_tpu_torch.ops.fused_layer import fused_layer, pack_layer_weights
from diffnorm_tpu_torch.weights import from_jax_params, to_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

DIM, HEADS, DIM_HEAD, T = 128, 2, 64, 32
INNER, P = 341, 384
# kernel-level bounds (the FF arithmetic is JAX's to the operation; a flipped
# int8 code moves an output by a bf16 ulp or so)
FF_ROW_COS, FF_REL_ERR, FF_BIT_EQUAL = 0.9999, 5e-3, 0.90
# the whole layer: the bf16 attention half rounds elsewhere and flips codes
LAYER_ROW_COS, LAYER_REL_ERR = 0.9995, 3e-2


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def agreement(ref, got, mask=None):
    """(min row-cos, max-abs over the reference's scale, bit-equal share)
    over the rows of [B, T, C] outputs (the valid rows where `mask`)."""
    r, g = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    if mask is not None:
        r, g = r[np.asarray(mask)], g[np.asarray(mask)]
    r, g = r.reshape(-1, r.shape[-1]), g.reshape(-1, g.shape[-1])
    cos = (r * g).sum(-1) / (np.linalg.norm(r, axis=-1) * np.linalg.norm(g, axis=-1))
    return cos.min(), np.abs(r - g).max() / np.abs(r).max(), (r == g).mean()


def _with_biases(tree, rng):
    """Every bias of a params tree made non-zero (numpy)."""
    return {k: _with_biases(v, rng) if isinstance(v, dict)
            else np.asarray(v) + (0.05 * rng.normal(size=v.shape).astype(np.float32)
                                  if k == "bias" else 0.0)
            for k, v in tree.items()}


def _masks(b):
    lengths = np.asarray([T, T - 5, 7, 1][:b])
    return np.arange(T)[None, :] < lengths[:, None]


@pytest.fixture(scope="module")
def jax_layers():
    """A 2-layer int8 bf16 JAX ConditionableTransformer at C=128 (2 heads x
    64, inner 341 -> P=384) with non-zero biases, its FiLM and inputs."""
    jm = JL.ConditionableTransformer(
        dim=DIM, depth=2, dim_head=DIM_HEAD, heads=HEADS, ff_mult=4, ff_causal_conv=True,
        cond_dim=DIM * 4, dropout=0.0, quant_int8=True, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, T, DIM)), jnp.bfloat16)
    cond = jnp.asarray(rng.normal(size=(4, DIM * 4)), jnp.float32)
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, x, cond=cond, mask=_masks(4))
    params = _with_biases(jax.tree_util.tree_map(np.asarray, v["params"]), rng)
    film = jm.apply({"params": params}, cond, method=jm.precompute_film)
    return dict(module=jm, params=params, x=x, film=film)


def _torch_ff(ffp):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(ffp["proj_in"]["kernel"].T), t(ffp["proj_in"]["bias"]),
            t(ffp["conv"]["kernel"].transpose(2, 1, 0)), t(ffp["conv"]["bias"]),
            t(ffp["proj_out"]["kernel"].T), t(ffp["proj_out"]["bias"]))


def _torch_layer_pack(attn, ffp):
    return pack_layer_weights(*(torch.from_numpy(np.ascontiguousarray(attn[k]["kernel"].T))
                                for k in ("to_q", "to_kv", "to_out")),
                              pack_ff_weights(*_torch_ff(ffp)))


@pytest.mark.parametrize("rows", [1, 2])
def test_ffpipe_plain_matches_pallas_kernel(jax_layers, rows):
    """B=4: rows=2 runs JAX's two-row kernel _ffpipe_layer2."""
    ffp = jax_layers["params"]["ff_0"]
    rng = np.random.default_rng(rows)
    x = jnp.asarray(rng.normal(size=(4, T, DIM)), jnp.bfloat16)
    film = jnp.asarray(rng.normal(size=(4, 2 * DIM)), jnp.float32)
    ref = jax_ffpipe_layer(x, film, jax_pack_ff(ffp, INNER), dim=DIM, pad_inner=P,
                           interpret=True, rows=rows)
    before = sum(_build.launch_counts.values())
    got = ffpipe_layer(_bf16(x), _f32(film), pack_ff_weights(*_torch_ff(ffp)), rows=rows)
    assert sum(_build.launch_counts.values()) == before  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (4, T, DIM)
    cos, rel, same = agreement(ref, got.float())
    print(f"ffpipe rows={rows}: min row-cos {cos:.6f}, max-abs/scale {rel:.2e}, "
          f"bit-equal {same:.4f}")
    assert cos > FF_ROW_COS and rel < FF_REL_ERR and same >= FF_BIT_EQUAL, (cos, rel, same)


@pytest.mark.parametrize("part", ["ff_half", "whole"])
def test_fused_layer_plain_matches_pallas_kernel(jax_layers, part):
    """`ff_half` zeroes to_out, so x1 = x and the FF half is compared alone
    (the conv output rounded to bf16 before requantizing, as the fused
    kernel does); `whole` adds the bf16 masked attention."""
    attn = dict(jax_layers["params"]["attn_0"])
    if part == "ff_half":
        attn["to_out"] = {"kernel": np.zeros_like(attn["to_out"]["kernel"])}
    ffp = jax_layers["params"]["ff_0"]
    x, film = jax_layers["x"][:3], jax_layers["film"]
    mask = _masks(3)
    fa, ff = film["attn"][0][:3], film["ff"][0][:3]
    ref = jax_fused_layer(x, jnp.asarray(mask), fa, ff, jax_pack_layer(attn, ffp, INNER),
                          dim=DIM, dim_head=DIM_HEAD, heads=HEADS, pad_inner=P, interpret=True)
    got = fused_layer(_bf16(x), torch.from_numpy(mask), _bf16(fa), _bf16(ff),
                      _torch_layer_pack(attn, ffp), HEADS, DIM_HEAD)
    assert got.dtype == torch.bfloat16
    cos, rel, same = agreement(ref, got.float())
    print(f"fused_layer {part}: min row-cos {cos:.6f}, max-abs/scale {rel:.2e}, "
          f"bit-equal {same:.4f}")
    if part == "ff_half":
        assert cos > FF_ROW_COS and rel < FF_REL_ERR and same >= FF_BIT_EQUAL, (cos, rel, same)
    else:
        assert cos > LAYER_ROW_COS and rel < LAYER_REL_ERR, (cos, rel, same)


def test_per_tensor_weight_scales_are_broadcast(jax_layers, monkeypatch):
    """DIFFNORM_INT8_WSCALAR=1: the port's layer pack broadcasts the
    per-tensor scales to [P] / [3, P] / [C], and fused_layer equals JAX's
    fused_layer fed the broadcast scales of JAX's pack_ff_weights. JAX's own
    pack_layer_weights keeps them [1, 1] / [3, 1], which its (1, P)
    BlockSpecs read past (ROADMAP Queue 3)."""
    monkeypatch.setattr(jq, "_W_SCALAR", True)
    attn, ffp = jax_layers["params"]["attn_0"], jax_layers["params"]["ff_0"]
    broadcast = jax_pack_ff(ffp, INNER)
    unbroadcast = jax_pack_layer(attn, ffp, INNER)
    assert unbroadcast["wxs"].shape == (1, 1) and unbroadcast["wcs"].shape == (3, 1)
    assert broadcast["wxs"].shape == (1, P) and broadcast["wcs"].shape == (3, P)
    jw = {**unbroadcast, **{k: broadcast[k] for k in ("wxs", "wgs", "wcs", "wfs")}}
    x, film, mask = jax_layers["x"][:3], jax_layers["film"], _masks(3)
    fa, ff = film["attn"][0][:3], film["ff"][0][:3]
    ref = jax_fused_layer(x, jnp.asarray(mask), fa, ff, jw, dim=DIM, dim_head=DIM_HEAD,
                          heads=HEADS, pad_inner=P, interpret=True)
    tw = pack_layer_weights(*(torch.from_numpy(np.ascontiguousarray(attn[k]["kernel"].T))
                              for k in ("to_q", "to_kv", "to_out")),
                            pack_ff_weights(*_torch_ff(ffp), granularity="tensor"))
    got = fused_layer(_bf16(x), torch.from_numpy(mask), _bf16(fa), _bf16(ff), tw,
                      HEADS, DIM_HEAD)
    assert torch.isfinite(got.float()).all()
    cos, rel, same = agreement(ref, got.float())
    assert cos > LAYER_ROW_COS and rel < LAYER_REL_ERR, (cos, rel, same)


@pytest.mark.parametrize("route", TL.INT8_ROUTES)
def test_transformer_routes_match_jax(jax_layers, monkeypatch, route):
    """Each int8 route of the port's ConditionableTransformer against the
    JAX module on the same route (DIFFNORM_FUSED_BLOCK / DIFFNORM_FFPIPE /
    DIFFNORM_FFPIPE_ROWS=2 / the int8 module path), bf16, B=4 with padded
    keys. Bounds of tests/test_pallas_ops.py:148-160, 224-230, tightened."""
    monkeypatch.setattr(JL, "_FUSED_BLOCK", route == "fused_layer")
    monkeypatch.setattr(JL, "_FF_PIPE", route in ("ffpipe", "ffpipe2"))
    monkeypatch.setenv("DIFFNORM_FFPIPE_ROWS", "2" if route == "ffpipe2" else "1")
    jm, params, x, film = (jax_layers[k] for k in ("module", "params", "x", "film"))
    mask = _masks(4)
    ref = jm.apply({"params": params}, x, mask=jnp.asarray(mask), film=film)

    tm = from_jax_params(TL.ConditionableTransformer(
        DIM, 2, DIM_HEAD, HEADS, ff_causal_conv=True, cond_dim=DIM * 4, quant_int8=True,
        int8_route=route), params).to(torch.bfloat16).eval()
    tfilm = {k: [_bf16(f) for f in v] for k, v in film.items()}
    assert tm.route(tfilm) == route
    with torch.no_grad():
        got = tm(_bf16(x), mask=torch.from_numpy(mask), film=tfilm)
    cos, rel, _ = agreement(ref, got.float(), mask)
    print(f"route {route}: min row-cos {cos:.6f}, max-abs/scale {rel:.2e}")
    assert cos > 0.999 and rel < 0.03, (cos, rel)


def test_route_conditions_and_wrappers():
    """A kernel route is taken only where JAX takes it; the wrappers launch
    or raise off the CPU, never fall back."""
    tm = TL.ConditionableTransformer(DIM, 1, DIM_HEAD, HEADS, ff_causal_conv=True,
                                     cond_dim=DIM * 4, quant_int8=True)
    film = tm.precompute_film(torch.zeros(2, DIM * 4))
    assert tm.route(film) == "module"  # float32 weights
    tm = tm.to(torch.bfloat16)
    assert tm.route(film) == "fused_layer" and tm.route(None) == "module"
    narrow = TL.ConditionableTransformer(DIM, 1, 32, 2, ff_causal_conv=True,
                                         cond_dim=DIM * 4, quant_int8=True).to(torch.bfloat16)
    assert narrow.route(film) == "module"  # heads * dim_head != dim
    narrow.int8_route = "ffpipe"
    assert narrow.route(film) == "ffpipe"
    with pytest.raises(ValueError, match="int8_route"):
        TL.ConditionableTransformer(DIM, 1, int8_route="fused")

    x = torch.zeros(2, 4, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        ffpipe_layer(x, x[:, 0], {})
    with pytest.raises(ValueError, match="unsupported device"):
        fused_layer(x, x[..., 0], x[:, 0], x[:, 0], {}, 1, 64)


# ---------------------------------------------------------- the whole slice

# JAX's Denoiser fixes 8 heads x 64, and its fused route needs
# heads * dim_head == dim: the slice runs at dim 512, everything else tiny
SLICE = dict(hidden_dim=512, latent_dim=3, feature_dim=24, chan_mults=[4],
             vae_decoder_depth=1, vae_decoder_dim_head=8, vae_decoder_heads=2,
             denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, timesteps=50,
             vocab_size=52)


def _interpret_chains(monkeypatch):
    """Run JAX's Pallas WaveNet route in interpret mode on the CPU, as
    tests/test_pallas_ops.py:97-117 does."""
    chains = JWavenet._chains_pallas

    def interpreted(self, x, t=None, film=None, interpret=False):
        return chains(self, x, t, film, interpret=True)

    monkeypatch.setattr(JWavenet, "_chains_pallas", interpreted)
    monkeypatch.setenv("DIFFNORM_PALLAS_WAVENET", "1")


def test_int8_ddim_slice_matches_jax(monkeypatch):
    """int8 ddim_sample on route fused_layer, bf16, on the CPU (plain
    versions) against JAX's ddim_sample with quant_int8, bf16,
    DIFFNORM_FUSED_BLOCK=1 and DIFFNORM_PALLAS_WAVENET=1, on shared weights
    from the flax-style init (every bias zero, so JAX's Pallas WaveNet bias
    fold, ROADMAP Queue 3, does not matter) and injected noise. Bounds of
    tests/test_variants.py:129-130 (measured: unit agreement 0.970 and
    recon relative L2 0.0083 over the valid frames)."""
    _interpret_chains(monkeypatch)
    monkeypatch.setattr(JL, "_FUSED_BLOCK", True)
    torch.manual_seed(0)
    model = LatentDiffusionModule(
        dim=SLICE["hidden_dim"], latent_dim=SLICE["latent_dim"],
        feature_dim=SLICE["feature_dim"], vocab_size=SLICE["vocab_size"],
        timesteps=SLICE["timesteps"], denoiser_depth=SLICE["denoiser_depth"],
        wavenet_layers=SLICE["wavenet_layers"], wavenet_stacks=SLICE["wavenet_stacks"],
        vae_decoder_depth=SLICE["vae_decoder_depth"],
        vae_decoder_dim_head=SLICE["vae_decoder_dim_head"],
        vae_decoder_heads=SLICE["vae_decoder_heads"], chan_mults=SLICE["chan_mults"],
        quant_int8=True, int8_route="fused_layer")
    params = to_jax_params(model)  # float32; the int8 packs were built from it
    assert all((p == 0).all() for n, p in model.denoiser.wavenet.named_parameters()
               if n.endswith("bias"))
    model = model.to(torch.bfloat16).eval()
    jmodel = LatentDiffusionModel.build_model(Config(**SLICE, quant_int8=True,
                                                     dtype="bfloat16"))
    b = 3
    rng = np.random.default_rng(11)
    feature = rng.normal(size=(b, T, SLICE["feature_dim"])).astype(np.float32)
    mask = _masks(b)
    enc = rng.normal(size=(b, T, SLICE["latent_dim"])).astype(np.float32)
    init = rng.normal(size=(b, T, SLICE["latent_dim"])).astype(np.float32)
    ref_units, ref_recon = jax_ddim_sample(
        jmodel, {"params": params}, jnp.asarray(feature), jnp.asarray(mask),
        jax.random.PRNGKey(0), start_step=6, enc_noise=jnp.asarray(enc),
        init_noise=jnp.asarray(init))

    before = _build.launch_counts["fused_layer"]
    calls = []
    monkeypatch.setattr(TL.fused_ops, "fused_layer",
                        lambda *a: calls.append(1) or fused_layer(*a))
    units, recon = ddim_sample(model, torch.from_numpy(feature), torch.from_numpy(mask),
                               start_step=6, enc_noise=torch.from_numpy(enc),
                               init_noise=torch.from_numpy(init), device="cpu")
    assert len(calls) == 5 and _build.launch_counts["fused_layer"] == before
    u, ru = units.numpy()[mask], np.asarray(ref_units)[mask]
    r, rr = recon.float().numpy()[mask], np.asarray(ref_recon, np.float32)[mask]
    agree = (u == ru).mean()
    rel = np.linalg.norm(r - rr) / np.linalg.norm(rr)
    print(f"int8 slice: unit agreement {agree:.4f}, recon relative L2 {rel:.4f}")
    assert agree > 0.95 and rel < 0.03, (agree, rel)
