"""The port's int8 static-scale module route (JAX's DDIM serving headline,
bench.py:38-49) against the JAX package on the CPU: static and per-tensor
activation quantization bit for bit, the int8 module convs and products
under JAX's knobs, calibrated scales site by site, static `ddim_sample`, and
`--quant-int8-static` in the CLI. JAX's knobs are toggled on
`diffnorm_tpu.ops.quant` / `models.layers` by monkeypatch, as
tests/test_torch_quant.py does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffnorm_tpu.models.layers as JL
from diffnorm_tpu.config import Config
from diffnorm_tpu.models.diffusion import LatentDiffusionModel
from diffnorm_tpu.models.diffusion import calibrate_act_scales as jax_calibrate
from diffnorm_tpu.models.diffusion import ddim_sample as jax_ddim_sample
from diffnorm_tpu.ops import quant as jq
from diffnorm_tpu_torch.cli import diff_norm_synthesis
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.models import layers as TL
from diffnorm_tpu_torch.models.diffusion import (
    LatentDiffusionModule,
    calibrate_act_scales,
    ddim_sample,
)
from diffnorm_tpu_torch.ops import quant
from diffnorm_tpu_torch.ops.quant import Int8Knobs
from diffnorm_tpu_torch.weights import from_jax_variables, save_npz, to_jax_variables
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

# the configuration of tests/test_variants.py:191-228
VARIANT = dict(hidden_dim=64, latent_dim=3, feature_dim=24, timesteps=50, vocab_size=52,
               denoiser_depth=2, wavenet_layers=3, wavenet_stacks=2, chan_mults=[4])
START = 12


def _set_jax_knobs(monkeypatch, knobs: Int8Knobs):
    monkeypatch.setattr(jq, "_W_SCALAR", knobs.wscalar)
    monkeypatch.setattr(jq, "_A_SCALAR", knobs.ascalar)
    monkeypatch.setattr(jq, "_QUANT_BF16", knobs.quant_bf16)
    monkeypatch.setattr(jq, "_DEQ_BF16", knobs.deq_bf16)
    monkeypatch.setattr(JL, "_CONVCAT", knobs.convcat)


def _activations(dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 17, 64)) * rng.uniform(0.1, 30, (3, 17, 1))
    x[0, 2] = 0.0
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return jx, tx


@pytest.mark.parametrize("quant_bf16", [False, True], ids=["quant_f32", "quant_bf16"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_static_and_per_tensor_quantize_match_jax_bit_for_bit(monkeypatch, dtype, quant_bf16):
    monkeypatch.setattr(jq, "_QUANT_BF16", quant_bf16)
    jx, tx = _activations(dtype)
    for amax in (7.25, 300.0, 0.0):  # 300: codes clamp at 127; 0: the 1e-10 floor
        ref_q, ref_a = (np.asarray(a, np.float32) for a in
                        jq.quantize_act_static(jx, jnp.float32(amax)))
        got_q, got_a = quant.quantize_act_static(tx, torch.tensor(amax), bf16=quant_bf16)
        assert got_q.dtype == torch.int8 and got_a.shape == (1, 1, 1)
        np.testing.assert_array_equal(got_q.numpy(), ref_q)
        np.testing.assert_array_equal(got_a.float().numpy(), ref_a)
    for per_tensor in (False, True):
        monkeypatch.setattr(jq, "_A_SCALAR", per_tensor)
        ref_q, ref_a = (np.asarray(a, np.float32) for a in jq.quantize_act(jx))
        got_q, got_a = quant.quantize_act(tx, per_tensor=per_tensor, bf16=quant_bf16)
        np.testing.assert_array_equal(got_q.numpy(), ref_q)
        np.testing.assert_array_equal(got_a.float().numpy(), ref_a.reshape(got_a.shape))
        want_dtype = torch.bfloat16 if quant_bf16 and dtype == jnp.bfloat16 else torch.float32
        assert got_a.dtype == want_dtype


KNOB_CASES = {
    "headline": quant.HEADLINE_KNOBS,
    "headline_convcat": Int8Knobs(wscalar=True, ascalar=True, convcat=True),
    "wscalar": Int8Knobs(wscalar=True),
    "ascalar_f32_dequant": Int8Knobs(ascalar=True, deq_bf16=False),
    "quant_bf16": Int8Knobs(wscalar=True, quant_bf16=True),
}


@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_int8_conv_and_dense_under_knobs_match_jax_module(monkeypatch, case):
    """CausalConv1d(quant) and QDense in bf16 under each knob set, with and
    without a static scale, bit for bit against the JAX modules."""
    knobs = KNOB_CASES[case]
    _set_jax_knobs(monkeypatch, knobs)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 9, 24)) * 3.0, jnp.bfloat16)
    xt = torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
    for static in (False, True):
        monkeypatch.setenv("DIFFNORM_INT8_STATIC", "1" if static else "0")
        stats = {"quant_stats": {"act_amax": jnp.float32(9.5)}} if static else {}
        for dilation in (1, 4):
            jm = JL.CausalConv1d(features=16, kernel_size=3, dilation=dilation, quant=True,
                                 dtype=jnp.bfloat16)
            params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x)["params"])
            params["bias"] = rng.normal(size=16).astype(np.float32)
            ref = np.asarray(jm.apply({"params": params, **stats}, x), np.float32)
            tm = TL.CausalConv1d(24, 16, 3, dilation, quant=True, knobs=knobs)
            from_jax_variables(tm, {"params": params, **stats}).to(torch.bfloat16)
            quant.set_static_scales(tm, static)
            with torch.no_grad():
                np.testing.assert_array_equal(tm(xt).float().numpy(), ref)
        jd = JL.QDense(features=40, quant=True, dtype=jnp.bfloat16)
        params = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(1), x)["params"])
        ref = np.asarray(jd.apply({"params": params, **stats}, x), np.float32)
        td = from_jax_variables(TL.Dense(24, 40, quant=True, knobs=knobs),
                                {"params": params, **stats}).to(torch.bfloat16)
        quant.set_static_scales(td, static)
        with torch.no_grad():
            np.testing.assert_array_equal(td(xt).float().numpy(), ref)


def test_a_site_without_stats_quantizes_dynamically():
    """Static mode on a site that holds no amax is dynamic quantization, as
    JAX's site_quantize falls back when a site has no stats; a recorded amax
    then takes over."""
    site = TL.Dense(24, 8, quant=True, knobs=quant.HEADLINE_KNOBS)
    quant.set_static_scales(site)
    x = torch.randn(2, 5, 24) * 4
    for want in (quant.quantize_act(x, per_tensor=True),
                 quant.quantize_act_static(x, torch.tensor(2.0))):
        got = site.quantize_input(x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        site.act_amax = torch.tensor(2.0)
    with quant.calibrating(site):
        site.quantize_input(x * 100)  # calibration quantizes dynamically and records
    assert site.act_static and not site.act_calibrating
    assert site.act_amax.item() == pytest.approx((x * 100).abs().max().item(), rel=1e-6)


@pytest.fixture(scope="module")
def variant_init():
    """JAX's init of the float model of tests/test_variants.py, once for the
    module (it compiles the whole program; the int8 knobs do not reach the
    float model)."""
    jf = LatentDiffusionModel.build_model(Config(**VARIANT))
    feat, mask = _variant_inputs(np.random.default_rng(0))
    return jax.device_get(jf.module.init({"params": jax.random.PRNGKey(0)}, feat,
                                         jnp.asarray(mask), jax.random.PRNGKey(0),
                                         deterministic=True))


def _variant_inputs(rng):
    feat = jnp.asarray(rng.normal(size=(4, 32, 24)), jnp.float32)
    mask = np.ones((4, 32), bool)
    mask[1, 27:] = False
    return feat, mask


def _variant_models(knobs: Int8Knobs, v):
    """The JAX float and int8 models of tests/test_variants.py with biases
    made non-zero on the float model's init `v`, and the port's int8
    static-route model on those weights."""
    jf = LatentDiffusionModel.build_model(Config(**VARIANT))
    jq_model = LatentDiffusionModel.build_model(Config(**VARIANT, quant_int8=True))
    rng = np.random.default_rng(0)
    feat, mask = _variant_inputs(rng)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + (0.05 * rng.normal(size=a.shape) if a.ndim == 1
                                    else 0.0)).astype(np.float32), v["params"])
    torch.manual_seed(0)
    model = LatentDiffusionModule(
        dim=VARIANT["hidden_dim"], latent_dim=VARIANT["latent_dim"],
        feature_dim=VARIANT["feature_dim"], vocab_size=VARIANT["vocab_size"],
        timesteps=VARIANT["timesteps"], denoiser_depth=VARIANT["denoiser_depth"],
        wavenet_layers=VARIANT["wavenet_layers"], wavenet_stacks=VARIANT["wavenet_stacks"],
        chan_mults=VARIANT["chan_mults"], vae_decoder_depth=6, vae_decoder_dim_head=96,
        vae_decoder_heads=8, quant_int8=True, int8_route="module", int8_knobs=knobs)
    from_jax_variables(model, {"params": params})
    assert not model.denoiser.wavenet.chain_kernel  # int8 module convs, JAX's default
    return jf, jq_model, {"params": params}, feat, jnp.asarray(mask), model.eval()


def _flat(tree):
    return {"/".join(k.key for k in path): float(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_draws(key, shape):
    r_a, r_b = jax.random.split(key)
    return (np.asarray(jax.random.normal(r_a, shape, jnp.float32)),
            np.asarray(jax.random.normal(r_b, shape, jnp.float32)))


@pytest.mark.parametrize("convcat", [False, True], ids=["taps", "convcat"])
def test_calibration_and_static_ddim_match_jax(monkeypatch, variant_init, convcat):
    """calibrate_act_scales on JAX's draws records JAX's quant_stats sites
    (names equal) with the same amax within 1e-6 relative; static
    ddim_sample then agrees with JAX's static ddim_sample within
    tests/test_variants.py's bounds (units > 0.95, recon rel. L2 < 0.03)."""
    knobs = Int8Knobs(wscalar=True, ascalar=True, convcat=convcat)
    _set_jax_knobs(monkeypatch, knobs)
    monkeypatch.delenv("DIFFNORM_PALLAS_WAVENET", raising=False)
    jf, jmodel, variables, feat, mask, model = _variant_models(knobs, variant_init)
    shape = (4, 32, VARIANT["latent_dim"])

    v_cal = jax_calibrate(jmodel, variables, feat, mask, jax.random.PRNGKey(3),
                          start_step=START)
    enc, noise = _jax_draws(jax.random.PRNGKey(3), shape)
    n_sites = calibrate_act_scales(model, torch.from_numpy(np.asarray(feat)),
                                   torch.from_numpy(np.asarray(mask)), start_step=START,
                                   enc_noise=torch.from_numpy(enc),
                                   noise=torch.from_numpy(noise))
    ref = _flat(v_cal["quant_stats"])
    got = _flat(to_jax_variables(model)["quant_stats"])
    # 2 stacks x 3 chains x (res_conv, conv) + 3 skip_convs + 2 layers x
    # (attention, to_out, proj_in, conv, proj_out)
    assert n_sites == len(ref) == 25 and set(got) == set(ref)
    for name, amax in ref.items():
        assert got[name] == pytest.approx(amax, rel=1e-6), name

    enc, init = _jax_draws(jax.random.PRNGKey(7), shape)
    monkeypatch.setenv("DIFFNORM_INT8_STATIC", "1")
    ref_units, ref_recon = jax_ddim_sample(
        jmodel, v_cal, feat, mask, jax.random.PRNGKey(7), start_step=START,
        enc_noise=jnp.asarray(enc), init_noise=jnp.asarray(init))
    quant.set_static_scales(model)
    units, recon = ddim_sample(model, torch.from_numpy(np.asarray(feat)),
                               torch.from_numpy(np.asarray(mask)), start_step=START,
                               enc_noise=torch.from_numpy(enc),
                               init_noise=torch.from_numpy(init), device="cpu")
    m = np.asarray(mask)
    agree = (units.numpy()[m] == np.asarray(ref_units)[m]).mean()
    r, rr = recon.numpy()[m], np.asarray(ref_recon)[m]
    rel = np.linalg.norm(r - rr) / np.linalg.norm(rr)
    print(f"static ddim ({'convcat' if convcat else 'taps'}): unit agreement {agree:.4f}, "
          f"recon relative L2 {rel:.2e}")
    assert agree > 0.95 and rel < 0.03, (agree, rel)


def _cli_corpus(tmp_path):
    """A tiny normalizer (params.npz), three utterances' features and
    manifests; returns the CLI arguments that normalize them on the CPU."""
    torch.manual_seed(0)
    kw = dict(dim=16, latent_dim=3, feature_dim=24, vocab_size=20, timesteps=20,
              denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, chan_mults=[4],
              vae_decoder_depth=1, vae_decoder_dim_head=8, vae_decoder_heads=2)
    save_npz(str(tmp_path / "params.npz"),
             to_jax_variables(LatentDiffusionModule(**kw))["params"])
    rng = np.random.default_rng(0)
    (tmp_path / "feat").mkdir()
    rows, lines = [], [str(tmp_path / "feat")]
    for i in range(3):
        t = int(rng.integers(8, 12))
        units = np.repeat(rng.integers(0, 16, size=t // 2 + 1), 2)[:t]
        np.save(tmp_path / "feat" / f"u{i}.feat.npy", rng.normal(size=(t, 24)).astype(np.float32))
        lines.append(f"u{i}.feat.npy\t{t}")
        rows.append({"id": f"u{i}", "src_audio": f"u{i}", "src_n_frames": t,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": t})
    (tmp_path / "feat" / "test.manifest.tsv").write_text("\n".join(lines) + "\n")
    write_translation_manifest(str(tmp_path / "test.tsv"), rows)
    args = [str(tmp_path), "--params-npz", str(tmp_path / "params.npz"),
            "--tgt-feat-dir", str(tmp_path / "feat"), "--output-dir", str(tmp_path / "out"),
            "--splits", "test", "--batch-size", "2", "--cpu", "--start-step", "6",
            "--hidden-dim", "16", "--latent-dim", "3", "--feature-dim", "24",
            "--vocab-size", "20", "--timesteps", "20", "--denoiser-depth", "1",
            "--wavenet-layers", "2", "--wavenet-stacks", "1", "--vae-decoder-depth", "1",
            "--vae-decoder-dim-head", "8", "--vae-decoder-heads", "2", "--chan-mults", "[4]"]
    return args


def _assert_units_written(tmp_path):
    out = (tmp_path / "out" / "test.tsv").read_text().splitlines()[1:]
    assert sorted(line.split("\t")[0] for line in out) == ["u0", "u1", "u2"]
    for line in out:
        assert all(-4 <= int(u) < 16 for u in line.split("\t")[3].split())


def test_cli_quant_int8_static_writes_units_and_logs_sites(tmp_path, capsys):
    """--quant-int8 --quant-int8-static --cpu: calibration on the first
    batch (the site count logged), then every batch sampled with static
    scales; the manifest has every utterance with in-range units."""
    args = _cli_corpus(tmp_path) + ["--quant-int8", "--quant-int8-static"]
    assert diff_norm_synthesis.main(args) == 0
    logged = capsys.readouterr().err
    # 2 chains x (res_conv, conv, skip_conv) + attention, to_out, proj_in, conv, proj_out
    assert logged.count("calibrated static int8 activation scales on the first batch "
                        "(11 sites)") == 1
    _assert_units_written(tmp_path)
    with pytest.raises(ValueError, match="needs --quant-int8"):
        diff_norm_synthesis.main(args[:-2] + ["--quant-int8-static"])


def test_cli_int8_knob_flags_select_the_module_route_knobs(tmp_path, monkeypatch):
    """--int8-convcat and --int8-quant-bf16 put JAX's CONVCAT and QUANT_BF16
    on the int8 module route's knobs (with or without static scales), the
    CLI normalizes with them, and a kernel route refuses them."""
    args = _cli_corpus(tmp_path)
    flags = ["--int8-convcat", "--int8-quant-bf16"]
    parse = diff_norm_synthesis.parse_args
    route, knobs = diff_norm_synthesis.int8_config(
        parse(args + ["--quant-int8", "--quant-int8-static"] + flags))
    assert route == "module" and knobs == Int8Knobs(wscalar=True, ascalar=True,
                                                    quant_bf16=True, convcat=True)
    assert diff_norm_synthesis.int8_config(
        parse(args + ["--quant-int8", "--int8-route", "module", "--int8-convcat"])
    ) == ("module", Int8Knobs(convcat=True))
    for bad in (["--quant-int8"] + flags, ["--int8-quant-bf16"]):
        with pytest.raises(ValueError, match="apply to the int8 module route"):
            diff_norm_synthesis.int8_config(parse(args + bad))
    built = []
    build = diff_norm_synthesis.build_model
    monkeypatch.setattr(diff_norm_synthesis, "build_model",
                        lambda a, d: built.append(build(a, d)) or built[-1])
    assert diff_norm_synthesis.main(args + ["--quant-int8", "--quant-int8-static"] + flags) == 0
    conv = built[0].denoiser.wavenet.chain_blocks(0)[0].conv
    assert conv.knobs.convcat and conv.knobs.quant_bf16
    _assert_units_written(tmp_path)
