"""The int8 vocoder of the port (models/hifigan.py `int8_vocoder`,
`int8_same_conv`, `calibrating`) against JAX's packed int8 vocoder
(ops/packed_conv.py with `_INT8` on, as tests/test_packed_vocoder.py:94-182
turns it on) on the CPU, float32, on shared weights and inputs: one conv's
int32 sums exact and its output equal but for the dequant, the generator
dynamic and static at lengths its packing pads (not divisible by P =
128 // C), the calibrated amaxes, and JAX's error bounds against the float
vocoder (< 0.05 dynamic, < 0.06 static)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from diffnorm_tpu.models.hifigan import HifiGanGenerator as JGenerator
from diffnorm_tpu.ops import packed_conv
from diffnorm_tpu.ops.packed_conv import pack, packed_same_conv, unpack
from diffnorm_tpu.ops.quant import calibrate_apply
from diffnorm_tpu_torch.cli import generate_waveform
from diffnorm_tpu_torch.data.audio import read_audio
from diffnorm_tpu_torch.models import hifigan
from diffnorm_tpu_torch.models.hifigan import (
    CodeGenerator,
    CodeHiFiGANVocoder,
    HifiGanGenerator,
    int8_same_conv,
)
from diffnorm_tpu_torch.ops import quant as quant_ops
from diffnorm_tpu_torch.weights import from_jax_params, save_npz, to_jax_variables
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

# the stages: 32 channels (P = 4) at 2T, 16 (P = 8) at 4T; T = 37 pads both
GEN = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=64,
           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 3)))
IN_DIM, B, T = 16, 2, 37
# the two generators differ in float32's order of the transposed convs'
# sums, which can move an activation across a rounding boundary of the
# int8 codes downstream; measured: outputs within 4.9e-7 of the waveform's
# scale, dynamic and static, the amaxes within 1.8e-7 relative
OUT_TOL, AMAX_RTOL = 1e-5, 1e-6


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


@pytest.mark.parametrize("k,d,c,p,t", [(3, 1, 16, 8, 64), (7, 3, 32, 4, 44),
                                       (11, 5, 16, 8, 40)])
def test_int8_conv_is_jax_packed_int8(k, d, c, p, t):
    """One W8A8 SAME conv: the port's int32 sums equal an int64 numpy
    convolution of JAX's codes, and the output equals JAX's packed int8
    conv but for the dequant's rounding (1e-6 relative)."""
    rng = np.random.default_rng(k + d)
    x = rng.normal(size=(2, t, c)).astype(np.float32)
    kernel = (rng.normal(size=(k, c, c)) * 0.2).astype(np.float32)  # flax [k, in, out]
    bias = (rng.normal(size=(c,)) * 0.05).astype(np.float32)
    want = np.asarray(unpack(packed_same_conv(pack(jnp.asarray(x), p), jnp.asarray(kernel),
                                              jnp.asarray(bias), p, d, quant=True), p))
    conv = nn.Conv1d(c, c, k, dilation=d, padding=(k * d - d) // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(2, 1, 0))
        conv.bias.copy_(torch.from_numpy(bias))
    with torch.no_grad():
        got = int8_same_conv(torch.from_numpy(x).transpose(1, 2), conv).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    ks = np.abs(kernel).max() / np.float32(127.0)
    xs = np.abs(x).max() / np.float32(127.0)
    kq = np.round(kernel / ks).astype(np.int64)
    xq = np.round(x / xs).astype(np.int64)
    pad = (k - 1) // 2 * d
    xp = np.pad(xq, ((0, 0), (pad, pad), (0, 0)))
    oracle = sum(xp[:, j * d:j * d + t] @ kq[j] for j in range(k))
    wq = torch.round(torch.from_numpy(kernel).permute(2, 1, 0) / torch.tensor(ks)).to(torch.int8)
    cols = torch.cat([torch.from_numpy(xp[:, j * d:j * d + t]).to(torch.int8)
                      for j in range(k)], dim=-1)
    acc = quant_ops.int_mm(cols.reshape(-1, k * c), wq.permute(0, 2, 1).reshape(c, -1))
    np.testing.assert_array_equal(acc.numpy().reshape(oracle.shape), oracle)


@pytest.fixture(scope="module")
def generators():
    """JAX's generator, its variables, an input of T = 37 frames, and the
    port's generator on the same weights."""
    jgen = JGenerator(in_dim=IN_DIM, **GEN)
    x = np.random.default_rng(0).normal(size=(B, T, IN_DIM)).astype(np.float32)
    variables = jax.device_get(jgen.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32),
        variables["params"])
    tgen = from_jax_params(HifiGanGenerator(IN_DIM, **GEN), params).eval()
    return jgen, {"params": params}, x, tgen


def test_int8_blocks_are_the_packed_stages(generators):
    _, _, _, tgen = generators
    assert sorted(tgen.int8_blocks()) == ["packed_0_0", "packed_0_1", "packed_1_0", "packed_1_1"]
    for i, ch in ((0, 32), (1, 16)):
        assert (T * 2 ** (i + 1)) % (128 // ch) != 0  # JAX pads this stage


def test_dynamic_int8_generator_matches_jax(generators, monkeypatch):
    """Dynamic per-tensor scales on every narrow-stage conv: the port's
    output against JAX's packed int8 generator, and both within JAX's
    bound (< 0.05) of the float vocoder."""
    jgen, variables, x, tgen = generators
    ref = np.asarray(jgen.apply(variables, jnp.asarray(x)))
    monkeypatch.setattr(packed_conv, "_INT8", True)
    want = np.asarray(jgen.apply(variables, jnp.asarray(x)))
    tgen.set_int8("dynamic")
    try:
        with torch.no_grad():
            got = tgen(torch.from_numpy(x)).numpy()
            tgen.set_int8("off")
            flt = tgen(torch.from_numpy(x)).numpy()
    finally:
        tgen.set_int8("off")
    np.testing.assert_allclose(flt, ref, atol=1e-5)
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()
    assert _rel(got, ref) < 0.05 and _rel(want, ref) < 0.05
    assert np.abs(got - flt).max() > 1e-5  # the int8 path ran


def test_static_int8_generator_matches_jax(generators, monkeypatch):
    """Calibration records max|lrelu(.)| before each conv (2 per dilation)
    as JAX's calibrate_apply does; the static output tracks JAX's (< 0.06
    of the float vocoder, JAX's bound); perturbed amaxes change it (they
    are read); a calibrated block ignores a second calibration."""
    jgen, variables, x, tgen = generators
    ref = np.asarray(jgen.apply(variables, jnp.asarray(x)))
    monkeypatch.setattr(packed_conv, "_INT8", True)
    v_cal = calibrate_apply(jgen.apply, variables, jnp.asarray(x))
    jstats = jax.device_get(v_cal["quant_stats"])
    monkeypatch.setenv("DIFFNORM_INT8_STATIC", "1")
    want = np.asarray(jgen.apply(v_cal, jnp.asarray(x)))
    monkeypatch.delenv("DIFFNORM_INT8_STATIC")

    tgen.set_int8("static")
    try:
        with torch.no_grad(), hifigan.calibrating(tgen):
            tgen(torch.from_numpy(x))
        stats = tgen.int8_stats()
        assert sorted(stats) == sorted(jstats)
        for name, amax in jstats.items():
            assert stats[name].shape == (2 * len(GEN["resblock_dilation_sizes"][0]),)
            np.testing.assert_allclose(stats[name], np.asarray(amax), rtol=AMAX_RTOL)
        with torch.no_grad():
            got = tgen(torch.from_numpy(x)).numpy()
            with hifigan.calibrating(tgen):  # static first: calibrated blocks keep theirs
                tgen(torch.from_numpy(x) * 3.0)
        for name, amax in tgen.int8_stats().items():
            np.testing.assert_array_equal(amax, stats[name])
        tgen.load_int8_stats({k: v * 7.0 for k, v in stats.items()})
        with torch.no_grad():
            bad = tgen(torch.from_numpy(x)).numpy()
    finally:
        tgen.set_int8("off")
        for block in tgen.int8_blocks().values():
            block.act_amax = None
    assert np.abs(got - want).max() <= OUT_TOL * np.abs(want).max()
    assert _rel(got, ref) < 0.06 and _rel(want, ref) < 0.06
    assert np.abs(bad - got).max() > 1e-5


VOC_CFG = dict(num_embeddings=20, embedding_dim=16, upsample_rates=[2, 2],
               upsample_kernel_sizes=[4, 4], upsample_initial_channel=64,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]],
               dur_predictor_params={"var_pred_hidden_dim": 8})


def test_vocoder_and_cli_take_the_int8_setting(tmp_path):
    """The setting is the CodeGenerator's (off by default): from_config
    with "static" calibrates on JAX's seeded batch (bench.py:959-967), and
    cli.generate_waveform --int8-vocoder writes waveforms close to the
    float ones."""
    torch.manual_seed(0)
    module = CodeGenerator(num_embeddings=20, embedding_dim=16, upsample_rates=(2, 2),
                           upsample_kernel_sizes=(4, 4), upsample_initial_channel=64,
                           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                           dur_predictor=True, var_pred_hidden_dim=8)
    assert all(b.int8 == "off" for b in module.generator.int8_blocks().values())
    variables = to_jax_variables(module)
    voc = CodeHiFiGANVocoder.from_config(VOC_CFG, variables, device="cpu",
                                         int8_vocoder="static")
    stats = voc.module.generator.int8_stats()
    assert sorted(stats) == ["packed_0_0", "packed_1_0"]
    assert all(np.all(v > 0) for v in stats.values())
    import json

    (tmp_path / "voc.json").write_text(json.dumps(VOC_CFG))
    save_npz(str(tmp_path / "voc.npz"), variables)
    (tmp_path / "units.txt").write_text("a|3 4 5 6 7 8 9 3 3 2\nb|1 2 3\n")
    outs = {}
    for mode in ("off", "dynamic", "static"):
        assert generate_waveform.main(["--cpu", "--in-code-file", str(tmp_path / "units.txt"),
                                       "--vocoder", str(tmp_path / "voc.npz"), "--vocoder-cfg",
                                       str(tmp_path / "voc.json"), "--results-path",
                                       str(tmp_path / mode), "--int8-vocoder", mode]) == 0
        outs[mode] = read_audio(str(tmp_path / mode / "0_pred.wav"))[0]
    for mode in ("dynamic", "static"):
        assert outs[mode].shape == outs["off"].shape
        assert _rel(outs[mode].astype(np.float64), outs["off"].astype(np.float64)) < 0.06
