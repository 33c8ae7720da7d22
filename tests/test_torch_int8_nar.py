"""The port's int8 NAR decode with static scales (JAX's `bench.py --e2e`
default and `cli.generate --quant-int8 --quant-int8-static`) on the CPU
against the JAX package, float32, at the tiny widths of
tests/test_variants.py:157-275 (2 + 2 layers, dim 32): the calibrated
sites and their amax, the int8 dynamic and static mask-predict decodes,
`cli.generate` and `s2st_generate`. Shared weights go through
`from_jax_variables`; inputs come from numpy seeds.

The int8 decodes of the two packages share their arithmetic (exact int32
sums, JAX's rounding), but the float32 activations that reach each site
differ by an ulp here and there (LayerNorm and attention sums in another
order), which moves an int8 code across a rounding boundary now and then;
at dim 32 the random decoder's logit margins are small, so such a flip can
change an argmax. The decodes are held to >= 0.98 of positions equal, and
each to JAX's own bound against the float decode (> 0.75)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jax_mask_predict
from diffnorm_tpu.generate.s2st import s2st_generate as jax_s2st_generate
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.ops.quant import calibrate_apply
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.generate.s2st import s2st_generate
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule, calibrate_act_scales
from diffnorm_tpu_torch.ops.quant import quant_sites, set_static_scales
from diffnorm_tpu_torch.weights import from_jax_variables, to_jax_variables
from tests.test_torch_eval import WIDTH_FLAGS, _generate_lines, generate_corpus  # noqa: F401
from tests.test_torch_s2st import NAR, VOCAB, _perturb, _src, vocoder  # noqa: F401
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

AGREE = 0.98  # port int8 against JAX int8, share of equal positions
FLOAT_AGREE = 0.75  # int8 against the float decode (tests/test_variants.py:188)
N_SITES = 2 * 8 + 2 * 10  # 8 per conformer layer, 10 per decoder layer
DECODE = dict(max_iter=4, max_len=16)


def _target(seed, b, length=14):
    """Seeded unit targets [B, length] (dictionary ids, EOS at the end),
    the second row shorter and padded."""
    rng = np.random.default_rng(seed)
    tgt = np.full((b, length), 1, np.int32)
    for row in range(b):
        n = length if row != 1 else length - 5
        tgt[row, :n - 1] = rng.integers(4, VOCAB, size=n - 1)
        tgt[row, n - 1] = 2
    return tgt


@pytest.fixture(scope="module")
def int8_nar():
    """JAX's float and int8 modules on one perturbed variables tree, JAX's
    calibrated tree (calibrate_apply on the CLI's canvas), and the port's
    float and int8 models from the same tree."""
    jm = JNARS2UTModule(vocab_size=VOCAB, **NAR)
    jq = JNARS2UTModule(vocab_size=VOCAB, quant_int8=True, **NAR)
    src, lengths = _src(0)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(lengths),
                        jnp.asarray(np.full((2, 12), 4, np.int32)))
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    tgt = _target(2, b=2)
    canvas = np.where(tgt != 1, 3, 1).astype(np.int32)
    calibrated = calibrate_apply(jq.apply, variables, jnp.asarray(src), jnp.asarray(lengths),
                                 jnp.asarray(canvas), tgt_tokens=jnp.asarray(tgt),
                                 deterministic=True)
    tm = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, **NAR), variables).eval()
    tq = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, quant_int8=True, **NAR),
                            variables).eval()
    return dict(jm=jm, jq=jq, variables=variables, calibrated=jax.device_get(calibrated),
                tm=tm, tq=tq, calib_inputs=(src, lengths, tgt))


def _calibrated_port(int8_nar):
    """A fresh int8 port model calibrated by the port on the inputs JAX's
    tree was calibrated on, static scales on."""
    tq = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, quant_int8=True, **NAR),
                            int8_nar["variables"]).eval()
    src, lengths, tgt = (torch.from_numpy(a) for a in int8_nar["calib_inputs"])
    assert calibrate_act_scales(tq, src, lengths, tgt.long()) == N_SITES
    set_static_scales(tq, True)
    return tq


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def test_calibrated_sites_and_amax_match_jax(int8_nar):
    tq = _calibrated_port(int8_nar)
    assert not tq.training
    want = {".".join(path[:-1]): float(v) for path, v in
            _flat(int8_nar["calibrated"]["quant_stats"])}
    got = {name: float(site.act_amax) for name, site in quant_sites(tq)}
    assert len(want) == N_SITES and sorted(got) == sorted(want)
    for name, amax in want.items():
        assert amax > 0 and abs(got[name] - amax) <= 1e-6 * amax, (name, got[name], amax)
    # q, k and v quantize one input at three sites (no pre_quant sharing)
    attn = "encoder.layer_0.self_attn."
    assert got[attn + "linear_q"] == got[attn + "linear_k"] == got[attn + "linear_v"]
    # the amax travels as quant_stats and reloads
    back = {".".join(path[:-1]): float(v) for path, v in
            _flat(to_jax_variables(tq)["quant_stats"])}
    assert back == got
    linear_pos = tq.encoder.layer_0.self_attn.linear_pos
    assert not linear_pos.quant and not tq.encoder.linear.quant


def _agreement(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("scales", ["dynamic", "static"])
def test_int8_decode_matches_jax(int8_nar, scales, monkeypatch, capsys):
    src, lengths = _src(11, b=3)
    jsrc, jlen = jnp.asarray(src), jnp.asarray(lengths)
    tsrc, tlen = torch.from_numpy(src), torch.from_numpy(lengths)
    float_tokens = np.asarray(jax_mask_predict(types.SimpleNamespace(module=int8_nar["jm"]),
                                               int8_nar["variables"], jsrc, jlen, **DECODE)[0])
    if scales == "static":
        tq = _calibrated_port(int8_nar)
        jvars = int8_nar["calibrated"]
        monkeypatch.setenv("DIFFNORM_INT8_STATIC", "1")
    else:
        tq, jvars = int8_nar["tq"], int8_nar["variables"]
    want = np.asarray(jax_mask_predict(types.SimpleNamespace(module=int8_nar["jq"]), jvars,
                                       jsrc, jlen, **DECODE)[0])
    monkeypatch.delenv("DIFFNORM_INT8_STATIC", raising=False)
    got = mask_predict_decode(tq, tsrc, tlen, **DECODE)[0].numpy()
    agree = _agreement(got, want)
    with capsys.disabled():
        print(f"\nint8 {scales} decode: port against JAX {agree:.4f} of positions equal")
    assert agree >= AGREE
    assert (want >= 4).sum() >= 6
    assert _agreement(want, float_tokens) > FLOAT_AGREE
    assert _agreement(got, float_tokens) > FLOAT_AGREE
    port_float = mask_predict_decode(int8_nar["tm"], tsrc, tlen, **DECODE)[0].numpy()
    np.testing.assert_array_equal(port_float, float_tokens)


def test_cli_generate_int8_static_matches_jax_cli(generate_corpus, monkeypatch, capsys):  # noqa: F811
    """`cli.generate --quant-int8 --quant-int8-static` against JAX's CLI under
    the same flags on one seeded corpus: ids equal, the H- units equal in
    >= 0.98 of positions, and the calibration line logged."""
    from diffnorm_tpu.cli import generate as jax_generate
    from diffnorm_tpu.config import Config
    from diffnorm_tpu_torch.cli import generate
    from tests.test_torch_s2st import NAR_CFG

    root = generate_corpus
    out = root / "int8_static"
    monkeypatch.delenv("DIFFNORM_INT8_STATIC", raising=False)  # JAX's CLI sets it
    assert jax_generate.main(Config(
        data=str(root), path=str(root / "nar_ck"), cpu=True, gen_subset="test",
        max_tokens=120, quant_int8=True, quant_int8_static=True,
        results_path=str(out / "jax"), **NAR_CFG)) == 0
    capsys.readouterr()
    assert generate.main([str(root), "--cpu", "--path", str(root / "nar.npz"), "--gen-subset",
                          "test", "--max-tokens", "120", *WIDTH_FLAGS, "--quant-int8",
                          "--quant-int8-static", "--results-path", str(out / "port")]) == 0
    log = capsys.readouterr().err
    assert "calibrated static int8 activation scales on the first batch" in log
    want = _generate_lines(out / "jax" / "generate-test.txt")
    got = _generate_lines(out / "port" / "generate-test.txt")
    assert [line.split("\t")[0] for line in got] == [line.split("\t")[0] for line in want]
    same = total = 0
    for g, w in zip(got, want):
        if g.startswith("H-"):
            gu, wu = g.split("\t")[2].split(), w.split("\t")[2].split()
            same += sum(a == b for a, b in zip(gu, wu))
            total += max(len(gu), len(wu))
    assert total >= 10
    with capsys.disabled():
        print(f"\ncli.generate int8 static: port against JAX {same / total:.4f} of units equal")
    assert same / total >= AGREE


def test_quant_int8_static_alone_changes_nothing(generate_corpus, capsys):  # noqa: F811
    """--quant-int8-static without --quant-int8 decodes the float model, as
    in JAX (generate.py:540-544): no calibration, the float run's file."""
    from diffnorm_tpu_torch.cli import generate

    root = generate_corpus
    base = [str(root), "--cpu", "--path", str(root / "nar.npz"), "--gen-subset", "test",
            "--max-tokens", "120", *WIDTH_FLAGS]
    assert generate.main(base + ["--results-path", str(root / "float")]) == 0
    assert generate.main(base + ["--quant-int8-static",
                                 "--results-path", str(root / "static_alone")]) == 0
    assert "calibrated static" not in capsys.readouterr().err
    assert ((root / "static_alone" / "generate-test.txt").read_text()
            == (root / "float" / "generate-test.txt").read_text())


def test_s2st_generate_with_calibrated_int8_model_matches_jax(int8_nar, vocoder,  # noqa: F811
                                                              monkeypatch):
    jv, voc_vars, tv = vocoder
    src, lengths = _src(9, b=3)
    kw = dict(max_iter=4, max_len=16, max_duration=3, vocoder_chunk=2, return_steps=True)
    monkeypatch.setenv("DIFFNORM_INT8_STATIC", "1")
    want = jax_s2st_generate(types.SimpleNamespace(module=int8_nar["jq"]),
                             int8_nar["calibrated"], jv, voc_vars,
                             jnp.asarray(src), jnp.asarray(lengths), **kw)
    monkeypatch.delenv("DIFFNORM_INT8_STATIC")
    got = s2st_generate(_calibrated_port(int8_nar), tv, torch.from_numpy(src),
                        torch.from_numpy(lengths), **kw)
    wav, wav_lengths, units, counts, steps = (np.asarray(w) for w in want)
    assert counts.max() >= 2 and got[0].shape == wav.shape
    assert np.isfinite(got[0].numpy()).all()
    # reduced units over the longer of each row's two counts
    n = np.maximum(got[3].numpy(), counts)
    valid = np.arange(units.shape[1])[None, :] < n[:, None]
    agree = ((got[2].numpy() == units) & valid).sum() / valid.sum()
    assert agree >= AGREE, agree
