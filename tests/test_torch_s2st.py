"""The port's S2ST chain on the CPU against the JAX package, float32: the
conformer encoder, the NAT decoder, mask-predict decoding, the
code-HiFi-GAN and its duration predictor, `s2st_generate` as a whole and the
`cli.s2st` entry point. Shared weights go through `from_jax_variables`, with
non-zero biases and BatchNorm statistics; inputs come from numpy seeds. Tiny
models at the fixture sizes of tests/test_s2st_fused.py."""

import json
import os
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.data.manifest import write_translation_manifest
from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jax_mask_predict
from diffnorm_tpu.generate.s2st import s2st_generate as jax_s2st_generate
from diffnorm_tpu.generate.s2st import strip_and_reduce_tokens as jax_strip_and_reduce
from diffnorm_tpu.models.hifigan import CodeGenerator as JCodeGenerator
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.ops.unit_reduce import expand_units as jax_expand_units
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.generate.s2st import (
    expand_units_padded,
    s2st_generate,
    strip_and_reduce_tokens,
)
from diffnorm_tpu_torch.models.hifigan import CodeGenerator
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.ops.unit_reduce import expand_units
from diffnorm_tpu_torch.weights import (
    from_jax_variables,
    load_npz,
    save_npz,
    to_jax_variables,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

NAR = dict(encoder_dim=32, encoder_ffn_dim=64, encoder_layers=2, encoder_heads=2,
           decoder_dim=32, decoder_ffn_dim=64, decoder_layers=2, decoder_heads=2,
           depthwise_kernel_size=7, conv_channels=32)
VOCAB = 24  # target_code_size 20
VOC = dict(num_embeddings=20, embedding_dim=8, upsample_rates=(2, 2),
           upsample_kernel_sizes=(4, 4), upsample_initial_channel=16,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
           dur_predictor=True, var_pred_hidden_dim=8)


def _perturb(variables, rng, bias_units=True):
    """Non-zero biases and BatchNorm statistics, LayerNorm scales != 1, and
    (bias_units) the shared embedding's special rows zeroed and unit rows
    amplified, so a random decoder emits varied units (the move of
    tests/test_cli_s2st.py)."""

    def walk(tree, path):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = walk(leaf, path + (key,))
                continue
            a = np.array(leaf, dtype=np.float32)
            if key == "bias":
                a = a + rng.normal(scale=0.1, size=a.shape)
            elif key == "scale":
                a = a * (1.0 + rng.normal(scale=0.1, size=a.shape))
            elif key == "mean":
                a = rng.normal(scale=0.2, size=a.shape)
            elif key == "var":
                a = rng.uniform(0.5, 1.5, size=a.shape)
            elif key == "embedding" and path[-1:] == ("embed_tokens",) and bias_units:
                a[:4] = 0.0
                a[4:] *= 10.0
            out[key] = a.astype(np.float32)
        return out

    return {k: walk(v, (k,)) for k, v in variables.items()}


def _src(seed, b=2, t=48):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, t, 80)).astype(np.float32)
    lengths = np.asarray([t, t - 11][:b] + [t - 5] * max(b - 2, 0), np.int32)
    return src, lengths


@pytest.fixture(scope="module")
def nar():
    jm = JNARS2UTModule(vocab_size=VOCAB, **NAR)
    src, lengths = _src(0)
    prev = np.full((2, 12), 4, np.int32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(lengths),
                        jnp.asarray(prev))
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    tm = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, **NAR), variables).eval()
    return jm, variables, tm


@pytest.fixture(scope="module")
def vocoder():
    jv = JCodeGenerator(**VOC)

    def init_all(m, c):
        out = m(c)
        m.predict_durations(c)
        return out

    variables = jv.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32), method=init_all)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(2))
    tv = from_jax_variables(CodeGenerator(**VOC), variables).eval()
    return jv, variables, tv


def test_variables_round_trip_with_batch_stats(nar, tmp_path):
    _, variables, tm = nar
    assert "batch_stats" in variables
    back = to_jax_variables(tm)
    save_npz(str(tmp_path / "nar.npz"), back)
    again = load_npz(str(tmp_path / "nar.npz"))

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            yield from (leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])

    want = dict(leaves(variables))
    got = dict(leaves(again))
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))
    del again["batch_stats"]["encoder"]["layer_0"]["conv_module"]["batch_norm"]["var"]
    with pytest.raises(KeyError, match="running_var"):
        from_jax_variables(NARS2UTModule(vocab_size=VOCAB, **NAR), again)


def test_conformer_encoder_matches_jax(nar):
    jm, variables, tm = nar
    src, lengths = _src(3)
    enc, mask = jm.apply(variables, jnp.asarray(src), jnp.asarray(lengths), method="encode")
    with torch.no_grad():
        got, got_mask = tm.encode(torch.from_numpy(src), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    assert not np.asarray(mask).all()  # the short row pads
    assert np.abs(np.asarray(enc)).max() > 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), atol=1e-4, rtol=1e-4)


def test_decoder_logits_length_head_and_null_context_match_jax(nar):
    jm, variables, tm = nar
    src, lengths = _src(4)
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, VOCAB, size=(2, 14)).astype(np.int32)
    tokens[1, 9:] = 1  # pad
    tokens[:, 0] = 3  # unk
    enc, mask = jm.apply(variables, jnp.asarray(src), jnp.asarray(lengths), method="encode")
    drop = jnp.asarray([False, True])
    cg_enc, cg_mask = jm.apply(variables, enc, mask, drop, method="apply_cg_drop")
    want = [jm.apply(variables, jnp.asarray(tokens), e, m, method="decode")
            for e, m in ((enc, mask), (cg_enc, cg_mask))]
    want_len = jm.apply(variables, enc, mask, method="forward_length")
    t_enc, t_mask = torch.from_numpy(np.array(enc)), torch.from_numpy(np.array(mask))
    with torch.no_grad():
        t_cg = tm.apply_cg_drop(t_enc, t_mask, torch.tensor([False, True]))
        got = [tm.decode(torch.from_numpy(tokens).long(), e, m)
               for e, m in ((t_enc, t_mask), t_cg)]
        got_len = tm.forward_length(t_enc, t_mask)
    np.testing.assert_array_equal(t_cg[1].numpy(), np.asarray(cg_mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_len.numpy(), np.asarray(want_len), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("length_beam, cond_scale", [(1, 1.0), (3, 2.0)])
def test_mask_predict_matches_jax(nar, length_beam, cond_scale):
    jm, variables, tm = nar
    src, lengths = _src(6, b=3)
    kw = dict(max_iter=5, max_len=16, cond_scale=cond_scale, length_beam=length_beam)
    want = jax_mask_predict(types.SimpleNamespace(module=jm), variables, jnp.asarray(src),
                            jnp.asarray(lengths), **kw)
    args = (tm, torch.from_numpy(src), torch.from_numpy(lengths))
    got = mask_predict_decode(*args, **kw)
    fixed = mask_predict_decode(*args, early_exit=False, **kw)
    tokens = np.asarray(want[0])
    assert (tokens >= 4).sum() >= 6  # a varied unit stream, not all specials
    np.testing.assert_array_equal(got[0].numpy(), tokens)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    for a, b in zip(got, fixed):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_vocoder_and_durations_match_jax(vocoder):
    """JAX runs its default path, whose small-channel stages are the packed
    TPU layout (ops/packed_conv.py); the port runs the direct convolutions."""
    jv, variables, tv = vocoder
    code = np.random.default_rng(7).integers(0, 20, size=(3, 13)).astype(np.int32)
    wav = jv.apply(variables, jnp.asarray(code))
    log_dur = jv.apply(variables, jnp.asarray(code), method="log_durations")
    durs = jv.apply(variables, jnp.asarray(code), method="predict_durations")
    with torch.no_grad():
        got = tv(torch.from_numpy(code).long())
        got_log = tv.log_durations(torch.from_numpy(code).long())
        got_durs = tv.predict_durations(torch.from_numpy(code).long())
    assert got.shape == (3, 13 * 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(wav), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got_log.numpy(), np.asarray(log_dur), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got_durs.numpy(), np.asarray(durs))


def test_strip_reduce_and_expand_match_jax():
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 12, size=(4, 20)).astype(np.int32)
    tokens[0] = [4 + 9, 3, 4 + 9, 4 + 7, 4 + 7] + [1] * 15  # a special inside a run
    want = jax_strip_and_reduce(jnp.asarray(tokens))
    got = strip_and_reduce_tokens(torch.from_numpy(tokens).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3][0]) == 2
    durs = rng.integers(0, 4, size=(4, 20))
    out, mask = expand_units_padded(got[2], torch.from_numpy(durs), 48)
    for row in range(4):
        ref = jax_expand_units(got[2][row].numpy(), durs[row])
        np.testing.assert_array_equal(expand_units(got[2][row].numpy(), durs[row]), ref)
        ref = ref[:48]
        np.testing.assert_array_equal(out[row, :len(ref)].numpy(), ref)
        assert int(mask[row].sum()) == len(ref) and not out[row, len(ref):].any()


@pytest.mark.parametrize("dur_prediction", [True, False])
def test_s2st_generate_matches_jax(nar, vocoder, dur_prediction):
    jm, nar_vars, tm = nar
    jv, voc_vars, tv = vocoder
    src, lengths = _src(9, b=3)
    kw = dict(max_iter=4, max_len=16, max_duration=3, dur_prediction=dur_prediction,
              vocoder_chunk=2, return_steps=True)
    want = jax_s2st_generate(types.SimpleNamespace(module=jm), nar_vars, jv, voc_vars,
                             jnp.asarray(src), jnp.asarray(lengths), **kw)
    got = s2st_generate(tm, tv, torch.from_numpy(src), torch.from_numpy(lengths), **kw)
    wav, wav_lengths, units, counts, steps = (np.asarray(w) for w in want)
    assert counts.max() >= 2
    for g, w in zip(got[1:], (wav_lengths, units, counts, steps)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].shape == wav.shape
    np.testing.assert_allclose(got[0].numpy(), wav, atol=1e-5, rtol=1e-4)


# ---- the entry point, on the manifest fixture of tests/test_cli_s2st.py ----

NAR_CFG = dict(
    task="speech_to_speech_fasttranslate",
    arch="nar_s2ut_conformer", criterion="nar_speech_to_unit",
    encoder_layers=1, decoder_layers=1, encoder_embed_dim=32,
    encoder_ffn_embed_dim=64, encoder_attention_heads=2,
    decoder_attention_heads=2, decoder_embed_dim=32,
    decoder_ffn_embed_dim=64, conv_channels=32,
    depthwise_conv_kernel_size=7, target_code_size=16,
    label_smoothing=0.2, lr=5e-4, max_target_positions=16,
    iter_decode_max_iter=3,
)
VOC_CFG = dict(num_embeddings=16, embedding_dim=8, upsample_rates=[4, 2],
               upsample_kernel_sizes=[8, 4], upsample_initial_channel=16,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]])


def _read_wav(path):
    with wave.open(path) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return pcm.astype(np.float32) / 32767.0


def test_cli_matches_jax_cli(tmp_path):
    import orbax.checkpoint as ocp

    from diffnorm_tpu.cli import s2st as jax_s2st
    from diffnorm_tpu.config import Config
    from diffnorm_tpu.models.hifigan import CodeHiFiGANVocoder
    from diffnorm_tpu.registry import TASKS
    from diffnorm_tpu_torch.cli import s2st

    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        t = int(rng.integers(36, 56))
        np.save(tmp_path / f"utt{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
        units = rng.integers(0, 16, size=t // 6 + 2)
        rows.append({"id": f"utt{i}", "src_audio": str(tmp_path / f"utt{i}.npy"),
                     "src_n_frames": t, "tgt_audio": " ".join(map(str, units)),
                     "tgt_n_frames": len(units)})
    write_translation_manifest(str(tmp_path / "test.tsv"), rows)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump({
        "input_feat_per_channel": 80,
        "transforms": {"*": ["utterance_cmvn"]}}))

    cfg = Config(data=str(tmp_path), **NAR_CFG)
    task = TASKS.get("speech_to_speech_fasttranslate").setup_task(cfg)
    task.load_dataset("test")
    ds = task.dataset("test")
    batch0 = ds.collater([ds[0]])
    batch0.setdefault("prev_target", batch0["target"])
    variables = task.init_variables(task.build_model(), jax.random.PRNGKey(0), batch0)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(3))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "nar_ck"), variables)
    ckptr.wait_until_finished()
    (tmp_path / "voc_cfg.json").write_text(json.dumps(VOC_CFG))
    voc = CodeHiFiGANVocoder.from_config(VOC_CFG, rng=jax.random.PRNGKey(1))
    voc_vars = _perturb(jax.device_get(dict(voc.variables)), np.random.default_rng(4))
    ckptr.save(str(tmp_path / "voc_ck"), voc_vars)
    ckptr.wait_until_finished()
    save_npz(str(tmp_path / "nar.npz"), variables)
    save_npz(str(tmp_path / "voc.npz"), voc_vars)

    assert jax_s2st.main(Config(
        data=str(tmp_path), path=str(tmp_path / "nar_ck"), cpu=True, gen_subset="test",
        vocoder=str(tmp_path / "voc_ck"), vocoder_cfg=str(tmp_path / "voc_cfg.json"),
        results_path=str(tmp_path / "jax"), batch_size=3, **NAR_CFG)) == 0
    assert s2st.main([
        str(tmp_path), "--cpu", "--params-npz", str(tmp_path / "nar.npz"),
        "--vocoder-npz", str(tmp_path / "voc.npz"),
        "--vocoder-cfg", str(tmp_path / "voc_cfg.json"),
        "--results-path", str(tmp_path / "port"), "--batch-size", "3",
        "--target-code-size", "16", "--encoder-embed-dim", "32",
        "--encoder-ffn-embed-dim", "64", "--encoder-layers", "1",
        "--encoder-attention-heads", "2", "--decoder-layers", "1",
        "--decoder-attention-heads", "2", "--conv-channels", "32",
        "--depthwise-conv-kernel-size", "7", "--max-target-positions", "16",
        "--iter-decode-max-iter", "3"]) == 0

    want = (tmp_path / "jax" / "s2st-test.unit").read_text().splitlines()
    got = (tmp_path / "port" / "s2st-test.unit").read_text().splitlines()
    assert got == want
    assert sorted(line.split("|")[0] for line in got) == [f"utt{i}" for i in range(4)]
    assert sum(len(line.split("|")[1].split()) for line in got) >= 8
    for i in range(4):
        a = _read_wav(os.path.join(tmp_path, "port", f"utt{i}_pred.wav"))
        b = _read_wav(os.path.join(tmp_path, "jax", f"utt{i}_pred.wav"))
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, atol=2 / 32767)


def test_vocoder_loaders_default_to_the_card(vocoder, tmp_path):
    """`load_vocoder` and `CodeHiFiGANVocoder.from_config` run on the card
    unless the CPU is asked for: without CUDA, a call without `device`
    raises; with device="cpu" both load and run on the CPU (the loaded one
    with the weights of the .npz)."""
    from diffnorm_tpu_torch.cli.generate_waveform import load_vocoder
    from diffnorm_tpu_torch.models.hifigan import CodeHiFiGANVocoder

    _, variables, tv = vocoder
    cfg = dict(num_embeddings=VOC["num_embeddings"], embedding_dim=VOC["embedding_dim"],
               upsample_rates=list(VOC["upsample_rates"]),
               upsample_kernel_sizes=list(VOC["upsample_kernel_sizes"]),
               upsample_initial_channel=VOC["upsample_initial_channel"],
               resblock_kernel_sizes=list(VOC["resblock_kernel_sizes"]),
               resblock_dilation_sizes=[list(d) for d in VOC["resblock_dilation_sizes"]],
               dur_predictor_params={"var_pred_hidden_dim": VOC["var_pred_hidden_dim"]})
    cfg_path = tmp_path / "voc.json"
    cfg_path.write_text(json.dumps(cfg))
    save_npz(str(tmp_path / "voc.npz"), variables)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_vocoder(str(tmp_path / "voc.npz"), str(cfg_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            CodeHiFiGANVocoder.from_config(cfg)

    code = torch.from_numpy(np.random.default_rng(8).integers(0, 20, size=(2, 9))).long()
    loaded = load_vocoder(str(tmp_path / "voc.npz"), str(cfg_path), device="cpu").module
    fresh = CodeHiFiGANVocoder.from_config(cfg, device="cpu").module
    for module in (loaded, fresh):
        assert {p.device.type for p in module.parameters()} == {"cpu"}
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(code).numpy(), tv(code).numpy())
        assert fresh(code).shape == (2, 9 * 4)
        assert loaded.predict_durations(code).shape == (2, 9)
