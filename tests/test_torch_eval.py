"""The port's evaluation chain on the CPU against the JAX package: BLEU and
WER counters, unit BLEU, mask-predict with forced lengths and forced
iterations, `cli.generate` (NAR mask-predict) line for line, the
code-HiFi-GAN map of fairseq checkpoints and the unit-file vocoder CLI, and
the mel-cepstral distortion. Inputs come from numpy seeds; shared weights go
through `from_jax_variables` / `save_npz`."""

import json
import sys
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.data.manifest import write_translation_manifest
from diffnorm_tpu.eval import bleu as jax_bleu
from diffnorm_tpu.eval import wer as jax_wer
from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jax_mask_predict
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu_torch.eval import bleu, wer
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.weights import from_jax_variables, save_npz
from tests.test_torch_s2st import NAR, NAR_CFG, VOCAB, _perturb, _src
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


def _unit_pairs(seed, n=24):
    """Seeded (ref, hyp) unit strings: partial overlaps, an empty
    hypothesis, an empty reference, a one-unit hypothesis (no 2-grams) and a
    hypothesis sharing no 4-gram with its reference."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        ref = rng.integers(0, 12, size=int(rng.integers(3, 20)))
        hyp = ref.copy()
        flip = rng.random(len(hyp)) < 0.3
        hyp[flip] = rng.integers(0, 12, size=int(flip.sum()))
        hyp = hyp[: max(len(hyp) + int(rng.integers(-3, 4)), 0)]
        pairs.append((" ".join(map(str, ref)), " ".join(map(str, hyp))))
    pairs += [("1 2 3 4", ""), ("", "5 6"), ("7 8 9", "7"), ("1 2 3 4 5", "5 4 3 2 1")]
    return pairs


@pytest.mark.parametrize("subset", ["all", "empty_hyps", "no_4gram"])
def test_bleu_and_wer_counters_match_jax(subset, monkeypatch):
    pairs = _unit_pairs(0)
    if subset == "empty_hyps":
        pairs = [(r, "") for r, _ in pairs[:3]]
    elif subset == "no_4gram":
        pairs = pairs[-2:]
    acc, jacc = bleu.BleuAccumulator(), jax_bleu.BleuAccumulator()
    w, jw = wer.WerAccumulator(), jax_wer.WerAccumulator()
    for r, h in pairs:
        acc.add(r.split(), h.split())
        jacc.add(r.split(), h.split())
        w.add(r, h)
        jw.add(r, h)
    for order in (1, 2, 4):
        assert acc.result_string(order) == jacc.result_string(order)
    assert w.result_string() == jw.result_string()
    refs, hyps = [r for r, _ in pairs], [h for _, h in pairs]
    monkeypatch.setitem(sys.modules, "sacrebleu", None)  # the counters, both sides
    assert bleu.scorer_name() == "counters"
    assert bleu.corpus_bleu(refs, hyps) == jax_bleu.corpus_bleu(refs, hyps)
    if subset == "all":
        assert 0.0 < bleu.corpus_bleu(refs, hyps) < 100.0
    else:
        assert bleu.corpus_bleu(refs, hyps) == 0.0


def test_corpus_bleu_sacrebleu_branch_matches_jax():
    pytest.importorskip("sacrebleu")
    pairs = _unit_pairs(1)
    refs, hyps = [r for r, _ in pairs], [h for _, h in pairs]
    assert bleu.scorer_name() == "sacrebleu"
    assert bleu.corpus_bleu(refs, hyps) == jax_bleu.corpus_bleu(refs, hyps)


def test_edit_distance_matches_the_jax_dynamic_program():
    rng = np.random.default_rng(2)
    for _ in range(30):
        r = rng.integers(1, 6, size=int(rng.integers(0, 9))).astype(np.int32)
        h = rng.integers(1, 6, size=int(rng.integers(0, 9))).astype(np.int32)
        n = max(len(r), len(h), 1)
        rows = [np.pad(x, (0, n - len(x)))[None] for x in (r, h)]
        want = int(jax_wer._edit_distance_rows(*rows)[0])
        assert wer.edit_distance([str(x) for x in r], [str(x) for x in h]) == want


@pytest.fixture(scope="module")
def nar():
    jm = JNARS2UTModule(vocab_size=VOCAB, **NAR)
    src, lengths = _src(0)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(lengths),
                        jnp.asarray(np.full((2, 12), 4, np.int32)))
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    tm = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, **NAR), variables).eval()
    return jm, variables, tm


@pytest.mark.parametrize("case", ["true_length", "forced_iters", "both_beam3_cg2"])
def test_mask_predict_forced_lengths_and_iterations_match_jax(nar, case):
    jm, variables, tm = nar
    src, lengths = _src(11, b=3)
    true_length = np.asarray([7, 1, 12], np.int32)  # 1 clamps to 2 before the beam offsets
    kw = dict(max_iter=4, max_len=16)
    if case in ("true_length", "both_beam3_cg2"):
        kw["true_length"] = true_length
    if case in ("forced_iters", "both_beam3_cg2"):
        kw["adaptive"] = False
    if case == "both_beam3_cg2":
        kw.update(length_beam=3, cond_scale=2.0)
    want = jax_mask_predict(types.SimpleNamespace(module=jm), variables, jnp.asarray(src),
                            jnp.asarray(lengths), **kw)
    if "true_length" in kw:
        kw["true_length"] = torch.from_numpy(true_length)
    got = mask_predict_decode(tm, torch.from_numpy(src), torch.from_numpy(lengths), **kw)
    tokens = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), tokens)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    assert (tokens >= 4).sum() >= 6
    if "adaptive" in kw:
        assert (got[2].numpy() == kw["max_iter"] + 1).all()
    if case == "true_length":  # the canvas ends in EOS at the forced length
        for row, n in enumerate(np.maximum(true_length, 2)):
            assert tokens[row, n - 1] == 2 and (tokens[row, n:] == 1).all()


# ---- cli.generate against JAX's, on one seeded corpus and model ----

WIDTH_FLAGS = ["--target-code-size", "16", "--encoder-embed-dim", "32",
               "--encoder-ffn-embed-dim", "64", "--encoder-layers", "1",
               "--encoder-attention-heads", "2", "--decoder-layers", "1",
               "--decoder-attention-heads", "2", "--conv-channels", "32",
               "--depthwise-conv-kernel-size", "7", "--max-target-positions", "16",
               "--iter-decode-max-iter", "3"]


def _generate_lines(path):
    lines = path.read_text().splitlines()
    assert lines[-1].startswith("Generate test with beam=")
    return lines


def _assert_generate_files_agree(got, want):
    """ids and tokens equal, scores within 2e-4, the summary line equal."""
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        gp, wp = g.split("\t"), w.split("\t")
        assert gp[0] == wp[0] and gp[-1] == wp[-1], (g, w)
        if gp[0][0] in "HD":
            assert abs(float(gp[1]) - float(wp[1])) <= 2e-4, (g, w)
    assert got[-1] == want[-1]


@pytest.fixture(scope="module")
def generate_corpus(tmp_path_factory):
    import orbax.checkpoint as ocp

    from diffnorm_tpu.config import Config
    from diffnorm_tpu.registry import TASKS

    root = tmp_path_factory.mktemp("generate")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(5):
        t = int(rng.integers(36, 60))
        np.save(root / f"utt{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
        units = rng.integers(0, 16, size=t // 6 + 2)
        rows.append({"id": f"utt{i}", "src_audio": f"utt{i}.npy", "src_n_frames": t,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
    write_translation_manifest(str(root / "test.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump({
        "input_feat_per_channel": 80, "transforms": {"*": ["utterance_cmvn"]}}))
    cfg = Config(data=str(root), **NAR_CFG)
    task = TASKS.get("speech_to_speech_fasttranslate").setup_task(cfg)
    task.load_dataset("test")
    ds = task.dataset("test")
    batch0 = ds.collater([ds[0]])
    batch0.setdefault("prev_target", batch0["target"])
    variables = task.init_variables(task.build_model(), jax.random.PRNGKey(0), batch0)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(3))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(root / "nar_ck"), variables)
    ckptr.wait_until_finished()
    save_npz(str(root / "nar.npz"), variables)
    return root


@pytest.mark.parametrize("variant", ["default", "cg_beam_forced_init_wer"])
def test_cli_generate_matches_jax_cli(generate_corpus, variant, capsys):
    """`generate-test.txt` of the port's cli.generate and JAX's on the same
    weights (JAX reads its orbax checkpoint, the port a save_npz file):
    ids and tokens equal, scores within 2e-4, the summary line equal. The
    second run adds CG 2, a length beam of 3, forced iterations, canvases
    from an --init-unit-file (id-keyed lines from eval.unit_bleu of the
    first run, and plain lines) and WER scoring. eval.unit_bleu writes the
    same hyp.unit / ref.unit bytes and BLEU as JAX's."""
    from diffnorm_tpu.cli import generate as jax_generate
    from diffnorm_tpu.config import Config
    from diffnorm_tpu.eval import unit_bleu as jax_unit_bleu
    from diffnorm_tpu_torch.cli import generate
    from diffnorm_tpu_torch.eval import unit_bleu

    root = generate_corpus
    out = root / variant
    jax_cfg = dict(data=str(root), path=str(root / "nar_ck"), cpu=True, gen_subset="test",
                   max_tokens=120, **NAR_CFG)
    port = [str(root), "--cpu", "--path", str(root / "nar.npz"), "--gen-subset", "test",
            "--max-tokens", "120", *WIDTH_FLAGS]
    if variant != "default":
        # id-keyed lines for sentences 0-2, then plain lines (keyed by line
        # number) for 3 and 4
        rng = np.random.default_rng(7)
        units = [" ".join(map(str, rng.integers(0, 16, size=int(rng.integers(4, 13)))))
                 for _ in range(5)]
        init = root / "init.unit"
        init.write_text("".join(f"{i}\t{u}\n" for i, u in enumerate(units[:3]))
                        + "".join(f"{u}\n" for u in units[3:]))
        extra = dict(cond_scale=2.0, iter_decode_with_beam=3, iter_decode_force_max_iter=True,
                     init_unit_file=str(init), scoring="wer")
        jax_cfg.update(extra)
        port += ["--cond-scale", "2", "--iter-decode-with-beam", "3",
                 "--iter-decode-force-max-iter", "--init-unit-file", str(init),
                 "--scoring", "wer"]
    assert jax_generate.main(Config(results_path=str(out / "jax"), **jax_cfg)) == 0
    assert generate.main(port + ["--results-path", str(out / "port")]) == 0
    want = _generate_lines(out / "jax" / "generate-test.txt")
    got = _generate_lines(out / "port" / "generate-test.txt")
    _assert_generate_files_agree(got, want)
    hyps = [line.split("\t")[2].split() for line in got if line.startswith("H-")]
    assert len(hyps) == 5 and sum(len(h) for h in hyps) >= 10
    log = capsys.readouterr().err
    assert "sent/s" in log
    if variant == "default":
        assert want[-1].startswith("Generate test with beam=1: BLEU4 = ")
        for path, main in ((out / "port", unit_bleu.main), (out / "jax", jax_unit_bleu.main)):
            main([str(out / "jax" / "generate-test.txt"), str(path)])
        printed = capsys.readouterr().out.splitlines()
        assert len(printed) == 2 and printed[0] == printed[1]
        assert printed[0].startswith("unit BLEU: ")
        for name in ("hyp.unit", "ref.unit"):
            assert (out / "port" / name).read_bytes() == (out / "jax" / name).read_bytes()
    else:
        assert want[-1].startswith("Generate test with beam=3: WER: ")


def test_cli_generate_refuses_unported_flags_and_missing_ids(generate_corpus, tmp_path):
    from diffnorm_tpu_torch.cli import generate

    base = [str(generate_corpus), "--cpu", "--path", str(generate_corpus / "nar.npz")]
    # --task speech_to_speech (tests/test_torch_twopass_cli.py),
    # text_to_speech (tests/test_torch_tts_s2t_cli.py), translation
    # (tests/test_torch_text_cli.py) and audio_finetuning
    # (tests/test_torch_ctc_finetune.py) are ported since
    args = generate.parse_args(base + ["--task", "audio_finetuning"])
    assert (args.arch, args.model.criterion) == ("hubert_ctc", "ctc")
    with pytest.raises(NotImplementedError, match="no decode branch"):
        generate.parse_args(base + ["--arch", "s2ut_conformer"])
    # ported since: the history, the chunked decode, ensembles and the AR
    # reranker parse (tests/test_torch_decode_extras.py and
    # tests/test_torch_ar_cli.py hold them to JAX's CLI)
    assert generate.parse_args(base + ["--rerank-path", "ar.npz"]).rerank.arch == \
        "s2ut_conformer"
    assert generate.parse_args(base + ["--retain-iter-history"]).retain_iter_history is True
    assert generate.parse_args(base + ["--decode-chunk", "4"]).decode_chunk == 4
    assert generate.parse_args([str(generate_corpus), "--path", "a.npz:b.npz"]).path == \
        "a.npz:b.npz"
    init = tmp_path / "init.unit"
    init.write_text("0\t4 5 6\n")
    with pytest.raises(KeyError, match="no units for utterance id"):
        generate.main(base + WIDTH_FLAGS + ["--init-unit-file", str(init),
                                            "--results-path", str(tmp_path / "out")])


# ---- the code-HiFi-GAN map and the unit-file vocoder CLI ----

VOC_CFG = dict(num_embeddings=16, embedding_dim=8, upsample_rates=[4, 2],
               upsample_kernel_sizes=[8, 4], upsample_initial_channel=16,
               resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 2], [3]],
               dur_predictor_params={"var_pred_hidden_dim": 8})


def fairseq_hifigan_state(cfg, seed):
    """A seeded code-HiFi-GAN generator state dict in fairseq's layout:
    weight-normed (weight_g / weight_v over dim 0) convs and transposed
    convs, the unit table and the duration predictor."""
    gen = np.random.default_rng(seed)

    def t(*shape, scale=0.3, shift=0.0):
        return torch.from_numpy((gen.normal(scale=scale, size=shape) + shift).astype(np.float32))

    def wn(prefix, out_c, in_c, k, transposed=False):
        shape = (in_c, out_c, k) if transposed else (out_c, in_c, k)
        sd[f"{prefix}.weight_g"] = t(shape[0], 1, 1, scale=0.2, shift=1.0)
        sd[f"{prefix}.weight_v"] = t(*shape)
        sd[f"{prefix}.bias"] = t(out_c, scale=0.1)

    sd = {"dict.weight": t(cfg["num_embeddings"], cfg["embedding_dim"], scale=1.0)}
    ch = cfg["upsample_initial_channel"]
    wn("conv_pre", ch, cfg["embedding_dim"], 7)
    n_k = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        wn(f"ups.{i}", ch // 2, ch, k, transposed=True)
        ch //= 2
        for j, (rk, rd) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                         cfg["resblock_dilation_sizes"])):
            for c in range(len(rd)):
                wn(f"resblocks.{i * n_k + j}.convs1.{c}", ch, ch, rk)
                wn(f"resblocks.{i * n_k + j}.convs2.{c}", ch, ch, rk)
    wn("conv_post", 1, ch, 7)
    h, e = cfg["dur_predictor_params"]["var_pred_hidden_dim"], cfg["embedding_dim"]
    sd["dur_predictor.conv1.0.weight"] = t(h, e, 3)
    sd["dur_predictor.conv1.0.bias"] = t(h, scale=0.1)
    sd["dur_predictor.conv2.0.weight"] = t(h, h, 3)
    sd["dur_predictor.conv2.0.bias"] = t(h, scale=0.1)
    for ln in ("ln1", "ln2"):
        sd[f"dur_predictor.{ln}.weight"] = t(h, scale=0.1, shift=1.0)
        sd[f"dur_predictor.{ln}.bias"] = t(h, scale=0.1)
    sd["dur_predictor.proj.weight"] = t(1, h)
    sd["dur_predictor.proj.bias"] = t(1, scale=0.1, shift=0.8)  # durations of 1-4
    return sd


def test_convert_hifigan_state_matches_jax():
    from diffnorm_tpu.utils.convert_weights import convert_hifigan_state as jax_convert
    from diffnorm_tpu_torch.utils.convert_weights import convert_hifigan_state

    sd = fairseq_hifigan_state(VOC_CFG, 0)
    want, got = jax_convert(sd, VOC_CFG), convert_hifigan_state(sd, VOC_CFG)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            yield from (leaves(v, prefix + (k,)) if isinstance(v, dict)
                        else [(prefix + (k,), v)])

    want, got = dict(leaves(want)), dict(leaves(got))
    assert set(got) == set(want) and len(got) > 40
    for path, value in want.items():
        assert got[path].dtype == value.dtype
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


def _pcm(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.int32)


def test_cli_generate_waveform_matches_jax_cli(tmp_path):
    """The same fairseq checkpoint (.pt) and code file through both CLIs:
    `id|units`, `id\\tunits`, plain lines, an <unk> token and a line with no
    valid code (20 ms of silence); the PCM within 1 LSB. Every line holds 7
    valid codes, so JAX compiles its vocoder once. A save_npz file of the
    converted tree (bare, as variables, under g_params, and in a step
    directory) gives the same waveforms as the .pt, with duration
    prediction and --reduce."""
    from diffnorm_tpu.cli import generate_waveform as jax_cli
    from diffnorm_tpu_torch.cli import generate_waveform
    from diffnorm_tpu_torch.utils.convert_weights import convert_hifigan_state

    sd = fairseq_hifigan_state(VOC_CFG, 1)
    torch.save({"generator": sd}, tmp_path / "g.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(VOC_CFG))
    (tmp_path / "codes.txt").write_text(
        "a|3 3 5 9 9 9 1\n7\t2 4 <unk> 4 15 0 8 8\n\n11 11 6 2 8 1 1\n<unk> <unk>\n"
        "5 5 5 12 0 0 7\n")
    base = ["--in-code-file", str(tmp_path / "codes.txt"), "--vocoder-cfg",
            str(tmp_path / "cfg.json")]
    jax_cli.main(base + ["--vocoder", str(tmp_path / "g.pt"), "--results-path",
                         str(tmp_path / "jax"), "--cpu"])
    assert generate_waveform.main(base + ["--vocoder", str(tmp_path / "g.pt"),
                                          "--results-path", str(tmp_path / "port"),
                                          "--cpu"]) == 0
    params = convert_hifigan_state(sd, VOC_CFG)["params"]
    for name, tree in (("bare", params), ("variables", {"params": params}),
                       ("g_params", {"g_params": params})):
        save_npz(str(tmp_path / f"{name}.npz"), tree)
    (tmp_path / "step").mkdir()
    save_npz(str(tmp_path / "step" / "params.npz"), {"params": params})
    for i in range(5):
        want = _pcm(tmp_path / "jax" / f"{i}_pred.wav")
        got = _pcm(tmp_path / "port" / f"{i}_pred.wav")
        assert len(got) == len(want) > 0
        assert np.abs(got - want).max() <= 1, i
    assert len(_pcm(tmp_path / "port" / "3_pred.wav")) == 320  # no valid code: 20 ms
    assert len(_pcm(tmp_path / "port" / "0_pred.wav")) == 7 * 8  # 7 codes, 8x upsampled
    assert np.abs(_pcm(tmp_path / "port" / "0_pred.wav")).max() > 100
    code = generate_waveform.parse_code_line("7\t2 4 <unk> 4")
    np.testing.assert_array_equal(code, [2, 4, -1, 4])
    units = generate_waveform.parse_code_line("a|3 3 5 9 9 9 1")
    want = generate_waveform.load_vocoder(str(tmp_path / "g.pt"), str(tmp_path / "cfg.json"),
                                          device="cpu")(units, dur_prediction=True, reduce=True)
    for name in ("bare.npz", "variables.npz", "g_params.npz", "step"):
        vocoder = generate_waveform.load_vocoder(str(tmp_path / name),
                                                 str(tmp_path / "cfg.json"), device="cpu")
        np.testing.assert_array_equal(vocoder(units, dur_prediction=True, reduce=True), want)


def test_mel_cepstral_distortion_matches_jax():
    from diffnorm_tpu.eval.mcd import mel_cepstral_distortion as jax_mcd
    from diffnorm_tpu_torch.eval.mcd import batch_mel_cepstral_distortion, mel_cepstral_distortion

    rng = np.random.default_rng(5)
    a = (rng.normal(size=4800) * 0.1).astype(np.float32)
    b = (a[:4000] + rng.normal(size=4000) * 0.05).astype(np.float32)
    got, want = mel_cepstral_distortion(a, b), jax_mcd(a, b)
    assert 0.0 < want < np.inf
    assert abs(got - want) <= 1e-6
    mean, vals = batch_mel_cepstral_distortion([a, b], [b, a])
    assert len(vals) == 2 and abs(mean - np.mean([jax_mcd(a, b), jax_mcd(b, a)])) <= 1e-6
    assert mel_cepstral_distortion(a[:100], b) == np.inf

