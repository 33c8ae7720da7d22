"""The AR S2UT recipe through the port's CLIs against JAX's, on the CPU at
tiny widths: cli.train --task speech_to_speech_ar (2 updates and a
checkpoint), then cli.generate on its step directory and JAX's
cli.generate on the same weights (an orbax checkpoint): the beam decode's
generate-test.txt line for line, --score-reference's scores within 1e-4,
and the NAR decode with a length beam reranked by the trained AR model
(--rerank-path, with a --rerank-<flag> override); cli.validate on the
step directory with either criterion. Also the CLIs' refusals:
the NAR model's options on the AR task, --quant-int8 on the AR decode, and
an arch the task does not have."""

import jax
import numpy as np
import pytest
import yaml

from diffnorm_tpu.config import Config
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.weights import save_npz
from tests.test_torch_eval import _assert_generate_files_agree, _generate_lines
from tests.test_torch_nar_train import _perturb
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

WIDTHS = dict(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
              encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
              decoder_layers=2, decoder_attention_heads=2, conv_channels=32,
              depthwise_conv_kernel_size=5, target_code_size=16)
MAX_TOKENS, MAX_POSITIONS = "240", "12"


def flags(values):
    return [f"--{k.replace('_', '-')}" + ("" if v is True else f"={v}")
            for k, v in values.items()]


def write_corpus(root, seed=0, splits=(("train", 6), ("dev", 2), ("test", 4))):
    """.npy fbank sources of 36-80 frames with 4-15 units of 16 codes."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        rows = []
        for i in range(n):
            uid = f"{split}{i}"
            t = int(rng.integers(36, 81))
            np.save(root / f"{uid}.npy", rng.normal(size=(t, 80)).astype(np.float32))
            units = rng.integers(0, 16, size=int(rng.integers(4, 16)))
            rows.append({"id": uid, "src_audio": f"{uid}.npy", "src_n_frames": t,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump({"input_feat_per_channel": 80}))
    return root


def save_orbax(path, variables):
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(path), variables)
    ckptr.wait_until_finished()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The corpus and the port's cli.train run: (root, the step directory,
    its orbax copy)."""
    from diffnorm_tpu_torch.cli import train

    root = write_corpus(tmp_path_factory.mktemp("ar_cli"))
    save_dir = root / "ckpt"
    assert train.main([str(root), "--cpu", "--task", "speech_to_speech_ar",
                       "--arch", "s2ut_conformer", "--save-dir", str(save_dir),
                       "--max-update", "2", "--max-tokens", MAX_TOKENS, "--lr", "1e-3",
                       "--warmup-updates", "2", "--log-interval", "1", "--seed", "3",
                       "--validate-interval", "5", *flags(WIDTHS)]) == 0
    step = save_dir / "step_000000002"
    variables = load_variables(str(step))
    assert {"encoder", "decoder"} <= set(variables["params"]) and "batch_stats" in variables
    save_orbax(root / "ar_ck", variables)
    return root, step, root / "ar_ck"


def _run_both(root, out, jax_cfg, port_flags):
    from diffnorm_tpu.cli import generate as jax_generate
    from diffnorm_tpu_torch.cli import generate

    assert jax_generate.main(Config(data=str(root), cpu=True, gen_subset="test",
                                    max_tokens=int(MAX_TOKENS),
                                    max_target_positions=int(MAX_POSITIONS),
                                    results_path=str(out / "jax"), **WIDTHS, **jax_cfg)) == 0
    assert generate.main([str(root), "--cpu", "--gen-subset", "test", "--max-tokens",
                          MAX_TOKENS, "--max-target-positions", MAX_POSITIONS,
                          "--results-path", str(out / "port"), *flags(WIDTHS),
                          *port_flags]) == 0
    return (_generate_lines(out / "port" / "generate-test.txt"),
            _generate_lines(out / "jax" / "generate-test.txt"))


@pytest.mark.parametrize("variant", ["beam", "score_reference"])
def test_cli_generate_matches_jax_cli(trained, variant):
    """Beam 3 with ngram blocking 2 and a length penalty: H- and D- lines
    equal to JAX's (tokens equal, scores within 2e-4), the summary line
    equal. --score-reference: the references as the hypotheses, each score
    (the mean teacher-forced log-prob, printed to 4 places) within 1e-4."""
    root, step, ck = trained
    opts = (dict(beam=3, no_repeat_ngram_size=2, lenpen=0.7) if variant == "beam"
            else dict(score_reference=True))
    got, want = _run_both(root, root / variant,
                          dict(task="speech_to_speech_ar", arch="s2ut_conformer", path=str(ck),
                               **opts),
                          ["--task", "speech_to_speech_ar", "--path", str(step), *flags(opts)])
    if variant == "beam":
        _assert_generate_files_agree(got, want)
        assert got[-1].startswith("Generate test with beam=3: ")
    else:
        assert len(got) == len(want) and got[-1] == want[-1]
        for g, w in zip(got[:-1], want[:-1]):
            gp, wp = g.split("\t"), w.split("\t")
            assert gp[0] == wp[0] and gp[-1] == wp[-1], (g, w)
            if gp[0][0] == "H":
                assert abs(float(gp[1]) - float(wp[1])) <= 1e-4 + 1e-9, (g, w)
        refs = {g.split("\t")[0][2:]: g.split("\t")[1] for g in got if g.startswith("T-")}
        hyps = {g.split("\t")[0][2:]: g.split("\t")[2] for g in got if g.startswith("H-")}
        assert refs == hyps
    hyps = [line.split("\t")[2].split() for line in got if line.startswith("H-")]
    assert len(hyps) == 4 and all(hyps)


def test_cli_generate_rerank_path_matches_jax_cli(trained):
    """The NAR decode with a length beam of 3 picked by the trained AR model
    (--rerank-path, --rerank-arch s2ut_conformer): generate-test.txt equal
    to JAX's CLI with the same flags."""
    from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule

    root, step, ck = trained
    jm = JNARS2UTModule(vocab_size=20, dropout=0.0, encoder_dim=32, encoder_ffn_dim=64,
                        encoder_layers=1, encoder_heads=2, decoder_dim=32, decoder_ffn_dim=64,
                        decoder_layers=2, decoder_heads=2, depthwise_kernel_size=5,
                        conv_channels=32)
    src = np.zeros((1, 48, 80), np.float32)
    tokens = np.full((1, 6), 4, np.int32)
    nar = jax.jit(jm.init)(jax.random.PRNGKey(0), src, np.asarray([48], np.int32), tokens,
                           tgt_tokens=tokens)
    nar = _perturb(jax.device_get(dict(nar)), np.random.default_rng(7))
    save_orbax(root / "nar_ck", nar)
    save_npz(str(root / "nar.npz"), nar)
    got, want = _run_both(
        root, root / "rerank",
        dict(task="speech_to_speech_fasttranslate", arch="nar_s2ut_conformer",
             path=str(root / "nar_ck"), iter_decode_max_iter=3, iter_decode_with_beam=3,
             rerank_path=str(ck), rerank_arch="s2ut_conformer"),
        ["--path", str(root / "nar.npz"), "--iter-decode-max-iter", "3",
         "--iter-decode-with-beam", "3", "--rerank-path", str(step),
         "--rerank-arch", "s2ut_conformer"])
    _assert_generate_files_agree(got, want)


def test_cli_refusals(tmp_path):
    """The NAR model's options on --task speech_to_speech_ar and an arch of
    another task are usage errors of cli.train; cli.generate refuses
    --quant-int8 on the AR decode and a task / arch pair not ported, and
    takes --rerank-<flag> overrides into the reranker's flags alone."""
    from diffnorm_tpu_torch.cli import generate, train

    write_corpus(tmp_path, splits=(("train", 1),))
    base = [str(tmp_path), "--cpu", "--task", "speech_to_speech_ar", "--max-update", "1"]
    for extra in (["--cg-prob", "0.1"], ["--encoder-remat"], ["--arch", "nar_s2ut_conformer"],
                  ["--criterion", "nar_speech_to_unit"]):
        with pytest.raises(SystemExit):
            train.parse_args(base + extra)
    args = train.parse_args(base + ["--arch", "s2ut_transformer_fisher"])
    assert (args.encoder_embed_dim, args.encoder_attention_heads, args.decoder_embed_dim,
            args.encoder_type, args.criterion, args.label_smoothing,
            args.depthwise_conv_kernel_size) == (
        256, 4, 256, "transformer", "label_smoothed_cross_entropy", 0.1, 31)
    gen = [str(tmp_path), "--cpu", "--path", "ar.npz", "--task", "speech_to_speech_ar"]
    with pytest.raises(SystemExit):
        generate.parse_args(gen + ["--quant-int8"])
    with pytest.raises(NotImplementedError, match="no decode branch"):  # UnitY is ported since
        generate.parse_args(gen + ["--arch", "fastspeech2"])
    args = generate.parse_args(gen + ["--arch", "s2ut_conformer", "--encoder-embed-dim", "64"])
    assert (args.encoder_embed_dim, args.decoder_embed_dim, args.encoder_layers) == (64, 512, 12)
    args = generate.parse_args([str(tmp_path), "--cpu", "--path", "nar.npz", "--rerank-path",
                                "ar.npz", "--encoder-layers", "4", "--rerank-encoder-layers", "2",
                                "--rerank-arch", "s2ut_transformer"])
    assert (args.encoder_layers, args.rerank.encoder_layers, args.rerank.arch,
            args.rerank.encoder_type) == (4, 2, "s2ut_transformer", "transformer")


@pytest.mark.parametrize("criterion", ["label_smoothed_cross_entropy", "speech_to_unit"])
def test_cli_validate_takes_the_ar_task(trained, criterion):
    """cli.validate --task speech_to_speech_ar on the trained step directory:
    the criterion's metrics over the dev split, equal to the trainer's valid
    step over the same batches (without aux tasks the two criterions are
    one function)."""
    import torch

    from diffnorm_tpu_torch.cli import train, validate
    from diffnorm_tpu_torch.tasks import TASKS
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
    from diffnorm_tpu_torch.weights import from_jax_variables

    root, step, _ = trained
    flags_ = [str(root), "--cpu", "--task", "speech_to_speech_ar", "--criterion", criterion,
              "--valid-subset", "dev", "--max-tokens", MAX_TOKENS, *flags(WIDTHS)]
    got = validate.validate(validate.parse_args(flags_ + ["--path", str(step)]))
    assert got["nsentences"] == 2 and np.isfinite(got["loss"]) and got["loss"] > 0
    args = train.parse_args(flags_ + ["--max-update", "1"])
    task = TASKS[args.task](args)
    torch.manual_seed(args.seed)
    model = from_jax_variables(task.build_model(), load_variables(str(step)))
    trainer = Trainer(TrainerConfig(seed=args.seed), model, task.build_criterion())
    ds = task.dataset("dev")
    batch = task.prepare_batch(ds.collater([ds[i] for i in range(len(ds))]),
                               np.random.default_rng(args.seed))
    want = trainer.valid_step(batch, torch.Generator().manual_seed(0))
    for key in ("loss", "nll_loss", "acc", "ntokens"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
