"""Text machine translation through the port's CLIs on the CPU at tiny
widths (dim 16, 1 + 2 layers): cli.preprocess's directory byte-equal to
JAX's CLI (mmap and native layouts, a joined dictionary with thresholds,
given dictionaries); cli.score's output equal to JAX's (corpus, sentence
BLEU, --order with --ignore-case, stdin); then cli.preprocess -> cli.train
(2 updates on the binarized pairs) -> cli.validate -> cli.generate ->
cli.interactive for `translation`, `cmlm_cg` and `translation_lev`:
cli.validate's metrics against the trainer's valid step (rtol 1e-6), the H-
lines of cli.generate and cli.interactive equal to the same decode in
process, and cli.interactive's H- and D- lines equal to JAX's CLI on an
orbax copy of the step directory for the text CMLM (JAX's CLI runs its AR
transformer op by op, ~15 s here; tests/test_torch_text_mt.py holds the
beam decode to JAX's). JAX's
interactive CLI does not take the Levenshtein transformer's lines for text
(`test_levenshtein_interactive_fault_of_the_reference`); the port decodes
them with its own decode."""

import io
import re

import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu_torch.cli import generate, interactive, preprocess, score, train, validate
from diffnorm_tpu_torch.cli.generate import strip_special
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
from diffnorm_tpu_torch.generate.beam_search import ar_generate
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.models.levenshtein import levenshtein_decode
from diffnorm_tpu_torch.tasks import TASKS as TEXT_TASKS
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.weights import from_jax_variables
from tests.test_torch_ar_cli import save_orbax
from tests.test_torch_text_mt import _float_text_attention, write_bitext  # noqa: F401
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

WIDTHS = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=1,
              decoder_layers=2, encoder_attention_heads=2, decoder_embed_dim=16,
              decoder_ffn_embed_dim=32, decoder_attention_heads=2)
TASKS = {"translation": ("transformer", ["--beam", "3", "--lenpen", "0.6",
                                         "--no-repeat-ngram-size", "2"]),
         "cmlm_cg": ("cmlm_transformer", ["--iter-decode-max-iter", "3",
                                          "--iter-decode-with-beam", "2", "--cond-scale", "1.5"]),
         "translation_lev": ("levenshtein_transformer", ["--iter-decode-max-iter", "3",
                                                         "--iter-decode-eos-penalty", "1.0"])}
# cli.interactive's decode flags (its mask-predict takes no length beam, as JAX's)
INTERACTIVE = {"translation": ["--beam", "3", "--lenpen", "0.6"],
               "cmlm_cg": ["--iter-decode-max-iter", "3", "--cond-scale", "1.5"],
               "translation_lev": TASKS["translation_lev"][1]}
LANGS = ["--source-lang", "de", "--target-lang", "en"]
MAX_LEN = 12  # --max-target-positions: the decodes' steps and canvases


def flags(values):
    return [f"--{k.replace('_', '-')}={v}" for k, v in values.items()]


def _preprocess(module, root, dest, *extra):
    assert module.main(["--source-lang", "de", "--target-lang", "en", "--trainpref",
                        str(root / "train"), "--validpref", str(root / "valid"), "--testpref",
                        str(root / "test"), "--destdir", str(dest), *extra]) == 0
    return {p.name: p.read_bytes() for p in sorted(dest.iterdir())}


@pytest.mark.parametrize("extra", [[], ["--dataset-impl", "native"],
                                   ["--joined-dictionary", "--thresholdsrc", "2"],
                                   ["--thresholdtgt", "3", "--srcdict", "DICT"]],
                         ids=["mmap", "native", "joined", "srcdict"])
def test_preprocess_matches_jax_cli(tmp_path, extra):
    """Every file cli.preprocess writes (dictionaries, .bin, .idx) byte-equal
    to JAX's CLI's."""
    from diffnorm_tpu.cli import preprocess as jax_preprocess

    root = write_bitext(tmp_path)
    (tmp_path / "dict.txt").write_text("s3 9\ns1 4\nzz 2\n")
    extra = [str(tmp_path / "dict.txt") if a == "DICT" else a for a in extra]
    got = _preprocess(preprocess, root, tmp_path / "port", *extra)
    want = _preprocess(jax_preprocess, root, tmp_path / "jax", *extra)
    assert sorted(got) == sorted(want) and len(got) == 2 + 3 * 2 * 2
    for name, data in want.items():
        assert got[name] == data, name


@pytest.mark.parametrize("extra", [[], ["--sentence-bleu"], ["--order", "2", "--ignore-case"],
                                   ["stdin"]])
def test_score_matches_jax_cli(tmp_path, capsys, monkeypatch, extra):
    """cli.score's printout equal to JAX's: a hypothesis file of shuffled,
    cut and upper-cased references, with tab-prefixed ids, against them."""
    from diffnorm_tpu.cli import score as jax_score

    rng = np.random.default_rng(4)
    refs = [" ".join(rng.choice(["a", "b", "c", "d", "e"], size=int(rng.integers(3, 9))))
            for _ in range(6)]
    hyps = [f"{i}\t" + " ".join(r.split()[::-1][:-1]).upper() for i, r in enumerate(refs)]
    (tmp_path / "ref.txt").write_text("\n".join(refs) + "\n")
    (tmp_path / "hyp.txt").write_text("\n".join(hyps) + "\n")
    args = ["--ref", str(tmp_path / "ref.txt")]
    args += ["--sys", "-"] if extra == ["stdin"] else ["--sys", str(tmp_path / "hyp.txt"), *extra]
    outs = []
    for module in (score, jax_score):
        monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(hyps) + "\n"))
        assert module.main(args) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "BLEU" in outs[0]


@pytest.fixture(scope="module")
def binarized(tmp_path_factory):
    root = tmp_path_factory.mktemp("mt_cli")
    write_bitext(root)
    _preprocess(preprocess, root, root / "bin")
    return root / "bin"


@pytest.fixture(scope="module")
def trained(binarized):
    """{task: its cli.train step directory} (2 updates each)."""
    steps = {}
    for task, (arch, _) in TASKS.items():
        save_dir = binarized.parent / f"ck_{task}"
        assert train.main([str(binarized), "--cpu", "--task", task, "--arch", arch, *LANGS,
                           "--save-dir", str(save_dir), "--max-update", "2", "--max-tokens",
                           "60", "--lr", "1e-3", "--warmup-updates", "2", "--log-interval",
                           "1", "--seed", "3", "--valid-subset", "valid", *flags(WIDTHS)]) == 0
        steps[task] = save_dir / "step_000000002"
    return steps


def in_process_decoder(task_name, model, interactive=False):
    """The decode cli.generate (or with `interactive` cli.interactive: no
    ngram blocking, no length beam) runs, in process: fn(src, lengths) ->
    token rows."""
    length_beam, ngram = (1, 0) if interactive else (2, 2)
    if task_name == "translation":
        return lambda s, n: ar_generate(model, s, n, beam_size=3, max_len=MAX_LEN,
                                        len_penalty=0.6, no_repeat_ngram=ngram)[0][:, 0]
    if task_name == "cmlm_cg":
        return lambda s, n: mask_predict_decode(model, s, n, max_iter=3, max_len=MAX_LEN,
                                                cond_scale=1.5, length_beam=length_beam)[0]
    return lambda s, n: levenshtein_decode(model, s, n, max_iter=3, max_len=MAX_LEN,
                                           eos_penalty=1.0)


@pytest.mark.parametrize("task_name", list(TASKS))
def test_train_validate_generate_against_in_process(binarized, trained, tmp_path, task_name):
    """cli.validate's metrics against the trainer's valid step on the same
    batch and draws; cli.generate's H- lines (every test sentence, its T-
    line the reference) equal to the same decode in process, and its BLEU
    line."""
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    arch, decode_flags = TASKS[task_name]
    base = [str(binarized), "--cpu", "--task", task_name, "--arch", arch, *LANGS,
            *flags(WIDTHS)]
    step = trained[task_name]
    vargs = validate.parse_args(base + ["--path", str(step), "--valid-subset", "valid",
                                        "--max-tokens", "400"])
    got = validate.validate(vargs)
    task = TEXT_TASKS[task_name](vargs)
    model = from_jax_variables(task.build_model(), load_variables(str(step)))
    trainer = Trainer(TrainerConfig(seed=vargs.seed), model, task.build_criterion())
    ds = task.dataset("valid")
    batch = task.prepare_batch(ds.collater([ds[int(i)] for i in ds.ordered_indices()]),
                               np.random.default_rng(vargs.seed))
    want = trainer.valid_step(batch, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-6, err_msg=key)

    out = tmp_path / "gen"
    assert generate.main(base + ["--path", str(step), "--gen-subset", "test", "--max-tokens",
                                 "40", "--max-target-positions", str(MAX_LEN),
                                 "--results-path", str(out), *decode_flags]) == 0
    text = (out / "generate-test.txt").read_text()
    hyps = dict(re.findall(r"^H-(\d+)\t\S+\t(.*)$", text, re.M))
    refs = dict(re.findall(r"^T-(\d+)\t(.*)$", text, re.M))
    assert "Generate test with beam=" in text and "BLEU4" in text
    model.eval()
    decode = in_process_decoder(task_name, model)
    test = task.dataset("test")
    with torch.no_grad():
        for b in EpochBatchIterator(test, 40, shuffle=False).next_epoch_itr():
            tokens = decode(torch.from_numpy(b["src_tokens"]).long(),
                            torch.from_numpy(b["src_lengths"]))
            for row, sid, tgt in zip(tokens.numpy(), b["id"].tolist(), b["target"]):
                assert hyps.pop(str(sid)) == strip_special(row, task.tgt_dict)
                assert refs[str(sid)] == strip_special(tgt, task.tgt_dict)
    assert not hyps


def _stdin_lines(binarized):
    """A blank line, then a test-split source line (one decode a run: JAX's
    CLI compiles its decode for each line)."""
    return ["", (binarized.parent / "test.de").read_text().splitlines()[0]]


@pytest.mark.parametrize("task_name", list(TASKS))
def test_interactive_matches_jax_cli_and_in_process(binarized, trained, tmp_path, capsys,
                                                    monkeypatch, task_name):
    """cli.interactive with --tokenizer space: one H- and one D- line per
    non-blank line, numbered by line, the H- lines equal to the in-process
    decode of the encoded line; for the text CMLM equal to JAX's CLI on an
    orbax copy of the step directory too (module docstring)."""
    from diffnorm_tpu.cli import interactive as jax_interactive

    arch = TASKS[task_name][0]
    step = trained[task_name]
    lines = _stdin_lines(binarized)
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert interactive.main([str(binarized), "--cpu", "--task", task_name, "--arch", arch,
                             *LANGS, "--path", str(step), "--max-target-positions",
                             str(MAX_LEN), "--tokenizer", "space", *flags(WIDTHS),
                             *INTERACTIVE[task_name]]) == 0
    got = capsys.readouterr().out
    hyps = re.findall(r"^H-(\d+)\t(.*)$", got, re.M)
    assert [i for i, _ in hyps] == ["1"] and got.count("D-") == 1
    args, _ = interactive.parse_args([str(binarized), "--cpu", "--task", task_name, "--arch",
                                      arch, *LANGS, "--path", str(step), *flags(WIDTHS)])
    task = TEXT_TASKS[task_name](args.model)
    model = generate.build_task_model(args, str(step), torch.device("cpu"), torch.float32)[1]
    decode = in_process_decoder(task_name, model, interactive=True)
    for (_, hyp), line in zip(hyps, lines[1:]):
        ids = torch.from_numpy(task.src_dict.encode_line(line)[None]).long()
        row = decode(ids, torch.tensor([ids.shape[1]]))[0].tolist()
        if task_name == "translation_lev":
            row = row[1:]  # the canvas's BOS
        assert hyp == " ".join(task.tgt_dict[t] for t in row if t not in (1, 2))
    if task_name != "cmlm_cg":
        return
    save_orbax(tmp_path / "orbax", load_variables(str(step)))
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert jax_interactive.main(Config(
        data=str(binarized), cpu=True, task=task_name, arch=arch, source_lang="de",
        target_lang="en", path=str(tmp_path / "orbax"), max_target_positions=MAX_LEN,
        tokenizer="space", iter_decode_max_iter=3, cond_scale=1.5, **WIDTHS)) == 0
    want = capsys.readouterr().out
    assert re.findall(r"^[HD]-.*$", got, re.M) == re.findall(r"^[HD]-.*$", want, re.M)


def test_levenshtein_interactive_fault_of_the_reference(binarized, trained, tmp_path,
                                                        monkeypatch):
    """JAX's cli.interactive lists cmlm_cg and translation as its text
    tasks (interactive.py:56-57), not translation_lev, so it reads a
    translation_lev line as an audio path and fails on the first; were the
    line taken for text, its route would be mask-predict (:73-84), which
    asks the model for a length head it does not have."""
    from diffnorm_tpu.cli import interactive as jax_interactive

    save_orbax(tmp_path / "orbax", load_variables(str(trained["translation_lev"])))
    line = _stdin_lines(binarized)[1]
    monkeypatch.setattr("sys.stdin", io.StringIO(line + "\n"))
    with pytest.raises(FileNotFoundError, match=line):
        jax_interactive.main(Config(
            data=str(binarized), cpu=True, task="translation_lev",
            arch="levenshtein_transformer", source_lang="de", target_lang="en",
            path=str(tmp_path / "orbax"), max_target_positions=MAX_LEN, **WIDTHS))


def test_cli_refusals(binarized, capsys):
    """--share-all-embeddings (as JAX's build_model refuses it), the NAR
    model's options on the text tasks, cli.interactive on a speech task
    without its route (speech_to_text; the S2UT tasks' lines are taken
    since: tests/test_torch_runtime.py), and cli.generate's AR S2UT
    reranker on a text task."""
    base = [str(binarized), "--cpu", "--max-update", "1"]
    for extra, message in (
            (["--task", "translation", "--share-all-embeddings"], "--share-all-embeddings"),
            (["--task", "translation", "--cg-prob", "0.1"], "--cg-prob"),
            (["--task", "translation_lev", "--use-side"], "--use-side"),
            (["--task", "cmlm_cg", "--multitask-config-yaml", "m.yaml"],
             "--multitask-config-yaml"),
            (["--task", "cmlm_cg", "--use-sp"], "--use-sp")):
        with pytest.raises(SystemExit):
            train.parse_args(base + extra)
        assert message in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="takes text lines"):
        interactive.parse_args([str(binarized), "--cpu", "--path", "x", "--task",
                                "speech_to_text"])
    with pytest.raises(SystemExit):  # the reranker is an AR S2UT model
        generate.parse_args([str(binarized), "--cpu", "--task", "cmlm_cg", "--path", "x",
                             "--rerank-path", "ar.npz"])
    assert "--rerank-path" in capsys.readouterr().err
