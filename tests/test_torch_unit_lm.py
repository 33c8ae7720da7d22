"""The unit LM in the port against the JAX package on the CPU, float32, at
tiny widths: `slice_indices` in its four break modes and the fixed-window
`token_block_slices` (JAX's native library) equal; `UnitLMDataset`'s
blocks, order and batches equal; the dummy LM tasks' batches equal; the
model's logits and `lm_cross_entropy` within 1e-5 (FWD_TOL); cli.train ->
cli.eval_lm, whose perplexity equals the in-process one and JAX's module's
on the same weights and batches; the transformer_lm arch.

JAX's collater pads with 0 while its model, criterion and eval_lm take pad
as 1, so a padded position is scored as a `<s>` target and counted;
`test_unit_lm_padding_fault_of_the_reference` pins it (the port copies it,
so its numbers equal JAX's). The port's weights are its seeded init,
perturbed, checked against JAX's init traced with `jax.eval_shape`."""

import contextlib
import io
import math

import jax
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.ce_loss import LMCrossEntropy as JLMCrossEntropy
from diffnorm_tpu.data import unit_lm_dataset as junit
from diffnorm_tpu.data.dictionary import Dictionary as JDictionary
from diffnorm_tpu.data.iterators import EpochBatchIterator as JEpochBatchIterator
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.ce_loss import LMCrossEntropy
from diffnorm_tpu_torch.data import unit_lm_dataset
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_variables, to_jax_variables
from tests.test_torch_sedd import CODES, _close, _perturbed, write_unit_corpus
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

FWD_TOL = 1e-5
LM_TINY = dict(decoder_embed_dim=16, decoder_ffn_embed_dim=32, decoder_layers=2,
               decoder_attention_heads=2)


def lm_flags(root, task="language_modeling"):
    return [str(root), "--task", task, "--cpu", "--target-code-size", str(CODES),
            *(f"--{k.replace('_', '-')}={v}" for k, v in LM_TINY.items())]


@pytest.mark.parametrize("mode", ["none", "complete", "complete_doc", "eos"])
def test_slice_indices_match_jax(mode):
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 40, size=30)
    sizes[[3, 4, 11, 20, 29]] = 1  # document separators (complete_doc)
    for block in (1, 7, 16, 64):
        np.testing.assert_array_equal(unit_lm_dataset.slice_indices(sizes, mode, block),
                                      junit.slice_indices(sizes, mode, block))
    if mode == "none":
        for block in (5, 16, 1000):
            sizes0 = np.concatenate([sizes, [0, 0]])  # empty documents at the end
            np.testing.assert_array_equal(unit_lm_dataset.token_block_slices(sizes0, block),
                                          junit.token_block_slices(sizes0, block))


def test_dataset_order_and_batches_match_jax(tmp_path):
    root = write_unit_corpus(tmp_path)
    for split, block, mode in (("train", 0, "none"), ("train", 16, "complete"),
                               ("dev", 10, "none"), ("test", 24, "eos")):
        ds = unit_lm_dataset.UnitLMDataset.from_tsv(
            str(root), split, Dictionary.unit_dictionary(CODES), max_positions=20,
            block_size=block, break_mode=mode, is_train=split == "train")
        jds = junit.UnitLMDataset.from_tsv(
            str(root), split, JDictionary.unit_dictionary(CODES), max_positions=20,
            block_size=block, break_mode=mode, is_train=split == "train")
        np.testing.assert_array_equal(ds.sizes, jds.sizes)
        np.testing.assert_array_equal(ds.ordered_indices(), jds.ordered_indices())
        got = list(EpochBatchIterator(ds, 48, max_sentences=3, shuffle=False,
                                      num_prefetch=0).next_epoch_itr())
        want = list(JEpochBatchIterator(jds, max_tokens=48, max_sentences=3,
                                        shuffle=False).next_epoch_itr(shuffle=False))
        assert len(got) == len(want) > 1
        for b, jb in zip(got, want):
            assert set(b) == set(jb)
            for k in b:
                np.testing.assert_array_equal(b[k], jb[k])


@pytest.mark.parametrize("task_name", ["dummy_unit_lm", "dummy_lm"])
def test_dummy_tasks_match_jax(tmp_path, task_name):
    args = train_cli.parse_args(lm_flags(tmp_path, "unit_lm") + ["--max-update", "1",
                                                                 "--batch-size", "3"])
    task = (TASKS[task_name])(args)
    jtask = JTASKS.get(task_name).setup_task(Config(task=task_name, target_code_size=CODES,
                                                    batch_size=3))
    got, want = task.dataset("train")[0], next(iter(jtask.dataset("train")))
    for k in ("target_unit", "target_lengths"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """(the port's task, model in eval mode, JAX's module, variables)."""
    args = train_cli.parse_args(lm_flags(tmp_path_factory.mktemp("lm"))
                                + ["--max-update", "1"])
    task = TASKS[args.task](args)
    jm = JTASKS.get("unit_lm").setup_task(Config(task="unit_lm", arch="transformer_lm",
                                                 target_code_size=CODES,
                                                 **LM_TINY)).build_model().module
    tokens = task.dummy_batch(2, 8)["target_unit"]
    key = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key}, tokens))
    torch.manual_seed(0)
    tree = to_jax_variables(task.build_model())
    assert ({k: tuple(np.shape(v)) for k, v in flatten_tree(tree).items()}
            == {k: tuple(v.shape) for k, v in flatten_tree(want).items()})
    variables = {"params": _perturbed(tree["params"], np.random.default_rng(1))}
    return task, from_jax_variables(task.build_model(), variables).eval(), jm, variables


def _lm_batch(seed=2, lengths=(11, 7, 4)):
    """Rows of units with </s> (2) and PAD (1) after each row's length."""
    rng = np.random.default_rng(seed)
    tokens = np.full((len(lengths), max(lengths)), 1, np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(4, 4 + CODES, n)
        tokens[i, n - 1] = 2
    return tokens


def test_logits_and_criterion_match_jax(lm):
    task, model, jm, variables = lm
    tokens = _lm_batch()
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    _close(logits, jm.apply(variables, tokens, deterministic=True), FWD_TOL)
    for eps in (0.0, 0.1):
        cfg = Config(label_smoothing=eps)
        jloss, jmets, _ = JLMCrossEntropy(cfg)(jm, variables, {"target_unit": tokens},
                                               jax.random.PRNGKey(0), train=False)
        with torch.no_grad():
            loss, mets = LMCrossEntropy(eps)(model, {"target_unit": torch.from_numpy(tokens)})
        _close(loss, jloss, FWD_TOL)
        for k in ("nll_loss", "ppl"):
            _close(mets[k], jmets[k], FWD_TOL)
        assert int(mets["ntokens"]) == int(jmets["ntokens"]) == (tokens != 1).sum()


def test_unit_lm_padding_fault_of_the_reference(lm):
    """JAX's UnitLMDataset.collater pads with 0 (`<s>`), while its model,
    lm_cross_entropy and eval_lm take pad as 1: a batch of unequal lengths
    is scored over every padded position, counted in ntokens. The port
    copies it, so its loss equals JAX's; scored as padding (1) the loss
    differs."""
    task, model, jm, variables = lm
    ds = unit_lm_dataset.UnitLMDataset([np.arange(4, 4 + n, dtype=np.int32)
                                        for n in (9, 5, 3)])
    batch = ds.collater([ds[i] for i in range(3)])
    tokens = batch["target_unit"]
    assert (tokens == 0).sum() == 4 + 6 and tokens.size == 27 and batch["ntokens"] == 17
    jloss, jmets, _ = JLMCrossEntropy(Config())(jm, variables, {"target_unit": tokens},
                                                jax.random.PRNGKey(0), train=False)
    with torch.no_grad():
        loss, mets = LMCrossEntropy()(model, {"target_unit": torch.from_numpy(tokens)})
        padded_as_pad, _ = LMCrossEntropy()(model, {"target_unit": torch.from_numpy(
            np.where(tokens == 0, 1, tokens))})
    assert int(jmets["ntokens"]) == int(mets["ntokens"]) == 27  # the 10 pads counted
    _close(loss, jloss, FWD_TOL)
    assert abs(float(loss) - float(padded_as_pad)) > 1e-3


def test_arch_defaults(tmp_path):
    args = train_cli.parse_args([str(tmp_path), "--task", "unit_lm", "--max-update", "1"])
    assert (args.arch, args.criterion, args.decoder_embed_dim, args.decoder_ffn_embed_dim,
            args.decoder_layers, args.decoder_attention_heads, args.label_smoothing) == (
        "transformer_lm", "lm_cross_entropy", 512, 2048, 6, 8, 0.0)
    model = TASKS["unit_lm"](args).build_model()
    assert model.embed_tokens.num_embeddings == 1004 and model.layers == 6
    assert model.dropout.p == 0.1
    with pytest.raises(SystemExit):
        train_cli.parse_args([str(tmp_path), "--task", "language_modeling", "--arch",
                              "sedd_absorb", "--max-update", "1"])


def test_cli_train_then_eval_lm(lm, tmp_path):
    """cli.train --task language_modeling (2 updates, blocks of 12) then
    cli.eval_lm on the test split: its printed loss and perplexity equal
    the in-process NLL's and JAX's module's on the same weights."""
    from diffnorm_tpu_torch.cli import eval_lm
    from diffnorm_tpu_torch.train.checkpoint import load_variables

    _, _, jm, _ = lm
    data = write_unit_corpus(tmp_path)
    blocks = ["--tokens-per-sample", "12", "--sample-break-mode", "complete"]
    assert train_cli.main(lm_flags(data) + blocks + [
        "--max-update", "2", "--max-tokens", "48", "--save-dir", str(tmp_path / "ck"),
        "--log-interval", "1"]) == 0
    step = str(tmp_path / "ck" / "step_000000002")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert eval_lm.main(lm_flags(data, "sedd_lm") + blocks + [
            "--path", step, "--gen-subset", "test", "--max-tokens", "40"]) == 0
    line = out.getvalue().strip().splitlines()[-1]

    args = eval_lm.parse_args(lm_flags(data) + blocks + ["--path", step, "--max-tokens", "40"])
    task = TASKS[args.task](args)
    model = from_jax_variables(task.build_model(), load_variables(step)).eval()
    variables = load_variables(step)
    total, n, jtotal = 0.0, 0, 0.0
    batches = list(EpochBatchIterator(task.dataset("test"), 40, shuffle=False,
                                      num_prefetch=0).next_epoch_itr())
    jlogits = jax.jit(lambda v, prev: jm.apply(v, prev, deterministic=True))
    assert len(batches) > 1 and len({b["target_unit"].shape[1] for b in batches}) > 1
    for b in batches:
        s, k = eval_lm.nll(model, torch.from_numpy(b["target_unit"]).long())
        total, n = total + float(s), n + int(k)
        tokens = b["target_unit"]
        prev = np.concatenate([np.full((len(tokens), 1), 2, tokens.dtype), tokens[:, :-1]], 1)
        lp = jax.nn.log_softmax(jlogits(variables, prev), axis=-1)
        nll = -np.take_along_axis(np.asarray(lp), tokens[..., None], -1)[..., 0]
        jtotal += float(np.where(tokens != 1, nll, 0.0).sum())
    avg = total / n
    assert line == f"Loss (nats): {avg:.4f}, Perplexity: {math.exp(avg):.2f}"
    assert abs(jtotal / n - avg) < FWD_TOL
    assert eval_lm.evaluate(args) == pytest.approx((avg, n))
