"""Text machine translation in the port against the JAX package on the CPU,
float32, at tiny widths (dim 16, 2 + 2 layers, vocabularies of 40 and 44):
the Dictionary's counts and `save`, the indexed datasets' three layouts
(each package reading the other's files, the mmap writer byte for byte),
the bitext dataset's order and batches, the three tasks' prepared batches
(the CMLM canvases, the Levenshtein canvases, prev_output_tokens) and dummy
batches, `edit_path_targets`, each model's forward (the AR transformer with
a tied and an untied output, the text CMLM, the Levenshtein transformer;
logits within FWD_TOL, 1e-5), the AR beam decode (hypotheses equal, scores
within 1e-5), mask-predict with a length beam and guidance (tokens equal),
`levenshtein_decode` against JAX's `levenshtein_decode_jit` and its three
canvas helpers (tokens equal), and each criterion (within 1e-5).

JAX's TextEncoderLayer passes its dtype into MultiheadAttention's `quant`
(tests/test_torch_tts.py's docstring): the comparisons build JAX's modules
with that one call made by keyword (`_float_text_attention`), and
`test_text_transformer_fault_of_the_reference` pins what the slip does to
JAX's whole AR transformer. JAX's inits are traced (`jax.eval_shape`) to
check the port's seeded weights' names and shapes, never compiled."""

import struct

import jax
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.ce_loss import LabelSmoothedCrossEntropy as JLabelSmoothedCE
from diffnorm_tpu.criterions.levenshtein_loss import LevenshteinLoss as JLevenshteinLoss
from diffnorm_tpu.criterions.nar_loss import NARSpeechToUnitLoss as JNARLoss
from diffnorm_tpu.data import indexed_dataset as jidx
from diffnorm_tpu.data.dictionary import Dictionary as JDictionary
from diffnorm_tpu.generate.beam_search import ar_generate as jar_generate
from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jmask_predict_decode
from diffnorm_tpu.models import cmlm_text as jcmlm_text
from diffnorm_tpu.models import levenshtein as jlev
from diffnorm_tpu.models.transformer_text import TextTransformerModule as JTextTransformer
from diffnorm_tpu.models.vae import ModelHolder
from diffnorm_tpu.registry import ARCHITECTURES
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.registry import _import_all
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.ce_loss import LabelSmoothedCrossEntropy
from diffnorm_tpu_torch.criterions.levenshtein_loss import LevenshteinLoss, nat_loss
from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
from diffnorm_tpu_torch.data import indexed_dataset as idx
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.generate.beam_search import ar_generate
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.models import levenshtein as lev
from diffnorm_tpu_torch.models.cmlm_text import TextCMLMModule
from diffnorm_tpu_torch.models.levenshtein import LevenshteinModule
from diffnorm_tpu_torch.models.transformer_text import TextTransformerModule
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_variables, to_jax_variables
from tests.test_torch_multitask import _assert_batches_equal, _nested_torch
from tests.test_torch_nar_train import FWD_TOL, _assert_trees_close, _perturb
from tests.test_torch_tts import _keyword_mha
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

_import_all()
SRC_V, TGT_V = 40, 44
DIM, FFN, HEADS = 16, 32, 2
PAD, EOS, UNK = 1, 2, 3
SRC_WORDS = [f"s{k}" for k in range(SRC_V - 4)]
TGT_WORDS = [f"t{k}" for k in range(TGT_V - 4)]


@pytest.fixture(scope="module", autouse=True)
def _float_text_attention():
    """JAX's cmlm_text TextEncoderLayer with float attention projections
    for this module's comparisons (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcmlm_text, "MultiheadAttention", _keyword_mha)
        yield


def write_bitext(root, seed=0, splits=(("train", 10), ("valid", 4), ("test", 5)),
                 src="de", tgt="en"):
    """Line files of 3-9 words a line from the SRC_WORDS / TGT_WORDS
    vocabularies (the train split using every word, so a dictionary built
    from it has the full vocabulary)."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        for lang, words in ((src, SRC_WORDS), (tgt, TGT_WORDS)):
            lines = [" ".join(rng.choice(words, size=int(rng.integers(3, 10))))
                     for _ in range(n)]
            if split == "train":
                lines[0] = " ".join(words)
            (root / f"{split}.{lang}").write_text("\n".join(lines) + "\n")
    return root


def batch_tokens(rng, rows, vocab, lengths):
    """[rows, max(lengths)] token rows: words 4..vocab-1, EOS last, PAD after."""
    out = np.full((rows, max(lengths)), PAD, np.int32)
    for i, n in enumerate(lengths):
        out[i, :n - 1] = rng.integers(4, vocab, size=n - 1)
        out[i, n - 1] = EOS
    return out


def seeded(port_module, jax_module, *init_args):
    """The port's seeded init as a perturbed JAX variables tree, its names
    and shapes checked against JAX's traced init; the port's model on it in
    eval mode."""
    want = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *init_args))
    tree = to_jax_variables(port_module)
    assert ({k: tuple(np.shape(v)) for k, v in flatten_tree(tree).items()}
            == {k: tuple(v.shape) for k, v in flatten_tree(want).items()})
    variables = _perturb(tree, np.random.default_rng(1))
    return variables, from_jax_variables(port_module, variables).eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    src = batch_tokens(rng, 3, SRC_V, [9, 6, 4])
    tgt = batch_tokens(rng, 3, TGT_V, [8, 7, 5])
    return src, np.asarray([9, 6, 4], np.int32), tgt


def transformer_pair(share=True):
    kw = dict(encoder_dim=DIM, encoder_ffn_dim=FFN, encoder_layers=2, encoder_heads=HEADS,
              decoder_dim=DIM, decoder_ffn_dim=FFN, decoder_layers=2, decoder_heads=HEADS,
              dropout=0.1)
    torch.manual_seed(0)
    port = TextTransformerModule(SRC_V, TGT_V, share_decoder_input_output_embed=share, **kw)
    return port, JTextTransformer(SRC_V, TGT_V, share_decoder_input_output_embed=share, **kw)


@pytest.fixture(scope="module")
def transformer(inputs):
    src, lens, tgt = inputs
    port, jm = transformer_pair()
    from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right

    variables, model = seeded(port, jm, src, lens, shift_right(tgt))
    return jm, variables, model


@pytest.fixture(scope="module")
def cmlm(inputs):
    src, lens, tgt = inputs
    torch.manual_seed(0)
    kw = dict(dim=DIM, ffn_dim=FFN, encoder_layers=2, decoder_layers=2, heads=HEADS)
    variables, model = seeded(TextCMLMModule(SRC_V, TGT_V, **kw),
                              jcmlm_text.TextCMLMModule(SRC_V, TGT_V, **kw), src, lens, tgt)
    return jcmlm_text.TextCMLMModule(SRC_V, TGT_V, **kw), variables, model


@pytest.fixture(scope="module")
def levt(inputs):
    src, lens, tgt = inputs
    torch.manual_seed(0)
    kw = dict(dim=DIM, ffn_dim=FFN, encoder_layers=2, decoder_layers=2, heads=HEADS)
    jm = jlev.LevenshteinModule(SRC_V, TGT_V, **kw)
    variables, model = seeded(LevenshteinModule(SRC_V, TGT_V, **kw), jm, src, lens, tgt, tgt,
                              tgt)
    return jm, variables, model


def test_dictionary_counts_save_and_encode_match_jax(tmp_path):
    """add_symbol with counts, encode_line (unknown -> <unk>, and with
    add_if_not_exist), string and save: the port's file byte-equal to
    JAX's, each package loading the other's with the same symbols."""
    ours, theirs = Dictionary(), JDictionary()
    for d in (ours, theirs):
        for w, n in (("b", 3), ("a", 5), ("b", 2), ("<unk>", 4), ("c", 1)):
            d.add_symbol(w, n=n)
    for line, add in (("a b zz", False), ("a q b q", True), ("", False)):
        np.testing.assert_array_equal(ours.encode_line(line, add_if_not_exist=add),
                                      theirs.encode_line(line, add_if_not_exist=add))
    assert ours.symbols == theirs.symbols and ours.count == theirs.count
    ids = np.asarray([0, 4, 5, 1, 2, 3, 6])
    assert ours.string(ids) == theirs.string(ids)
    ours.save(str(tmp_path / "ours.txt"))
    theirs.save(str(tmp_path / "theirs.txt"))
    assert (tmp_path / "ours.txt").read_bytes() == (tmp_path / "theirs.txt").read_bytes()
    (tmp_path / "odd.txt").write_text("x 2\ny z\nw 1\n7\n")
    for path in ("theirs.txt", "odd.txt"):
        a, b = Dictionary.load(str(tmp_path / path)), JDictionary.load(str(tmp_path / path))
        assert a.symbols == b.symbols and a.count == b.count


def _write_legacy(prefix, items):
    """A TorchNet (TNTIDX) index and data file of int64 items, the tokens
    stored + 1, as fairseq's IndexedDatasetBuilder writes them."""
    sizes = [len(x) for x in items]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    with open(prefix + ".idx", "wb") as f:
        f.write(b"TNTIDX\x00\x00" + struct.pack("<Q", 1) + struct.pack("<QQ", 5, 8))
        f.write(struct.pack("<QQ", len(items), len(items)))
        np.arange(len(items) + 1, dtype=np.int64).tofile(f)
        offsets.tofile(f)
        np.asarray(sizes, np.int64).tofile(f)
    np.concatenate(items).astype(np.int64).__add__(1).tofile(prefix + ".bin")


@pytest.mark.parametrize("layout", ["mmap", "native", "legacy"])
def test_indexed_datasets_interchange_with_jax(tmp_path, layout):
    """Each layout written by one package reads back equal in both: the
    mmap and native writers byte-equal to JAX's (the mmap one at a uint16
    and a uint32 vocabulary), the legacy (TNTIDX) file written by hand."""
    rng = np.random.default_rng(3)
    items = [rng.integers(0, 60000, size=int(n)) for n in (5, 1, 9, 3)]
    if layout == "legacy":
        _write_legacy(str(tmp_path / "x"), items)
        prefixes = [str(tmp_path / "x")]
    else:
        prefixes = []
        for vocab in ((60000, 70000) if layout == "mmap" else (None,)):
            for name, module in (("ours", idx), ("theirs", jidx)):
                prefix = str(tmp_path / f"{name}{vocab}")
                builder = module.make_builder(prefix, impl=layout, vocab_size=vocab)
                for item in items:
                    builder.add_item(item)
                builder.finalize()
                prefixes.append(prefix)
            for ext in (".bin", ".idx"):
                assert (open(prefixes[-2] + ext, "rb").read()
                        == open(prefixes[-1] + ext, "rb").read()), ext
    for prefix in prefixes:
        assert idx.infer_dataset_impl(prefix) == jidx.infer_dataset_impl(prefix)
        ours, theirs = idx.IndexedDataset(prefix), jidx.IndexedDataset(prefix)
        np.testing.assert_array_equal(ours.sizes, theirs.sizes)
        for i, item in enumerate(items):
            np.testing.assert_array_equal(ours[i], theirs[i])
            np.testing.assert_array_equal(ours[i], item)


def text_tasks(root, task, arch, *extra):
    """(the port's task, JAX's task) on the de-en bitext at `root`."""
    args = train_cli.parse_args([str(root), "--task", task, "--arch", arch, "--max-update", "1",
                                 "--source-lang", "de", "--target-lang", "en", *extra])
    cfg = {k: v for k, v in vars(args).items() if v is not None and v is not False}
    return TASKS[task](args), JTASKS.get(task).setup_task(Config(**cfg))


@pytest.mark.parametrize("data", ["line files", "binarized"])
def test_tasks_batches_match_jax(tmp_path, data):
    """The three tasks on a bitext of line files (unit dictionaries: the
    words become <unk>) and on cli.preprocess's binarized pairs with their
    dictionaries: the dictionaries, each split's order and a collated batch
    prepared from one seeded generator (the CMLM canvas with --use-side on
    and off, the Levenshtein canvases, prev_output_tokens) equal to JAX's."""
    from diffnorm_tpu_torch.cli import preprocess

    root = write_bitext(tmp_path)
    if data == "binarized":
        assert preprocess.main(["-s", "de", "-t", "en", "--trainpref", str(root / "train"),
                                "--validpref", str(root / "valid"), "--destdir",
                                str(tmp_path / "bin")]) == 0
        root = tmp_path / "bin"
    for task_name, arch, extra in (("cmlm_cg", "cmlm_transformer", ()),
                                   ("cmlm_cg", "cmlm_transformer", ("--use-side",)),
                                   ("translation_lev", "levenshtein_transformer", ()),
                                   ("translation", "transformer", ())):
        task, jtask = text_tasks(root, task_name, arch, *extra)
        assert task.src_dict.symbols == jtask.src_dict.symbols
        assert task.tgt_dict.symbols == jtask.tgt_dict.symbols
        for split in ("train", "valid"):
            ds, jds = task.dataset(split), jtask.dataset(split)
            order = ds.ordered_indices()
            np.testing.assert_array_equal(order, jds.ordered_indices())
            got = ds.collater([ds[int(i)] for i in order[:4]])
            want = jds.collater([jds[int(i)] for i in order[:4]])
            _assert_batches_equal(got, want)
            # one generator over several batches, as cli.train draws them
            rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
            for _ in range(3):
                _assert_batches_equal(task.prepare_batch(dict(got), rng),
                                      jtask.prepare_batch(dict(want), jrng))


@pytest.mark.parametrize("task_name,arch", [("dummy_cmlm_cg", "cmlm_transformer"),
                                            ("dummy_translation", "transformer"),
                                            ("dummy_lev", "levenshtein_transformer")])
def test_dummy_tasks_match_jax(tmp_path, task_name, arch):
    """The dummy tasks' batches (unit dictionaries of --src-vocab-size and
    --target-code-size) equal to JAX's, the dataset `dataset_size` copies."""
    task_of = {"dummy_cmlm_cg": "cmlm_cg", "dummy_translation": "translation",
               "dummy_lev": "translation_lev"}
    args = train_cli.parse_args([str(tmp_path), "--task", task_of[task_name], "--arch", arch,
                                 "--max-update", "1", "--src-vocab-size", "24",
                                 "--target-code-size", "20"])
    args.batch_size, args.dataset_size, args.tokens_per_sample = 3, 5, 10
    task = TASKS[task_name](args)
    jtask = JTASKS.get(task_name).setup_task(Config(
        arch=arch, data=str(tmp_path), src_vocab_size=24, target_code_size=20, batch_size=3,
        dataset_size=5, tokens_per_sample=10))
    _assert_batches_equal(task.dummy_batch(3, 10), jtask.dummy_batch(3, 10))
    ds, jds = task.dataset("train"), list(jtask.dataset("train"))
    assert len(ds) == len(jds) == 5
    _assert_batches_equal(ds[4], jds[4])


def test_arch_defaults_match_jax():
    """Each arch's widths (the three transformers, cmlm_transformer,
    levenshtein_transformer) where no flag is set: JAX's registered arch
    function, then its build_model's defaults."""
    defaults = {"encoder_ffn_embed_dim": 2048, "encoder_layers": 6,
                "encoder_attention_heads": 8, "dropout": 0.1}
    for arch, fn in train_cli.TEXT_ARCHS.items():
        keys = ("encoder_embed_dim", "encoder_ffn_embed_dim", "encoder_layers",
                "encoder_attention_heads", "decoder_layers", "dropout")
        if arch.startswith("transformer"):
            keys += ("decoder_embed_dim", "decoder_ffn_embed_dim", "decoder_attention_heads")
        ours = dict.fromkeys(keys)
        fn(ours)
        cfg = Config()
        ARCHITECTURES.get(arch)[1](cfg)
        assert ours == {k: cfg.get(k, defaults.get(k)) for k in keys}, arch


@pytest.mark.parametrize("share", [True, False])
def test_transformer_forward_matches_jax(inputs, share):
    """The teacher-forced logits of the AR transformer within FWD_TOL of
    JAX's, with the output tied to the embedding and with `output_proj`;
    the cached decode steps against the full forward."""
    from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right

    src, lens, tgt = inputs
    prev = shift_right(tgt)
    port, jm = transformer_pair(share)
    variables, model = seeded(port, jm, src, lens, prev)
    assert ("output_proj" in variables["params"]["decoder"]) is not share
    want = jax.jit(lambda v: jm.apply(v, src, lens, prev)["logits"])(variables)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(lens),
                    torch.from_numpy(prev))["logits"]
        enc, mask = model.encode(torch.from_numpy(src))
        cache = model.init_cache(enc, mask, prev.shape[1])
        pos = torch.zeros(3, dtype=torch.int64)
        steps = torch.stack([model.decode_step(torch.from_numpy(prev[:, t:t + 1]).long(),
                                               cache, pos + t)[0]
                             for t in range(prev.shape[1])], dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    real = np.cumprod(prev != PAD, axis=1).astype(bool)
    np.testing.assert_allclose(steps.numpy()[real], got.numpy()[real], rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_transformer_beam_decode_matches_jax(transformer, inputs):
    """ar_generate, beam 3, a length penalty and ngram blocking over 12
    steps: every hypothesis equal to JAX's and the scores within 1e-5."""
    jm, variables, model = transformer
    src, lens, _ = inputs
    kw = dict(beam_size=3, max_len=12, len_penalty=0.6, no_repeat_ngram=2)
    seqs, scores = ar_generate(model, torch.from_numpy(src), torch.from_numpy(lens), **kw)
    jseqs, jscores = jar_generate(ModelHolder(jm, Config()), variables, src, lens, **kw)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-5)
    assert len({tuple(r) for r in seqs[:, 0].tolist()}) == 3


def test_cmlm_forward_and_mask_predict_match_jax(cmlm, inputs):
    """The text CMLM's forward (logits, length logits and targets, the
    canvas mask) within FWD_TOL of JAX's, the CG null context; mask-predict
    with a length beam of 3 and guidance 1.5: tokens and step counts equal,
    scores within 1e-5."""
    jm, variables, model = cmlm
    src, lens, tgt = inputs
    canvas = np.where((tgt != PAD) & (tgt != EOS) & (np.arange(tgt.shape[1]) % 2 == 0), UNK,
                      tgt)
    want = jax.jit(lambda v: jm.apply(v, src, lens, canvas, tgt_tokens=tgt))(variables)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (src, lens, canvas, tgt)))
    for key in ("logits", "length_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)
    for key in ("length_tgt", "word_ins_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    drop = np.asarray([True, False, True])
    with torch.no_grad():
        enc, mask = model.encode(torch.from_numpy(src))
        nulled = model.apply_cg_drop(enc, mask, torch.from_numpy(drop))
    jenc = jm.apply(variables, src, method="encode")
    jnull = jm.apply(variables, *jenc, drop, method="apply_cg_drop")
    np.testing.assert_allclose(nulled[0].numpy(), np.asarray(jnull[0]), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_array_equal(nulled[1].numpy(), np.asarray(jnull[1]))
    kw = dict(max_iter=4, max_len=14, cond_scale=1.5, length_beam=3)
    tokens, scores, steps = mask_predict_decode(model, torch.from_numpy(src),
                                                torch.from_numpy(lens), **kw)
    jtokens, jscores, jsteps = jmask_predict_decode(ModelHolder(jm, Config()), variables, src,
                                                    lens, **kw)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jsteps))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-5)


def test_levenshtein_forward_and_helpers_match_jax(levt, inputs):
    """The three heads' logits within FWD_TOL of JAX's on three canvases;
    _left_pack, apply_del_words and apply_ins_masks (insertions past the
    canvas's width clipped) equal to JAX's on random canvases."""
    jm, variables, model = levt
    src, lens, tgt = inputs
    rng = np.random.default_rng(11)
    canvases = [np.where(rng.random(tgt.shape) < 0.3, UNK, tgt).astype(np.int32)
                for _ in range(3)]
    want = jax.jit(lambda v: jm.apply(v, src, lens, *canvases))(variables)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(lens),
                    *(torch.from_numpy(c) for c in canvases))
    for key in ("del_logits", "ins_logits", "word_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)
    canvas = batch_tokens(rng, 4, TGT_V, [10, 7, 3, 2])
    canvas[:, 0] = 0  # BOS
    canvas = np.pad(canvas, ((0, 0), (0, 4)), constant_values=PAD)
    keep = rng.random(canvas.shape) < 0.6
    np.testing.assert_array_equal(
        lev._left_pack(torch.from_numpy(canvas), torch.from_numpy(keep)).numpy(),
        np.asarray(jlev._left_pack(canvas, keep)))
    packed = np.array(jlev.apply_del_words(canvas, keep))
    np.testing.assert_array_equal(
        lev.apply_del_words(torch.from_numpy(canvas), torch.from_numpy(keep)).numpy(), packed)
    n_ins = rng.integers(0, 4, size=(4, canvas.shape[1] - 1)).astype(np.int32)
    n_ins[0, 1] = 9  # past the width left
    np.testing.assert_array_equal(
        lev.apply_ins_masks(torch.from_numpy(packed), torch.from_numpy(n_ins)).numpy(),
        np.asarray(jlev.apply_ins_masks(packed, n_ins)))


@pytest.mark.parametrize("eos_penalty", [0.0, 2.0])
def test_levenshtein_decode_matches_jax(levt, inputs, eos_penalty):
    """levenshtein_decode against JAX's levenshtein_decode_jit, 5
    iterations on a 24-token canvas: every token equal; the canvases fill
    and differ across rows."""
    jm, variables, model = levt
    src, lens, _ = inputs
    kw = dict(max_iter=5, max_len=24, eos_penalty=eos_penalty)
    got = lev.levenshtein_decode(model, torch.from_numpy(src), torch.from_numpy(lens), **kw)
    want = jlev.levenshtein_decode_jit(ModelHolder(jm, Config()), variables, src, lens, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != PAD).sum(1).min() > 2


def test_edit_path_targets_match_jax():
    """edit_path_targets on random canvases against random targets
    (shared tokens, PAD tails, an empty row): equal to JAX's."""
    rng = np.random.default_rng(12)
    prev = rng.integers(4, 9, size=(6, 11)).astype(np.int32)
    tgt = rng.integers(4, 9, size=(6, 13)).astype(np.int32)
    for i, (p, t) in enumerate(((11, 13), (7, 4), (1, 9), (0, 5), (11, 0), (5, 13))):
        prev[i, p:], tgt[i, t:] = PAD, PAD
    got = lev.edit_path_targets(prev, tgt)
    want = jlev.edit_path_targets(prev, tgt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() > 0 and got[1].sum() > 0


def test_criterions_match_jax(transformer, cmlm, levt, inputs, tmp_path):
    """label_smoothed_cross_entropy on the AR transformer, nar_speech_to_unit
    on the text CMLM and levenshtein_loss on the Levenshtein transformer
    (the task's canvases), in the validation forward: the loss and every
    term within 1e-5 relative of JAX's, the counts equal."""
    from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right
    from diffnorm_tpu_torch.tasks.nar_s2ut_task import random_mask

    src, lens, tgt = inputs
    task, _ = text_tasks(write_bitext(tmp_path), "translation_lev",
                         "levenshtein_transformer", "--target-code-size", str(TGT_V - 4))
    base = {"src_tokens": src, "src_lengths": lens, "target": tgt}
    cases = (
        (transformer, LabelSmoothedCrossEntropy(0.1), JLabelSmoothedCE(Config()),
         {**base, "prev_output_tokens": shift_right(tgt)}),
        (cmlm, NARSpeechToUnitLoss(0.2), JNARLoss(Config()),
         {**base, "prev_target": random_mask(tgt, np.random.default_rng(2))}),
        (levt, LevenshteinLoss(0.1), JLevenshteinLoss(Config()),
         task.prepare_batch(dict(base), np.random.default_rng(3))))
    for (jm, variables, model), crit, jcrit, batch in cases:
        holder = ModelHolder(jm, Config())
        _, want, _ = jax.jit(lambda v, b, jcrit=jcrit, holder=holder: jcrit(
            holder, v, b, jax.random.PRNGKey(0), train=False))(variables, batch)
        with torch.no_grad():
            _, got = crit(model, _nested_torch(batch))
        assert sorted(got) == sorted(want), type(crit).__name__
        for key, value in want.items():
            np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-5,
                                       err_msg=f"{type(crit).__name__} {key}")


def test_nat_loss_dispatches_on_the_arch():
    """nat_loss: the Levenshtein criterion for a levenshtein arch, the NAR
    masked CE otherwise, each at its own default smoothing, as JAX's
    alias."""
    from diffnorm_tpu.criterions.aliases import NatLoss

    for arch, cls in (("levenshtein_transformer", LevenshteinLoss),
                      ("cmlm_transformer", NARSpeechToUnitLoss)):
        crit, jcrit = nat_loss(arch), NatLoss(Config(arch=arch))
        assert isinstance(crit, cls) and crit.eps == jcrit.eps


def test_weights_round_trip(transformer, cmlm, levt):
    """to_jax_variables gives each model's JAX tree back bit for bit."""
    for name, (_, variables, model) in (("transformer", transformer), ("cmlm", cmlm),
                                        ("levt", levt)):
        _assert_trees_close(to_jax_variables(model), variables, 0.0, name)


def test_text_transformer_fault_of_the_reference(transformer, inputs, monkeypatch):
    """JAX's AR transformer as the package builds it runs its encoder's
    attention projections in int8 (the TextEncoderLayer slip): its logits
    stand off the float model's by more than 1e-3, while the port's are the
    float model's (test_transformer_forward_matches_jax)."""
    from diffnorm_tpu.models.nar_transformer import MultiheadAttention as JMultiheadAttention
    from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right

    jm, variables, model = transformer
    src, lens, tgt = inputs
    prev = shift_right(tgt)
    monkeypatch.setattr(jcmlm_text, "MultiheadAttention", JMultiheadAttention)
    as_built = np.asarray(jm.apply(variables, src, lens, prev)["logits"])
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(lens),
                    torch.from_numpy(prev))["logits"].numpy()
    assert np.abs(as_built - got).max() > 1e-3
