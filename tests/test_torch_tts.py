"""Text-input TTS in the port against the JAX package on the CPU, float32,
at tiny widths: the text_to_speech dataset's collated batches (duration,
pitch and energy columns, the dictionary built from the training text) and
dummy_tts's; the tts_transformer's encoder, teacher-forced forward and
Tacotron2 loss in training mode with its encoder's and postnet's BatchNorm
statistics; its AR rollout (every frame, the lengths, the EOS
probabilities); `length_regulate` and the pitch and energy bins at their
edges; FastSpeech2's forward on given and on predicted durations and its
loss; the weights' round trip with their BatchNorm statistics.

Tolerances: forwards, losses and rollouts within 1e-5 (FWD_TOL, relative
and absolute), BatchNorm statistics within 1e-6 (STATS_TOL), the same as
tests/test_torch_s2spect.py's; integer outputs (bins, frame masks, lengths,
predicted durations) equal.

JAX's `models/cmlm_text.py` TextEncoderLayer builds its self-attention as
MultiheadAttention(dim, heads, dropout, dtype), whose fourth field is
`quant`, not `dtype`: the dtype lands in `quant`, a truthy value, so the
attention's q/k/v/out projections run JAX's int8 W8A8 path in every model
built on that layer (the tts_transformer's encoder, FastSpeech2's encoder
and decoder). fairseq's layer, and JAX's own UnitY copy of it
(`models/unity.py:45-74`, dtype by keyword), are float. The port follows
the float layer (one TextEncoderLayer, `models/cmlm_text.py`); the
comparisons here run JAX's modules with that one call made by keyword
(`_float_text_attention`, the JAX package itself unchanged), and
`test_text_encoder_layer_fault_of_the_reference` pins the fault.

JAX draws the Tacotron prenet's inference dropout from its own PRNG
stream, which torch cannot reproduce, so the tts_transformer runs at
prenet_dropout 0 in both packages, as PR 20's spectrogram tests do
(tests/test_torch_s2spect.py holds the draw itself). FastSpeech2's dropout
is 0.1 whatever the flags say in both packages (JAX's build_model passes
none), so its comparisons run in eval mode, the validation forward."""

import copy

import jax
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.tts_loss import FastSpeech2Loss as JFastSpeech2Loss
from diffnorm_tpu.criterions.tts_loss import Tacotron2Loss as JTacotron2Loss
from diffnorm_tpu.generate.speech_ar import ar_speech_generate as jar_speech_generate
from diffnorm_tpu.models import cmlm_text as jcmlm_text
from diffnorm_tpu.models.fastspeech2 import FastSpeech2Module as JFastSpeech2Module
from diffnorm_tpu.models.fastspeech2 import length_regulate as jlength_regulate
from diffnorm_tpu.models.nar_transformer import MultiheadAttention as JMultiheadAttention
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.generate.speech_ar import ar_speech_generate
from diffnorm_tpu_torch.models.fastspeech2 import length_regulate, quantize
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.weights import (
    flatten_tree,
    from_jax_variables,
    load_npz,
    save_npz,
    to_jax_variables,
)
from tests.test_torch_multitask import _assert_batches_equal, _nested_torch
from tests.test_torch_nar_train import FWD_TOL, STATS_TOL, _assert_trees_close, _perturb
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

PAD = 1
MEL = 6
WORDS = [f"w{k}" for k in range(9)]
TTS_TINY = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_transformer_layers=2,
                decoder_transformer_layers=2, encoder_attention_heads=2, output_frame_dim=MEL,
                prenet_dim=8, postnet_conv_dim=8, postnet_layers=2, encoder_conv_layers=2,
                prenet_dropout=0.0, postnet_dropout=0.0, encoder_dropout=0.0, dropout=0.0)
FS2_TINY = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=1,
                decoder_layers=2, encoder_attention_heads=2, output_frame_dim=MEL,
                max_target_positions=32)
MAX_ITER = 10


def _keyword_mha(dim, heads, dropout=0.0, dtype=None, name=None):
    """JAX cmlm_text's MultiheadAttention call with its dtype by keyword."""
    return JMultiheadAttention(dim, heads, dropout=dropout, dtype=dtype, name=name)


@pytest.fixture(scope="module", autouse=True)
def _float_text_attention():
    """JAX's cmlm_text TextEncoderLayer with float attention projections
    for this module's comparisons (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcmlm_text, "MultiheadAttention", _keyword_mha)
        yield


def flags(values):
    return [f"--{k.replace('_', '-')}={v}" for k, v in values.items()]


def write_tts_corpus(root, seed=0, splits=(("train", 4), ("dev", 2), ("test", 3)),
                     variances=True):
    """Absolute `.npy` mel paths (JAX's dataset reads them as written), 3-6
    words a row, 5-13 frames; with `variances` the duration column (summing
    to the frames, one token of duration 0) and per-token pitch and energy
    files."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        rows = []
        for i in range(n):
            uid, words = f"{split}{i}", rng.choice(WORDS, size=int(rng.integers(3, 7)))
            t = int(rng.integers(5, 14))
            np.save(root / f"{uid}.npy", rng.normal(size=(t, MEL)).astype(np.float32))
            row = {"id": uid, "audio": str(root / f"{uid}.npy"), "n_frames": t,
                   "tgt_text": " ".join(words)}
            if variances:
                n_tok = len(words) + 1  # the text and </s>
                cuts = np.sort(rng.integers(0, t + 1, size=n_tok - 1))
                dur = np.diff(np.concatenate([[0], cuts, [t]]))
                dur[1] += dur[0]
                dur[0] = 0  # a token of duration 0
                row["duration"] = " ".join(str(int(x)) for x in dur)
                for key in ("pitch", "energy"):
                    np.save(root / f"{uid}_{key}.npy",
                            rng.normal(size=(n_tok,)).astype(np.float32) * 3)
                    row[key] = str(root / f"{uid}_{key}.npy")
            rows.append(row)
        cols = list(rows[0])
        with open(root / f"{split}.tsv", "w") as f:
            f.write("\t".join(cols) + "\n")
            for r in rows:
                f.write("\t".join(str(r[c]) for c in cols) + "\n")
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_tts_corpus(tmp_path_factory.mktemp("tts"))


def tts_tasks(root, arch, **extra):
    """(the port's task, JAX's task) for --task text_to_speech."""
    values = {**(FS2_TINY if arch.startswith("fastspeech") else TTS_TINY), **extra}
    args = train_cli.parse_args([str(root), "--task", "text_to_speech", "--arch", arch,
                                 "--max-update", "1", *flags(values)])
    jtask = JTASKS.get("text_to_speech").setup_task(Config(
        task="text_to_speech", arch=arch, criterion=args.criterion, data=str(root),
        **values))
    return TASKS[args.task](args), jtask


def prepared(task, jtask, rows=(0, 1, 2, 3)):
    out = []
    for t in (task, jtask):
        ds = t.dataset("train")
        out.append(t.prepare_batch(ds.collater([ds[i] for i in rows]),
                                   np.random.default_rng(0)))
    return out


def seeded_variables(task, jtask, jm, batch):
    """The port's init (seeded 0) as a JAX variables tree, perturbed, once
    its names and shapes are checked against JAX's init, which is traced
    (`jax.eval_shape`) and not compiled."""
    want = jax.eval_shape(lambda b: jtask.init_variables(jm, jax.random.PRNGKey(0), b), batch)
    torch.manual_seed(0)
    tree = to_jax_variables(task.build_model())
    assert ({k: tuple(np.shape(v)) for k, v in flatten_tree(tree).items()}
            == {k: tuple(v.shape) for k, v in flatten_tree(want).items()})
    return _perturb(tree, np.random.default_rng(1))


def build(root, arch, **extra):
    """(port task, JAX task, batch, JAX module, perturbed variables, the
    port's model on them, in eval mode)."""
    task, jtask = tts_tasks(root, arch, **extra)
    batch, jbatch = prepared(task, jtask)
    _assert_batches_equal(batch, jbatch)
    jm = jtask.build_model()
    variables = seeded_variables(task, jtask, jm, batch)
    if arch.startswith("tts"):
        variables["params"]["dec_pos_alpha"] = np.asarray([0.7], np.float32)
        variables["params"]["enc_pos_alpha"] = np.asarray([1.3], np.float32)
    model = from_jax_variables(task.build_model(), variables).eval()
    return task, jtask, batch, jm.module, variables, model


@pytest.fixture(scope="module")
def tts(corpus):
    return build(corpus, "tts_transformer")


@pytest.fixture(scope="module")
def fs2(corpus):
    return build(corpus, "fastspeech2")


def test_dataset_collates_as_jax(corpus, tmp_path):
    """The text_to_speech dataset: the dictionary built from the training
    text, the order and the collated batch (durations, pitches and
    energies cut or padded to the longest source) equal to JAX's; a corpus
    with dict.txt and without the variance columns too."""
    task, jtask = tts_tasks(corpus, "fastspeech2")
    assert task.src_dict.symbols == jtask.src_dict.symbols and task.tgt_dict is task.src_dict
    got, want = prepared(task, jtask, rows=(3, 0, 2, 1))
    _assert_batches_equal(got, want)
    assert {"durations", "pitches", "energies"} <= set(got)
    for split in ("train", "dev"):
        np.testing.assert_array_equal(task.dataset(split).ordered_indices(),
                                      jtask.dataset(split).ordered_indices())
    np.testing.assert_array_equal(got["prev_feats"][:, 1:], got["feat_tgt"][:, :-1])
    plain = write_tts_corpus(tmp_path, seed=3, variances=False)
    (plain / "dict.txt").write_text("".join(f"{w} 1\n" for w in reversed(WORDS)))
    task, jtask = tts_tasks(plain, "tts_transformer")
    assert task.src_dict.symbols == jtask.src_dict.symbols
    got, want = prepared(task, jtask, rows=(1, 3))
    _assert_batches_equal(got, want)
    assert "durations" not in got


def test_dummy_tts_batches_match_jax(corpus):
    """dummy_tts: the vocab_size dictionary and dummy_batch equal to JAX's,
    the dataset `dataset_size` copies of it."""
    from diffnorm_tpu.tasks.tts_task import DummyTTSTask as JDummy

    args = train_cli.parse_args([str(corpus), "--task", "text_to_speech", "--max-update", "1",
                                 "--output-frame-dim", str(MEL)])
    args.vocab_size, args.batch_size, args.dataset_size = 30, 3, 5
    jtask = JDummy(Config(arch="tts_transformer", data=str(corpus), output_frame_dim=MEL,
                          vocab_size=30))
    task = TASKS["dummy_tts"](args)
    assert len(task.src_dict) == len(jtask.src_dict) == 30
    _assert_batches_equal(task.dummy_batch(3, 13), jtask.dummy_batch(3, 13))
    ds = task.dataset("train")
    assert len(ds) == 5
    _assert_batches_equal(ds[4], jtask.dummy_batch(3, 16))


def test_tts_encoder_forward_and_loss_match_jax(tts):
    """The tts_transformer: the encoder's states and mask, the eval
    forward's post_feat, feat and eos_logits within FWD_TOL of JAX's; the
    Tacotron2 criterion in a training forward (batch statistics, dropout 0):
    loss and terms within FWD_TOL relative, the counts equal, the encoder's
    and the postnet's BatchNorm statistics (momentum 0.99) within
    STATS_TOL."""
    task, jtask, batch, jm, variables, model = tts

    def jax_forward(v, b):
        kw = dict(deterministic=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return (jm.apply(v, b["src_tokens"], method="encode"),
                jm.apply(v, b["src_tokens"], b["src_lengths"], b["prev_feats"], b["tgt_mask"],
                         **kw))

    (want_enc, want_mask), want = jax.jit(jax_forward)(variables, batch)
    t = _nested_torch({k: batch[k] for k in ("src_tokens", "src_lengths", "prev_feats",
                                             "tgt_mask")})
    with torch.no_grad():
        enc, mask = model.encode(t["src_tokens"])
        got = model(t["src_tokens"], t["src_lengths"], t["prev_feats"], t["tgt_mask"])
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert not mask.numpy().all()  # ragged rows
    for key in ("post_feat", "feat", "eos_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)
    jcrit = JTacotron2Loss(Config(bce_pos_weight=5.0), jtask)
    holder = jtask.build_model()
    want_loss, want, mutated = jax.jit(lambda v, b: jcrit(holder, v, b, jax.random.PRNGKey(0),
                                                          train=True))(variables, batch)
    model = copy.deepcopy(model).train()
    with torch.no_grad():
        loss, got = task.build_criterion()(model, _nested_torch(batch),
                                           generator=torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=FWD_TOL)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=FWD_TOL, err_msg=key)
    stats = to_jax_variables(model)["batch_stats"]
    assert {"enc_bn_0", "enc_bn_1", "postnet"} <= set(stats)
    _assert_trees_close(stats, jax.device_get(mutated["batch_stats"]), STATS_TOL, "stats")


def test_tts_rollout_matches_jax(tts):
    """ar_speech_generate on the text encoder (no lengths) over all MAX_ITER
    steps: every frame and EOS probability within FWD_TOL of JAX's, the
    lengths equal, at a threshold the rows cross at different steps."""
    task, jtask, batch, jm, variables, model = tts
    src = torch.from_numpy(batch["src_tokens"])
    assert not model.encode_needs_lengths
    _, _, probe = ar_speech_generate(model, src, max_iter=MAX_ITER)
    # half the rows cross it at the first step, the others later or never
    threshold = float(np.median(probe[:, 0].numpy()))
    feat, out_lens, eos_prob = ar_speech_generate(model, src, max_iter=MAX_ITER,
                                                  eos_prob_threshold=threshold)
    holder = jtask.build_model()
    want = jax.jit(lambda v, s: jar_speech_generate(holder, v, s, max_iter=MAX_ITER,
                                                    eos_prob_threshold=threshold))(
        variables, batch["src_tokens"])
    assert feat.shape == (4, MAX_ITER, MEL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want[0]), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(eos_prob.numpy(), np.asarray(want[2]), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert len(set(out_lens.tolist())) > 1


@pytest.mark.parametrize("case", ["zero durations", "total above max_frames", "empty row",
                                  "ragged"])
def test_length_regulate_edges_match_jax(case):
    """Tokens of duration 0 skipped, a total above max_frames cut, a row of
    no frames, frames past a row's total taking its last position's state
    (masked): outputs and masks equal to JAX's."""
    durations = {"zero durations": [[0, 3, 0, 2, 0], [1, 0, 0, 0, 4]],
                 "total above max_frames": [[4, 5, 3, 2, 6], [9, 0, 9, 0, 1]],
                 "empty row": [[0, 0, 0, 0, 0], [2, 2, 2, 2, 2]],
                 "ragged": [[1, 2, 3, 0, 0], [5, 1, 0, 0, 0]]}[case]
    x = np.random.default_rng(2).normal(size=(2, 5, 3)).astype(np.float32)
    d = np.asarray(durations, np.int32)
    out, mask = length_regulate(torch.from_numpy(x), torch.from_numpy(d), 12)
    want_out, want_mask = jlength_regulate(x, d, 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(mask.numpy().sum(1), np.minimum(d.sum(1), 12))


def test_quantize_matches_jax_at_its_edges():
    """The pitch and energy bins: values below, at and above [-4, 4], bin
    boundaries, negative and positive fractions, truncated then clipped,
    equal to JAX's `_quantize`."""
    v = np.asarray([-9.0, -4.0001, -4.0, -3.99, -1.3, -0.03125, 0.0, 0.03125, 1.2999,
                    3.96875, 3.999, 4.0, 4.5, 1e6], np.float32)
    got = quantize(torch.from_numpy(v))
    want = np.asarray(JFastSpeech2Module._quantize(None, jax.numpy.asarray(v)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == 0 and got.max() == 255


@pytest.mark.parametrize("durations", ["given", "predicted"])
def test_fastspeech2_forward_matches_jax(fs2, durations):
    """The eval forward on the batch's gold durations, pitches and energies,
    and on predicted ones (the duration head's bias set to log(1 + 6), so
    rows fill frames, the longest past the 32-frame buffer): mel, mel_post,
    log_dur, pitch and energy within FWD_TOL of JAX's, the frame masks
    equal; the generator's features and masks too."""
    from diffnorm_tpu.models.fastspeech2 import NonARSpeechGenerator as JGenerator
    from diffnorm_tpu_torch.models.fastspeech2 import NonARSpeechGenerator

    task, jtask, batch, jm, variables, model = fs2
    kw = {}
    if durations == "given":
        kw = {k: batch[k] for k in ("durations", "pitches", "energies")}
    else:
        variables = copy.deepcopy(variables)
        variables["params"]["dur_predictor"]["proj"]["bias"] = np.asarray([np.log(7.0)],
                                                                          np.float32)
        model = from_jax_variables(copy.deepcopy(model), variables)
    want = jax.jit(lambda v, s, kw: jm.apply(v, s, deterministic=True, **kw))(
        variables, batch["src_tokens"], kw)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["src_tokens"]),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    for key in ("mel", "mel_post", "log_dur", "pitch", "energy"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)
    np.testing.assert_array_equal(got["frame_mask"].numpy(), np.asarray(want["frame_mask"]))
    frames = got["frame_mask"].numpy().sum(1)
    assert frames.min() > 0 and len(set(frames.tolist())) > 1
    if durations == "predicted":
        assert frames.max() == 32  # a row cut at the buffer
        res = NonARSpeechGenerator(model).generate(torch.from_numpy(batch["src_tokens"]))
        ref = JGenerator(jtask.build_model(), variables).generate(batch["src_tokens"])
        np.testing.assert_allclose(res["feature"], ref["feature"], rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_array_equal(res["frame_mask"], ref["frame_mask"])


def test_fastspeech2_loss_matches_jax(fs2):
    """fastspeech2_loss in the validation forward: the loss, l1, duration,
    pitch and energy terms within FWD_TOL relative of JAX's FastSpeech2Loss,
    the counts (sample_size = nsentences) equal."""
    task, jtask, batch, jm, variables, model = fs2
    jcrit = JFastSpeech2Loss(Config(), jtask)
    holder = jtask.build_model()
    want_loss, want, _ = jax.jit(lambda v, b: jcrit(holder, v, b, jax.random.PRNGKey(0),
                                                    train=False))(variables, batch)
    with torch.no_grad():
        loss, got = task.build_criterion()(model, _nested_torch(batch))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=FWD_TOL)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=FWD_TOL, err_msg=key)
    assert float(got["sample_size"]) == batch["src_tokens"].shape[0]


def test_weights_round_trip(tts, fs2, tmp_path):
    """to_jax_variables gives back the JAX tree (params and the encoder's
    and postnet's batch_stats) bit for bit, and save_npz / load_npz keep it."""
    for name, (_, _, _, _, variables, model) in (("tts", tts), ("fs2", fs2)):
        tree = to_jax_variables(model)
        assert sorted(tree) == sorted(variables)
        _assert_trees_close(tree, variables, 0.0, name)
        save_npz(str(tmp_path / f"{name}.npz"), tree)
        _assert_trees_close(load_npz(str(tmp_path / f"{name}.npz")), variables, 0.0, name)


def test_text_encoder_layer_fault_of_the_reference(monkeypatch):
    """JAX's cmlm_text TextEncoderLayer, as the package builds it, computes
    its attention projections in int8 W8A8 (its dtype lands in
    MultiheadAttention's `quant`, module docstring): its output equals the
    layer with quant=True given outright, bit for bit, and stands off the
    float layer's; the port's layer is the float one (within FWD_TOL of the
    layer with the dtype by keyword)."""
    from diffnorm_tpu_torch.models.cmlm_text import TextEncoderLayer

    x = np.random.default_rng(5).normal(size=(2, 7, 16)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.asarray([[7], [4]])
    jlayer = jcmlm_text.TextEncoderLayer(16, 32, 2, 0.0)
    variables = jax.jit(jlayer.init)(jax.random.PRNGKey(0), x, mask)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(6))

    def run(mha):
        monkeypatch.setattr(jcmlm_text, "MultiheadAttention", mha)
        return np.asarray(jax.jit(jlayer.apply)(variables, x, mask))

    as_built = run(JMultiheadAttention)
    int8 = run(lambda dim, heads, dropout, dtype, name: JMultiheadAttention(
        dim, heads, dropout=dropout, quant=True, dtype=dtype, name=name))
    float_ = run(_keyword_mha)
    np.testing.assert_array_equal(as_built, int8)
    assert np.abs(as_built - float_).max() > 1e-3
    layer = from_jax_variables(TextEncoderLayer(16, 32, 2), variables).eval()
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, float_, rtol=FWD_TOL, atol=FWD_TOL)
