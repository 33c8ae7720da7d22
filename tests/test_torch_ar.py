"""The AR S2UT model in the port against the JAX package on the CPU,
float32, at tiny widths (encoder and decoder 2 x 32, 2 heads, vocab 16 + 4):
the task's shift_right and prepared batches (stacked k = 2 included), the
teacher-forced logits of s2ut_conformer, s2ut_transformer, the stacked
decoder and the unshared output projection, each cached decode step against
JAX's decode_step and the port's own full forward, and both criterions with
the aux heads (label_smoothed_cross_entropy, speech_to_unit) with their
gradients against jax.grad. It mirrors tests/test_ar.py. Shared weights go
through `weights.from_jax_variables`; inputs come from numpy seeds."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.ce_loss import LabelSmoothedCrossEntropy as JLabelSmoothedCE
from diffnorm_tpu.criterions.ce_loss import SpeechToUnitLoss as JSpeechToUnitLoss
from diffnorm_tpu.models.ar_transformer import ARS2UTModule as JARS2UTModule
from diffnorm_tpu.models.ar_transformer import ARUnitDecoder as JARUnitDecoder
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.tasks.ar_s2ut_task import shift_right as jshift_right
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.models.ar_transformer import ARS2UTModule, ARUnitDecoder
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right
from diffnorm_tpu_torch.weights import from_jax_params, from_jax_variables, to_jax_variables
from tests.test_torch_multitask import _assert_batches_equal, _nested_torch
from tests.test_torch_nar_train import FWD_TOL, GRAD_TOL, _assert_trees_close, _perturb
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

PAD, EOS = 1, 2
CODES = 16
VOCAB = CODES + 4
WIDTHS = dict(encoder_layers=2, decoder_layers=2, encoder_embed_dim=32,
              encoder_ffn_embed_dim=64, encoder_attention_heads=2, decoder_attention_heads=2,
              decoder_embed_dim=32, decoder_ffn_embed_dim=64, conv_channels=32,
              depthwise_conv_kernel_size=5, target_code_size=CODES)
LETTERS = [chr(ord("a") + k) for k in range(6)]
# JAX's own bound for the cached decode against the full forward
# (tests/test_ar.py::test_kv_cache_matches_full_forward)
CACHE_RTOL, CACHE_ATOL = 2e-3, 2e-4
LOSS_RTOL = 1e-5


def flags(values):
    return [f"--{k.replace('_', '-')}={v}" for k, v in values.items()]


def write_ar_corpus(root, seed=0, n=4, multitask=True):
    """n .npy fbank sources of 36-56 frames with 4-14 units of 16 codes, and
    (multitask) three aux tasks on letter targets: a CTC head on the final
    encoder layer, a transformer head on encoder layer 1, a CTC head on
    decoder layer 2."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t = int(rng.integers(36, 57))
        np.save(root / f"utt{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
        units = rng.integers(0, CODES, size=int(rng.integers(4, 15)))
        rows.append({"id": f"utt{i}", "src_audio": f"utt{i}.npy", "src_n_frames": t,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
    write_translation_manifest(str(root / "train.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump({"input_feat_per_channel": 80}))
    if not multitask:
        return root
    (root / "dict.letters.txt").write_text("".join(f"{w} 1\n" for w in LETTERS))
    for task in ("source_unigram", "target_letter", "decoder_ctc"):
        (root / task).mkdir()
        lines = [f"utt{i}\t{' '.join(rng.choice(LETTERS, size=int(rng.integers(3, 7))))}"
                 for i in range(n)]
        (root / task / "train.tsv").write_text("id\ttgt_text\n" + "\n".join(lines) + "\n")
    (root / "multitask.yaml").write_text(yaml.safe_dump({
        "source_unigram": {"decoder_type": "ctc", "dict": "dict.letters.txt",
                           "data": "source_unigram", "loss_weight": 2.0},
        "target_letter": {"decoder_type": "transformer", "dict": "dict.letters.txt",
                          "data": "target_letter", "encoder_layer": 1, "label_smoothing": 0.1,
                          "decoder_args": {"decoder_layers": 1, "decoder_embed_dim": 16,
                                           "decoder_attention_heads": 2,
                                           "decoder_ffn_embed_dim": 32, "dropout": 0.0}},
        "decoder_ctc": {"decoder_type": "ctc", "dict": "dict.letters.txt",
                        "data": "decoder_ctc", "decoder_layer": 2, "loss_weight": 1.0}}))
    return root


def ar_tasks(root, arch="s2ut_conformer", criterion="speech_to_unit", multitask=True,
             **extra):
    """(the port's task, JAX's task) on one config."""
    mt = {"multitask_config_yaml": "multitask.yaml"} if multitask else {}
    args = train_cli.parse_args([str(root), "--task", "speech_to_speech_ar", "--arch", arch,
                                 "--criterion", criterion, "--max-update", "1",
                                 "--dropout", "0", *flags({**WIDTHS, **mt, **extra})])
    jtask = JTASKS.get("speech_to_speech_ar").setup_task(Config(
        arch=arch, criterion=criterion, data=str(root), dropout=0.0, label_smoothing=0.1,
        **{**WIDTHS, **mt, **extra}))
    return TASKS[args.task](args), jtask


def prepared(task, jtask, rows=(0, 1, 2, 3)):
    out = []
    for t in (task, jtask):
        ds = t.dataset("train")
        out.append(t.prepare_batch(ds.collater([ds[i] for i in rows]),
                                   np.random.default_rng(0)))
    return out


def jax_model(task, jtask, batch, seed=1):
    """(JAX module, perturbed variables, the port's model on them)."""
    jm = jtask.build_model()
    variables = jax.jit(lambda b: jtask.init_variables(jm, jax.random.PRNGKey(0), b))(batch)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(seed))
    return jm.module, variables, from_jax_variables(task.build_model(), variables)


@pytest.fixture(scope="module")
def ar(tmp_path_factory):
    """The s2ut_conformer model with the three aux heads: (task, JAX task,
    prepared batch, JAX module, variables, the port's model)."""
    root = write_ar_corpus(tmp_path_factory.mktemp("ar"))
    task, jtask = ar_tasks(root)
    batch, _ = prepared(task, jtask)
    jm, variables, model = jax_model(task, jtask, batch)
    return task, jtask, batch, jm, variables, model


def test_shift_right_equals_jax():
    target = np.asarray([[10, 11, EOS, PAD, PAD], [4, EOS, PAD, PAD, PAD],
                         [5, 6, 7, 8, EOS]], np.int32)
    np.testing.assert_array_equal(shift_right(target), jshift_right(target))
    np.testing.assert_array_equal(shift_right(target)[0], [EOS, 10, 11, PAD, PAD])


@pytest.mark.parametrize("k", [1, 2])
def test_prepare_batch_equals_jax(tmp_path, k):
    """The prepared batch bit for bit: prev_output_tokens (of the packed ids
    when stacked), the sub-frame targets and target_packed, the aux tasks'
    entries and loss weights."""
    write_ar_corpus(tmp_path)
    got, want = prepared(*ar_tasks(tmp_path, n_frames_per_step=k))
    _assert_batches_equal(got, want)
    assert got["prev_output_tokens"].shape[:2] == got["target"].shape[:2]
    assert ("target_packed" in got) == (k > 1)


def _forward_inputs(batch):
    t = _nested_torch({key: batch[key] for key in ("src_tokens", "src_lengths",
                                                   "prev_output_tokens")})
    return t["src_tokens"], t["src_lengths"], t["prev_output_tokens"].long()


@pytest.mark.parametrize("case", ["s2ut_conformer", "s2ut_transformer", "stacked"])
def test_teacher_forced_logits_match_jax(ar, tmp_path, case):
    """An eval forward's logits within 1e-5 of JAX's: the conformer model
    (aux heads off without targets), the S2T transformer encoder's, and the
    stacked decoder's [B, T, 2, V] (one layer each)."""
    if case == "s2ut_conformer":
        _, _, batch, jm, variables, model = ar
    else:
        write_ar_corpus(tmp_path, multitask=False)
        extra = dict(encoder_layers=1, decoder_layers=1)
        if case == "stacked":
            extra["n_frames_per_step"] = 2
        task, jtask = ar_tasks(tmp_path, arch="s2ut_conformer" if case == "stacked" else case,
                               criterion="label_smoothed_cross_entropy", multitask=False,
                               **extra)
        batch, _ = prepared(task, jtask)
        jm, variables, model = jax_model(task, jtask, batch)
    want = np.asarray(jax.jit(jm.apply)(variables, batch["src_tokens"], batch["src_lengths"],
                                        batch["prev_output_tokens"])["logits"])
    with torch.no_grad():
        got = model.eval()(*_forward_inputs(batch))["logits"].numpy()
    assert got.shape == want.shape == batch["target"].shape + (VOCAB,)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_unshared_output_projection_and_features_match_jax():
    """ARUnitDecoder(share_input_output_embed=False): the `output_proj`
    logits and the post-norm features (return_features) within 1e-5."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(4, VOCAB, size=(2, 7)).astype(np.int32)
    tokens[1, 5:] = PAD
    enc = rng.normal(size=(2, 9, 32)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.asarray([9, 6])[:, None]
    jd = JARUnitDecoder(vocab_size=VOCAB, dim=32, ffn_dim=64, layers=2, heads=2, dropout=0.0,
                        share_input_output_embed=False)
    params = jax.jit(jd.init)(jax.random.PRNGKey(0), tokens, enc, mask)["params"]
    params = _perturb({"params": jax.device_get(params)}, np.random.default_rng(4))["params"]
    want_logits, want_feat = jax.jit(lambda p: jd.apply(p, tokens, enc, mask,
                                                        return_features=True))({"params": params})
    dec = from_jax_params(ARUnitDecoder(VOCAB, 32, 64, 2, 2, dropout=0.0,
                                        share_input_output_embed=False), params).eval()
    assert "output_proj" in params
    with torch.no_grad():
        logits, feat = dec(torch.from_numpy(tokens).long(), torch.from_numpy(enc),
                           torch.from_numpy(mask), return_features=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_cached_decode_steps_match_jax_and_the_full_forward(ar, tmp_path, k):
    """Six cached decode steps on the teacher-forced inputs: each step's
    logits within 1e-5 of JAX's decode_step (its cache collection threaded
    through), and the steps together within JAX's tolerance of the port's
    own full forward (tests/test_ar.py::test_kv_cache_matches_full_forward);
    the cache holds the model's dtype and its written length."""
    if k == 1:
        _, _, batch, jm, variables, model = ar
    else:
        write_ar_corpus(tmp_path, multitask=False)
        task, jtask = ar_tasks(tmp_path, criterion="label_smoothed_cross_entropy",
                               multitask=False, n_frames_per_step=2, encoder_layers=1)
        batch, _ = prepared(task, jtask)
        jm, variables, model = jax_model(task, jtask, batch)
    model = model.eval()
    src, lengths, prev = _forward_inputs(batch)
    steps = min(6, prev.shape[1])
    jenc, jmask = jax.jit(lambda v: jm.apply(v, batch["src_tokens"], batch["src_lengths"],
                                             method=JARS2UTModule.encode))(variables)
    step = jax.jit(lambda v, tok, pos: jm.apply(v, tok, jenc, jmask, pos, 16,
                                                method=JARS2UTModule.decode_step,
                                                mutable=["cache"]))
    jax_vars, want = dict(variables), []
    for t in range(steps):
        logits, mutated = step(jax_vars, jnp.asarray(batch["prev_output_tokens"][:, t:t + 1]),
                               jnp.full((prev.shape[0],), t))
        jax_vars["cache"] = mutated["cache"]
        want.append(np.asarray(logits))
    with torch.no_grad():
        full = model(src, lengths, prev[:, :steps])["logits"].numpy()
        enc, mask = model.encode(src, lengths)
        cache = model.init_cache(enc, mask, 16)
        got = []
        for t in range(steps):
            logits, cache = model.decode_step(prev[:, t:t + 1], cache,
                                              torch.full((prev.shape[0],), t))
            got.append(logits.numpy())
    assert cache.length == steps and cache.keys[0].dtype == torch.float32
    assert cache.keys[0].shape == (prev.shape[0], 2, 16, 16)
    for t in range(steps):
        np.testing.assert_allclose(got[t], want[t], rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=f"step {t}")
    # the full forward reads a PAD as padding, a decode step as a token: the
    # positions before a row's first PAD
    real = np.cumprod(prev[:, :steps].numpy() != PAD, axis=1).astype(bool)
    assert real.sum() >= prev.shape[0] * 3
    np.testing.assert_allclose(np.stack(got, axis=1)[real], full[real], rtol=CACHE_RTOL,
                               atol=CACHE_ATOL)


def test_cache_reorder_follows_the_beams(ar):
    """reorder(index) gives row i the written keys and values of row
    index[i]: decoding on after it equals decoding the permuted rows."""
    _, _, batch, _, _, model = ar
    model = model.eval()
    src, lengths, prev = _forward_inputs(batch)
    with torch.no_grad():
        enc, mask = model.encode(src, lengths)
        enc, mask = enc[[0, 0, 2, 2]], mask[[0, 0, 2, 2]]  # two sentences, two beams each
        index = torch.tensor([1, 0, 3, 3])
        caches = [model.init_cache(enc, mask, 8) for _ in range(2)]
        toks = prev[[0, 1, 2, 3], :3]
        for t in range(2):
            model.decode_step(toks[:, t:t + 1], caches[0], torch.full((4,), t))
            model.decode_step(toks[index, t:t + 1], caches[1], torch.full((4,), t))
        caches[0].reorder(index)
        a, _ = model.decode_step(toks[index, 2:3], caches[0], torch.full((4,), 2))
        b, _ = model.decode_step(toks[index, 2:3], caches[1], torch.full((4,), 2))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("criterion", ["label_smoothed_cross_entropy", "speech_to_unit"])
def test_criterions_and_gradients_match_jax(ar, criterion):
    """A training forward at dropout 0 (batch statistics): the loss and
    metrics within 1e-5 relative of JAX's criterion (speech_to_unit with
    the three aux terms, a CTC row that cannot align among them), and
    d loss / d params within 1e-4 of each leaf's scale against jax.grad
    (label_smoothed_cross_entropy: the aux heads take no gradient, zero in
    JAX; speech_to_unit: on CTC rows that align, see below)."""
    task, jtask, batch, jm, variables, model = ar
    jcrit = {"label_smoothed_cross_entropy": JLabelSmoothedCE,
             "speech_to_unit": JSpeechToUnitLoss}[criterion](Config(label_smoothing=0.1), jtask)
    holder = jtask.build_model()

    @jax.jit
    @functools.partial(jax.value_and_grad, has_aux=True)
    def loss_fn(params, b):
        loss, mets, _ = jcrit(holder, {**variables, "params": params}, b,
                              jax.random.PRNGKey(0), train=True)
        return loss, mets

    task.args.criterion = criterion
    crit = task.build_criterion()
    (want_loss, want), ref = loss_fn(variables["params"], batch)
    with torch.no_grad():
        loss, got = crit(copy.deepcopy(model).train(), _nested_torch(batch))
    assert sorted(got) == sorted(want)
    if criterion == "speech_to_unit":
        assert {f"multitask_{n}_loss" for n in task.multitask_tasks} <= set(got)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=key)
    if criterion == "speech_to_unit":
        # a CTC row that cannot align (here decoder_ctc's second, 6 letters
        # with a triple on a canvas of 6) scores ~1e5 by optax's
        # log-epsilon, whose float32 gradient both packages sum to ~1e-2
        # (test_torch_multitask.py::test_ctc_loss_matches_optax_past_the_
        # feasibility_boundary): the gradients are held on rows that align
        batch = copy.deepcopy(batch)
        dec = batch["multitask"]["decoder_ctc"]["target"]
        canvas = (batch["prev_output_tokens"] != PAD).sum(1)
        for row, n in enumerate(np.minimum((dec != PAD).sum(1), canvas)):
            dec[row] = PAD
            dec[row, :n] = 4 + np.arange(n) % 2
        (want_loss, _), ref = loss_fn(variables["params"], batch)
    model = copy.deepcopy(model).train()
    loss, _ = crit(model, _nested_torch(batch))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.copy_(torch.zeros_like(p) if g is None else g)
    _assert_trees_close(to_jax_variables(model)["params"], jax.device_get(ref), GRAD_TOL, "grad")
