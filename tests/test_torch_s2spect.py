"""The spectrogram decoders in the port against the JAX package on the CPU,
float32, at tiny widths (tests/test_s2spect.py's and test_s2spect2.py's:
encoder and decoder 2 x 16, prenet 8, postnet 2 x 8, 6 mel bins): the
dataset's collated batches, `decode_full` of s2spect_transformer and
s2spect_conformer (decoder 24 wide over a 16-wide encoder), `ar_rollout` for n_frames_per_step 1 and 2 (every one of
the max_iter frames, the lengths, the EOS probabilities) and its cached
steps against `decode_full`, the Tacotron2 criterion with its BatchNorm
statistics, Translatotron2's forward with an encoder- and a decoder-tapped
CTC head, `translatotron2_generate`, the speech_to_spectrogram_2pass
criterion with one update's gradients against jax.grad, and the weights'
round trip.

JAX draws the Tacotron prenet's inference dropout from fold_in(rng, 2 +
step), a stream torch cannot reproduce, so every comparison with JAX runs
both packages at prenet_dropout 0; that is the parity setting, not a
tolerance widened to hide a defect. The draw itself is held on its own
(`test_prenet_dropout_draws_from_its_generator`): the share kept, the
scale, that it draws in eval mode too, and that a generator's seed
reproduces it."""

import copy
import functools

import jax
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.tts_loss import SpeechToSpectrogram2PassLoss as JTwoPassLoss
from diffnorm_tpu.criterions.tts_loss import Tacotron2Loss as JTacotron2Loss
from diffnorm_tpu.generate.speech_ar import ar_speech_generate as jar_speech_generate
from diffnorm_tpu.generate.translatotron2 import translatotron2_generate as jt2_generate
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.generate.speech_ar import ar_speech_generate
from diffnorm_tpu_torch.generate.translatotron2 import translatotron2_generate
from diffnorm_tpu_torch.models.tts_transformer import TacotronPrenet
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.weights import (
    flatten_tree,
    from_jax_variables,
    load_npz,
    save_npz,
    to_jax_variables,
)
from tests.test_torch_multitask import _assert_batches_equal, _nested_torch
from tests.test_torch_nar_train import (
    FWD_TOL,
    GRAD_TOL,
    KEY_BIASES,
    STATS_TOL,
    _assert_trees_close,
    _flat,
    _perturb,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

PAD, EOS = 1, 2
MEL = 6
LETTERS = [chr(ord("a") + k) for k in range(6)]
TINY = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=2,
            encoder_attention_heads=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32,
            decoder_transformer_layers=2, decoder_attention_heads=2, conv_channels=16,
            depthwise_conv_kernel_size=7, prenet_dim=8, postnet_conv_dim=8, postnet_layers=2,
            output_frame_dim=MEL, prenet_dropout=0.0, postnet_dropout=0.0)
TWO_PASS = dict(multitask_config_yaml="multitask.yaml", translation_decoder_layers=2,
                synthesizer_encoder_layers=1)
CACHE_RTOL, CACHE_ATOL = 2e-3, 2e-4
LOSS_RTOL = 1e-5
MAX_ITER = 12


def flags(values):
    return [f"--{k.replace('_', '-')}={v}" for k, v in values.items()]


def write_spect_corpus(root, seed=0, splits=(("train", 4), ("test", 2))):
    """.npy sources of 36-56 frames, 6-bin mel targets of t // 2 + 4 frames,
    letter targets for the first pass (target_letter) and two CTC heads, on
    encoder (source_unigram) and decoder (decoder_ctc, layer 2) taps."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        rows = []
        for i in range(n):
            uid, t = f"{split}{i}", int(rng.integers(36, 56))
            np.save(root / f"{uid}_s.npy", rng.normal(size=(t, 80)).astype(np.float32))
            mel = rng.normal(size=(t // 2 + 4, MEL)).astype(np.float32)
            np.save(root / f"{uid}_t.npy", mel)
            rows.append({"id": uid, "src_audio": f"{uid}_s.npy", "src_n_frames": t,
                         "tgt_audio": f"{uid}_t.npy", "tgt_n_frames": mel.shape[0]})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump({"input_feat_per_channel": 80}))
    (root / "dict.letters.txt").write_text("".join(f"{w} 1\n" for w in LETTERS))
    for task in ("source_unigram", "target_letter", "decoder_ctc"):
        (root / task).mkdir(exist_ok=True)
        for split, n in splits:
            lines = [f"{split}{i}\t{' '.join(rng.choice(LETTERS, size=int(rng.integers(3, 7))))}"
                     for i in range(n)]
            (root / task / f"{split}.tsv").write_text("id\ttgt_text\n" + "\n".join(lines) + "\n")
    (root / "multitask.yaml").write_text(yaml.safe_dump({
        "target_letter": {"decoder_type": "transformer", "dict": "dict.letters.txt",
                          "data": "target_letter", "is_first_pass_decoder": True,
                          "loss_weight": 1.0, "decoder_args": {"dropout": 0.0}},
        "source_unigram": {"decoder_type": "ctc", "dict": "dict.letters.txt",
                           "data": "source_unigram", "loss_weight": 8.0},
        "decoder_ctc": {"decoder_type": "ctc", "dict": "dict.letters.txt",
                        "data": "decoder_ctc", "decoder_layer": 2, "loss_weight": 1.0}}))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_spect_corpus(tmp_path_factory.mktemp("spect"))


def spect_tasks(root, arch, criterion=None, **extra):
    """(the port's task, JAX's task) through --task speech_to_speech without
    --target-is-code."""
    values = {**TINY, **extra}
    crit = criterion or ("speech_to_spectrogram_2pass" if arch.startswith("s2spect2")
                         else "speech_to_spectrogram")
    args = train_cli.parse_args([str(root), "--task", "speech_to_speech", "--arch", arch,
                                 "--criterion", crit, "--max-update", "1", "--dropout", "0",
                                 *flags(values)])
    jtask = JTASKS.get("speech_to_speech").setup_task(Config(
        arch=arch, criterion=crit, data=str(root), dropout=0.0, **values))
    return TASKS[args.task](args), jtask


def prepared(task, jtask, rows=(0, 1, 2, 3)):
    out = []
    for t in (task, jtask):
        ds = t.dataset("train")
        out.append(t.prepare_batch(ds.collater([ds[i] for i in rows]),
                                   np.random.default_rng(0)))
    return out


def stacked(batch, k):
    """The batch with k frames a step ([B, ceil(T / k), k D]), the targets
    a decoder of n_frames_per_step k reads (JAX's dataset does not stack:
    this shapes its init)."""
    b, t, d = batch["feat_tgt"].shape
    n = -(-t // k)
    feat = np.zeros((b, n * k, d), np.float32)
    feat[:, :t] = batch["feat_tgt"]
    feat = feat.reshape(b, n, k * d)
    prev = np.zeros_like(feat)
    prev[:, 1:] = feat[:, :-1]
    lens = -(-batch["tgt_lengths"] // k)
    return {**batch, "feat_tgt": feat, "prev_feats": prev, "tgt_lengths": lens,
            "tgt_mask": np.arange(n)[None, :] < lens[:, None]}


def build(root, arch, **extra):
    """(port task, JAX task, batch, JAX module, perturbed variables, the
    port's model on them, in eval mode)."""
    task, jtask = spect_tasks(root, arch, **extra)
    batch, jbatch = prepared(task, jtask)
    _assert_batches_equal(batch, jbatch)
    jm = jtask.build_model()
    init_batch = stacked(batch, extra.get("n_frames_per_step", 1))
    variables = jax.jit(lambda b: jtask.init_variables(jm, jax.random.PRNGKey(0), b))(
        init_batch)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    variables["params"]["dec_pos_alpha"] = np.asarray([0.7], np.float32)
    model = from_jax_variables(task.build_model(), variables).eval()
    return task, jtask, batch, jm.module, variables, model


@pytest.fixture(scope="module")
def t2(corpus):
    """Translatotron2 with a synthesizer layer and the two CTC aux heads."""
    return build(corpus, "s2spect2_conformer", **TWO_PASS)


def _decoder_inputs(batch):
    t = _nested_torch({k: batch[k] for k in ("src_tokens", "src_lengths", "prev_feats",
                                             "tgt_mask")})
    return t["src_tokens"], t["src_lengths"], t["prev_feats"], t["tgt_mask"]


def test_dataset_collates_as_jax(corpus):
    """The spectrogram dataset's order and collated, prepared batch (the
    aux tasks' entries and loss weights among them) equal to JAX's."""
    task, jtask = spect_tasks(corpus, "s2spect2_conformer", **TWO_PASS)
    got, want = prepared(task, jtask, rows=(3, 0, 2, 1))
    _assert_batches_equal(got, want)
    np.testing.assert_array_equal(task.dataset("train").ordered_indices(),
                                  jtask.dataset("train").ordered_indices())
    np.testing.assert_array_equal(got["prev_feats"][:, 1:], got["feat_tgt"][:, :-1])
    assert (got["prev_feats"][:, 0] == 0).all()
    assert task.mt_task_name == jtask.mt_task_name == "target_letter"


def test_dummy_task_batches_match_jax(corpus):
    """dummy_s2spect: dummy_batch equal to JAX's, the dataset
    `dataset_size` copies of it."""
    from diffnorm_tpu.tasks.s2spect_task import DummyS2SpectTask as JDummy

    args = train_cli.parse_args([str(corpus), "--task", "speech_to_speech_spect", "--arch",
                                 "s2spect_transformer", "--max-update", "1",
                                 "--output-frame-dim", str(MEL), "--batch-size", "3"])
    jtask = JDummy(Config(arch="s2spect_transformer", data=str(corpus), output_frame_dim=MEL,
                          batch_size=3))
    task = TASKS["dummy_s2spect"](args)
    _assert_batches_equal(task.dummy_batch(3, 40), jtask.dummy_batch(3, 40))
    ds = task.dataset("train")
    assert len(ds) == 4
    _assert_batches_equal(ds[3], next(iter(jtask.dataset("train"))))


@pytest.fixture(scope="module")
def conformer(corpus):
    """s2spect_conformer with the decoder at 24, the encoder at 16 (the
    cross-attention projects from the encoder's width)."""
    return build(corpus, "s2spect_conformer", decoder_embed_dim=24, decoder_ffn_embed_dim=48)


def assert_forward_matches_jax(jm, variables, batch, model):
    """The eval forward's post_feat, feat and eos_logits within 1e-5 of
    JAX's."""
    want = jax.jit(lambda v, b: jm.apply(v, b["src_tokens"], b["src_lengths"], b["prev_feats"],
                                         b["tgt_mask"], deterministic=True))(variables, batch)
    with torch.no_grad():
        got = model(*_decoder_inputs(batch))
    for key in ("post_feat", "feat", "eos_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)
    assert got["post_feat"].shape == batch["feat_tgt"].shape


def test_decode_full_matches_jax(conformer):
    """s2spect_conformer's eval forward against JAX's (s2spect_transformer's
    is held in test_ar_rollout_matches_jax[1])."""
    _, _, batch, jm, variables, model = conformer
    assert_forward_matches_jax(jm, variables, batch, model)


@pytest.mark.parametrize("k", [1, 2])
def test_ar_rollout_matches_jax(corpus, k):
    """ar_speech_generate over all MAX_ITER steps: every frame within 1e-5
    of JAX's, the EOS probabilities too, and the lengths equal, at a
    threshold the rows cross at different steps; the cached steps against
    decode_full on the rollout's own frames within JAX's cache tolerance."""
    task, jtask, batch, jm, variables, model = build(
        corpus, "s2spect_transformer", n_frames_per_step=k, decoder_embed_dim=24,
        decoder_ffn_embed_dim=48)
    if k == 1:  # s2spect_transformer's teacher-forced forward
        assert_forward_matches_jax(jm, variables, batch, model)
    src, lengths, _, _ = _decoder_inputs(batch)
    _, _, probe = ar_speech_generate(model, src, lengths, max_iter=MAX_ITER)
    threshold = float(np.median(probe[:, ::k].numpy()))
    feat, out_lens, eos_prob = ar_speech_generate(model, src, lengths, max_iter=MAX_ITER,
                                                  eos_prob_threshold=threshold)
    holder = jtask.build_model()
    want = jax.jit(lambda v, s, n: jar_speech_generate(
        holder, v, s, max_iter=MAX_ITER, eos_prob_threshold=threshold, src_lengths=n))(
        variables, batch["src_tokens"], batch["src_lengths"])
    assert feat.shape == (4, MAX_ITER * k, MEL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want[0]), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(eos_prob.numpy(), np.asarray(want[2]), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert len(set(out_lens.tolist())) > 1 and (out_lens % k == 0).all()
    # the cached steps on the rollout's own frames against decode_full
    with torch.no_grad():
        enc, mask = model.encode(src, lengths)
        cache, steps = model.init_cache(enc, mask, MAX_ITER), []
        prev = torch.zeros(4, 1, MEL * k)
        for i in range(MAX_ITER):
            frame, _, cache = model.decode_step(prev, cache, i)
            steps.append(frame)
            prev = frame[:, None]
        steps = torch.stack(steps, dim=1)
        teacher = torch.cat([torch.zeros(4, 1, MEL * k), steps[:, :-1]], dim=1)
        _, full, _ = model.decode_full(teacher, torch.ones(4, MAX_ITER, dtype=torch.bool),
                                       enc, mask)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), rtol=CACHE_RTOL, atol=CACHE_ATOL)


def test_tacotron2_loss_matches_jax(conformer):
    """speech_to_spectrogram in a training forward (dropout 0, batch
    statistics): the loss and its terms within 1e-5 relative of JAX's
    Tacotron2Loss, the counts equal, and the BatchNorm statistics (the
    conformer's and the postnet's, momentum 0.9 and 0.99) within 1e-6."""
    task, jtask, batch, jm, variables, model = conformer
    jcrit = JTacotron2Loss(Config(bce_pos_weight=5.0), jtask)
    holder = jtask.build_model()
    want_loss, want, mutated = jax.jit(lambda v, b: jcrit(holder, v, b, jax.random.PRNGKey(0),
                                                          train=True))(variables, batch)
    model = copy.deepcopy(model).train()
    with torch.no_grad():
        loss, got = task.build_criterion()(model, _nested_torch(batch),
                                           generator=torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=LOSS_RTOL, err_msg=key)
    stats = to_jax_variables(model)["batch_stats"]
    assert "postnet" in stats and "encoder" in stats
    _assert_trees_close(stats, jax.device_get(mutated["batch_stats"]), STATS_TOL, "stats")


def test_translatotron2_forward_matches_jax(t2):
    """The teacher-forced two-pass forward with the aux heads on: the mel
    outputs, the first pass's logits and both CTC heads' logits and masks
    (the decoder-tapped one's from tgt_mask) within 1e-5 of JAX's."""
    task, jtask, batch, jm, variables, model = t2
    mt = {name: e["prev_output_tokens"] for name, e in batch["multitask"].items()
          if "prev_output_tokens" in e}
    kw = dict(prev_tokens_mt=mt["target_letter"], tgt_tokens=batch["feat_tgt"],
              multitask_prev=mt)
    want = jax.jit(lambda v, b: jm.apply(v, b["src_tokens"], b["src_lengths"], b["prev_feats"],
                                         b["tgt_mask"], deterministic=True, **kw))(variables, batch)
    with torch.no_grad():
        got = model(*_decoder_inputs(batch), **_nested_torch(kw))
    for key in ("post_feat", "feat", "eos_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)
    assert sorted(got["multitask"]) == sorted(want["multitask"]) == sorted(task.multitask_tasks)
    for name, head in want["multitask"].items():
        for key, value in head.items():
            np.testing.assert_allclose(got["multitask"][name][key].float().numpy(),
                                       np.asarray(value, np.float32), rtol=FWD_TOL,
                                       atol=FWD_TOL, err_msg=f"{name}/{key}")


def test_translatotron2_generate_matches_jax(t2):
    """The first-pass beam (beam 3, ngram blocking 2), the handoff and the
    mel rollout: mt_best equal to JAX's, every frame and EOS probability
    within 1e-5, the lengths equal."""
    task, jtask, batch, jm, variables, model = t2
    kw = dict(beam_size_mt=3, max_len_mt=8, max_iter=MAX_ITER, no_repeat_ngram=2,
              len_penalty_mt=0.9)
    src, lengths, _, _ = _decoder_inputs(batch)
    _, _, probe, _ = translatotron2_generate(model, src, lengths, **kw)
    threshold = float(np.median(probe.numpy()))
    feat, out_lens, eos_prob, mt_best = translatotron2_generate(
        model, src, lengths, eos_prob_threshold=threshold, **kw)
    holder = jtask.build_model()
    want = jax.jit(lambda v, s, n: jt2_generate(holder, v, s, n, eos_prob_threshold=threshold,
                                                **kw))(variables, batch["src_tokens"],
                                                       batch["src_lengths"])
    np.testing.assert_array_equal(mt_best.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(feat.numpy(), np.asarray(want[0]), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(eos_prob.numpy(), np.asarray(want[2]), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert len(set(out_lens.tolist())) > 1 and (mt_best[:, 0] != EOS).any()


def test_2pass_spectrogram_criterion_and_gradients_match_jax(t2):
    """speech_to_spectrogram_2pass in a training forward (dropout 0): the loss
    (the mean mel loss plus every task's weighted sum, denominator 1) and
    each metric within 1e-5 relative of JAX's, and d loss / d params within
    1e-4 of each leaf's scale against jax.grad, on CTC rows that can align
    (tests/test_torch_ar.py says why)."""
    task, jtask, batch, jm, variables, model = t2
    batch = copy.deepcopy(batch)
    dec = batch["multitask"]["decoder_ctc"]["target"]
    canvas = batch["tgt_lengths"]
    for row, n in enumerate(np.minimum((dec != PAD).sum(1), canvas)):
        dec[row] = PAD
        dec[row, :n] = 4 + np.arange(n) % 2
    jcrit = JTwoPassLoss(Config(bce_pos_weight=5.0), jtask)
    holder = jtask.build_model()

    @jax.jit
    @functools.partial(jax.value_and_grad, has_aux=True)
    def loss_fn(params, b):
        loss, mets, _ = jcrit(holder, {**variables, "params": params}, b,
                              jax.random.PRNGKey(0), train=True)
        return loss, mets

    (want_loss, want), ref = loss_fn(variables["params"], batch)
    model = copy.deepcopy(model).train()
    loss, got = task.build_criterion()(model, _nested_torch(batch),
                                       generator=torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    assert {f"multitask_{n}_loss" for n in task.multitask_tasks} <= set(got)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=key)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.copy_(torch.zeros_like(p) if g is None else g)
    got_grads, want_grads = to_jax_variables(model)["params"], jax.device_get(ref)
    # zero in exact arithmetic, float32 rounding noise in both packages: a
    # key projection's bias (the softmax cancels q . b; tests/
    # test_torch_nar_train.py KEY_BIASES) and the bias of a postnet conv
    # (the training BatchNorm after it subtracts it with the batch mean);
    # they are pinned small instead
    cancelled = KEY_BIASES + tuple(f"postnet/conv_{i}/bias" for i in range(2))
    _assert_trees_close(got_grads, want_grads, GRAD_TOL, "grad", skip=cancelled)
    for tree in (got_grads, want_grads):
        noise = [np.abs(v).max() for k, v in _flat(tree).items() if k.endswith(cancelled)]
        assert len(noise) >= 4 and max(noise) < 1e-5


def test_prenet_dropout_draws_from_its_generator():
    """The prenet keeps each unit with 1 - p and scales the kept ones by
    1 / (1 - p), in eval mode as in training; the same seed reproduces the
    draw, another seed does not; p = 0 draws nothing."""
    torch.manual_seed(0)
    prenet = TacotronPrenet(6, n_layers=1, n_units=4000, dropout=0.5).eval()
    with torch.no_grad():
        prenet.fc_0.weight.fill_(0.0)
        prenet.fc_0.bias.fill_(1.0)
    x = torch.zeros(3, 6)
    with torch.no_grad():
        a = prenet(x, torch.Generator().manual_seed(5))
        b = prenet(x, torch.Generator().manual_seed(5))
        c = prenet(x, torch.Generator().manual_seed(6))
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert abs((a > 0).float().mean().item() - 0.5) < 0.02
    assert torch.equal(a, b) and not torch.equal(a, c)
    prenet.p = 0.0
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    with torch.no_grad():
        assert torch.equal(prenet(x, g), torch.ones(3, 4000))
    assert torch.equal(g.get_state(), state)


def test_weights_round_trip(t2, tmp_path):
    """Translatotron2's tree (the mt_<task>_decoder scope, the synthesizer,
    the aux heads, the conformer's and the postnet's batch_stats): the
    port's to_jax_variables equals JAX's tree it was loaded from, and a
    save_npz / load_npz round trip into a fresh model gives the same
    state."""
    task, _, _, _, variables, model = t2
    tree = to_jax_variables(model)
    flat, ref = flatten_tree(tree), flatten_tree(variables)
    assert sorted(flat) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(flat[key], np.asarray(value), err_msg="/".join(key))
    assert ("params", "mt_target_letter_decoder", "embed_tokens", "embedding") in flat
    assert ("batch_stats", "postnet", "bn_1", "var") in flat
    save_npz(str(tmp_path / "t2.npz"), tree)
    fresh = from_jax_variables(task.build_model(), load_npz(str(tmp_path / "t2.npz")))
    for (name, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), name
