"""--multitask-config-yaml, --multitask-ctc-vocab and the text side of
cli.generate in the port against the JAX package on the CPU, float32, at
tiny widths (encoder 2 x 32, decoder 2 layers, vocab 10 + 4; aux
transformer head 1 x 16): the task config and its loss-weight schedules,
the text targets' collation and dataset join, the aux heads' logits, every
criterion term (CTC rows past and at the feasibility boundary included),
3 Trainer updates, and the tokenizers / post_process. It mirrors
tests/test_multitask.py. Shared weights go through
`weights.from_jax_variables`; inputs come from numpy seeds."""

import copy

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from diffnorm_tpu.config import Config, make_trainer_config
from diffnorm_tpu.criterions.nar_loss import NARSpeechToUnitLoss as JNARLoss
from diffnorm_tpu.data import encoders as jencoders
from diffnorm_tpu.data import multitask as jmultitask
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.parallel.mesh import make_mesh, replicate
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.train.trainer import Trainer as JTrainer
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss, ctc_loss
from diffnorm_tpu_torch.data import encoders, multitask
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.train.trainer import Trainer
from diffnorm_tpu_torch.weights import from_jax_variables, to_jax_variables
from tests.test_torch_nar_train import (
    FWD_TOL,
    KEY_BIASES,
    PARAM_TOL,
    TRAJ_RTOL,
    _assert_trees_close,
    _perturb,
    _torch,
    _trainer_cfg,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

PAD, EOS = 1, 2
CODES = 10
WIDTHS = dict(encoder_layers=2, decoder_layers=2, encoder_embed_dim=32,
              encoder_ffn_embed_dim=64, encoder_attention_heads=2, decoder_attention_heads=2,
              decoder_embed_dim=32, decoder_ffn_embed_dim=64, conv_channels=32,
              depthwise_conv_kernel_size=7, target_code_size=CODES)
PORT_FLAGS = [f"--{k.replace('_', '-')}={v}" for k, v in WIDTHS.items()]
LETTERS = [chr(ord("a") + k) for k in range(6)]


# ---- config, schedules, collation ----

@pytest.mark.parametrize("config", [
    {"loss_weight": 8.0},
    {"loss_weight_max": 1.0, "loss_weight_decay_steps": 100, "loss_weight_min": 0.1},
    {"loss_weight_max": 2.0, "loss_weight_decay_steps": 7}])
def test_loss_weight_schedules_match_jax(config):
    """Fixed and linearly decaying weights (data_cfg.py:339-355, the floor
    defaulting to 1e-4) over 0..200 updates, and the schedule's name."""
    ours, theirs = multitask.SingleTaskConfig("t", config), jmultitask.SingleTaskConfig("t", config)
    assert ours.loss_weight_schedule == theirs.loss_weight_schedule
    for n in range(0, 201, 3):
        assert ours.get_loss_weight(n) == theirs.get_loss_weight(n)
    assert ours.get_loss_weight(10_000) == pytest.approx(config.get(
        "loss_weight", config.get("loss_weight_min", 1e-4)))


@pytest.mark.parametrize("config", [{}, {"encoder_layer": 0}, {"encoder_layer": 2},
                                    {"decoder_layer": 3}, {"decoder_layer": 1}])
def test_input_layer_indexing_matches_jax(config):
    """encoder_layer / decoder_layer k is 1-based (k - 1 the Python index);
    absent or 0 taps the final encoder layer (-1)."""
    ours, theirs = multitask.SingleTaskConfig("t", config), jmultitask.SingleTaskConfig("t", config)
    assert (ours.input_from, ours.input_layer) == (theirs.input_from, theirs.input_layer)


def test_first_pass_decoder_selection_matches_jax(tmp_path):
    y = tmp_path / "mt.yaml"
    y.write_text(yaml.safe_dump({"source_ctc": {"decoder_type": "ctc"},
                                 "target_letter": {"decoder_type": "transformer"},
                                 "target_ctc": {"decoder_type": "ctc"}}))
    # the last 'target*' task with a transformer decoder (the YAML's keys sorted)
    assert multitask.MultitaskConfig(str(y)).first_pass_decoder_task_index == \
        jmultitask.MultitaskConfig(str(y)).first_pass_decoder_task_index == 2


@pytest.mark.parametrize("with_prev, pad_to", [(True, None), (False, None), (True, 16)])
def test_collate_text_targets_matches_jax(with_prev, pad_to):
    """Padding and move-eos-to-beginning prev_output_tokens, an empty
    target among them."""
    rng = np.random.default_rng(3)
    targets = [np.append(rng.integers(4, 10, size=n), EOS).astype(np.int32) for n in (3, 0, 6)]
    targets.append(np.zeros((0,), np.int32))
    got = multitask.collate_text_targets(targets, with_prev=with_prev, pad_to=pad_to)
    want = jmultitask.collate_text_targets(targets, with_prev=with_prev, pad_to=pad_to)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("tq, tk", [(5, 5), (3, 7), (6, 9)])
def test_causal_masked_attention_matches_jax(tq, tk):
    """masked_attention(causal=True), the aux heads' self-attention: query i
    sees keys j <= i + tk - tq (JAX's tril(k=tk-tq)), with a key-padding
    mask; float32 within 1e-6, bf16 inputs within one bf16 ulp of scale.
    On the CPU, as on the card, no causal call takes the kernel."""
    from diffnorm_tpu.ops.attention import masked_attention as jax_attention
    from diffnorm_tpu_torch.ops.attention import masked_attention

    rng = np.random.default_rng(tq + tk)
    q, k, v = (rng.normal(size=(2, 3, t, 8)).astype(np.float32) for t in (tq, tk, tk))
    mask = np.arange(tk)[None, :] < np.asarray([tk, tk - 2])[:, None]
    want = np.asarray(jax_attention(q, k, v, mask=mask, causal=True))
    got = masked_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    plain = masked_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    assert not torch.allclose(plain[:, :, 0], got[:, :, 0])  # the mask bites
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want_bf16 = np.asarray(jax_attention(*(jax.numpy.asarray(x.float().numpy(),
                                                              jax.numpy.bfloat16)
                                           for x in (qb, kb, vb)), mask=mask, causal=True),
                           np.float32)
    got_bf16 = masked_attention(qb, kb, vb, torch.from_numpy(mask), causal=True).float()
    assert np.abs(got_bf16.numpy() - want_bf16).max() <= 2 ** -8 * np.abs(want_bf16).max()


# ---- the dataset, the model's heads, the criterion ----

@pytest.fixture(scope="module")
def mt_data(tmp_path_factory):
    """4 utterances (.npy fbank, unit targets), a letter dictionary and three
    aux tasks: a CTC head on the final encoder layer, a transformer head on
    encoder layer 1 with a decaying weight, a CTC head on decoder layer 2."""
    root = tmp_path_factory.mktemp("mt")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        t = int(rng.integers(36, 56))
        np.save(root / f"utt{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
        units = rng.integers(0, CODES, size=t // 4 + 2)
        rows.append({"id": f"utt{i}", "src_audio": f"utt{i}.npy", "src_n_frames": t,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
    write_translation_manifest(str(root / "train.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump({"input_feat_per_channel": 80}))
    (root / "dict.letters.txt").write_text("".join(f"{w} 1\n" for w in LETTERS))
    for task in ("source_unigram", "target_letter", "decoder_ctc"):
        (root / task).mkdir()
        lines = [f"utt{i}\t{' '.join(rng.choice(LETTERS, size=int(rng.integers(3, 8))))}"
                 for i in range(4)]
        (root / task / "train.tsv").write_text("id\ttgt_text\n" + "\n".join(lines) + "\n")
    (root / "multitask.yaml").write_text(yaml.safe_dump({
        "source_unigram": {"decoder_type": "ctc", "dict": "dict.letters.txt",
                           "data": "source_unigram", "loss_weight": 8.0},
        "target_letter": {"decoder_type": "transformer", "dict": "dict.letters.txt",
                          "data": "target_letter", "encoder_layer": 1,
                          "loss_weight_max": 1.0, "loss_weight_decay_steps": 10,
                          "loss_weight_min": 0.1, "label_smoothing": 0.1,
                          "decoder_args": {"decoder_layers": 1, "decoder_embed_dim": 16,
                                           "decoder_attention_heads": 2,
                                           "decoder_ffn_embed_dim": 32, "dropout": 0.0}},
        "decoder_ctc": {"decoder_type": "ctc", "dict": "dict.letters.txt",
                        "data": "decoder_ctc", "decoder_layer": 2, "loss_weight": 1.0}}))
    return root


def _tasks(root, n_updates=0):
    args = train_cli.parse_args([str(root), "--task", "speech_to_speech_fasttranslate",
                                 "--max-update", "3", "--dropout", "0",
                                 "--multitask-config-yaml", "multitask.yaml", *PORT_FLAGS])
    task = TASKS[args.task](args)
    jtask = JTASKS.get("speech_to_speech_fasttranslate").setup_task(Config(
        arch="nar_s2ut_conformer", criterion="nar_speech_to_unit", data=str(root),
        multitask_config_yaml="multitask.yaml", dropout=0.0, label_smoothing=0.2,
        warmup_updates=4, lr=5e-4, clip_norm=10.0, **WIDTHS))
    for t in (task, jtask):
        t.set_num_updates(n_updates)
    return task, jtask


def _batches(task, jtask, rows=(0, 1, 2, 3), seed=0):
    out = []
    for t in (task, jtask):
        ds = t.dataset("train")
        out.append(t.prepare_batch(ds.collater([ds[i] for i in rows]),
                                   np.random.default_rng(seed)))
    return out


def _assert_batches_equal(got, want, path="batch"):
    assert sorted(got) == sorted(want), path
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_batches_equal(got[key], value, f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value),
                                          err_msg=f"{path}/{key}")


def test_aux_task_specs_and_dataset_join_match_jax(mt_data):
    """The specs the model is built from, and a collated, prepared batch at
    update 5 (half-way down target_letter's decay): every entry equal to
    JAX's, the aux tasks' targets, prev_output_tokens and loss weights
    included (EOS and prev_output_tokens for the transformer task alone)."""
    task, jtask = _tasks(mt_data, n_updates=5)
    assert [tuple(s) for s in task.aux_task_specs()] == [tuple(s) for s in jtask.aux_task_specs()]
    got, want = _batches(task, jtask)
    _assert_batches_equal(got, want)
    letter, ctc = got["multitask"]["target_letter"], got["multitask"]["source_unigram"]
    assert letter["loss_weight"] == np.float32(1.0 - 5 * 0.09) and ctc["loss_weight"] == 8.0
    assert "prev_output_tokens" in letter and "prev_output_tokens" not in ctc
    assert (ctc["target"] != EOS).all()


@pytest.fixture(scope="module")
def mt_models(mt_data):
    """(task, JAX task, batch, JAX model, perturbed JAX variables, the port's
    model on them in eval mode)."""
    task, jtask = _tasks(mt_data)
    batch, _ = _batches(task, jtask)
    jm = jtask.build_model().module
    variables = jax.jit(lambda b: jtask.init_variables(jtask.build_model(), jax.random.PRNGKey(0),
                                                       b))(batch)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    model = from_jax_variables(task.build_model(), variables).eval()
    return task, jtask, batch, jm, variables, model


def _jax_forward(jm, variables, batch):
    mt_prev = {n: v["prev_output_tokens"] for n, v in batch["multitask"].items()
               if "prev_output_tokens" in v}
    return jax.jit(lambda v, b, p: jm.apply(v, b["src_tokens"], b["src_lengths"],
                                            b["prev_target"], tgt_tokens=b["target"],
                                            multitask_prev=p))(variables, batch, mt_prev)


def test_aux_head_logits_match_jax(mt_models):
    """The transformer head over encoder layer 1 (causal self-attention,
    cross-attention over the tapped states), the CTC heads over the final
    encoder layer and over decoder layer 2's inner state: logits within 1e-5
    and the CTC masks equal; the main logits too."""
    _, _, batch, jm, variables, model = mt_models
    ref = _jax_forward(jm, variables, batch)
    tb = _torch({k: v for k, v in batch.items() if k != "multitask"})
    prev = {"target_letter": torch.from_numpy(
        batch["multitask"]["target_letter"]["prev_output_tokens"])}
    with torch.no_grad():
        out = model(tb["src_tokens"], tb["src_lengths"], tb["prev_target"], tb["target"].long(),
                    multitask_prev=prev)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), rtol=FWD_TOL,
                               atol=FWD_TOL)
    for name, want in ref["multitask"].items():
        got = out["multitask"][name]
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                                   rtol=FWD_TOL, atol=FWD_TOL, err_msg=name)
        if "mask" in want:
            np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert out["multitask"]["target_letter"]["logits"].shape == (
        *prev["target_letter"].shape, len(LETTERS) + 4)
    np.testing.assert_array_equal(out["multitask"]["decoder_ctc"]["mask"].numpy(),
                                  batch["prev_target"] != PAD)


def _ctc_cases():
    """logits [5, 6, 7] with padded frames, and label rows: feasible, more
    labels than frames (zeroed under zero_infinity), as many labels as
    frames with a repeat (no alignment, yet within the length check: a large
    finite loss), empty, and a repeat that just fits."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(5, 6, 7)).astype(np.float32) * 2
    logit_pad = np.zeros((5, 6), np.float32)
    logit_pad[1, 3:] = logit_pad[4, 5:] = 1.0
    labels = np.full((5, 6), PAD, np.int32)
    for row, seq in enumerate(([4, 5, 6], [4, 5, 6, 4], [4, 4, 5, 6, 2, 3], [], [3, 3, 5])):
        labels[row, :len(seq)] = seq
    return logits, logit_pad, labels, (labels == PAD).astype(np.float32)


def test_ctc_loss_matches_optax_past_the_feasibility_boundary():
    """ctc_loss against optax.ctc_loss (blank 0, log-epsilon -1e5): values
    within 1e-5 relative, the impossible rows' large finite ones included;
    the feasible rows' gradients within 1e-4 of scale. An impossible row's
    loss is ~1e5, whose float32 ulp is 0.008: its gradient is summed from
    terms of that size, and both implementations sit within 5e-3 of the
    float64 recursion there (bound 1e-2)."""
    logits, logit_pad, labels, label_pad = _ctc_cases()
    want = np.asarray(optax.ctc_loss(logits, logit_pad, labels, label_pad, blank_id=0))
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(x, torch.from_numpy(logit_pad), torch.from_numpy(labels),
                   torch.from_numpy(label_pad))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    assert want[1] > 1e4 and want[2] > 1e4 and np.isfinite(want).all()
    got.sum().backward()
    ref = np.asarray(jax.grad(lambda z: optax.ctc_loss(z, logit_pad, labels, label_pad).sum())(
        logits))
    err = np.abs(x.grad.numpy() - ref).max(axis=(1, 2)) / np.abs(ref).max()
    assert (err[[0, 3, 4]] <= 1e-4).all() and (err[[1, 2]] <= 1e-2).all(), err


def test_criterion_terms_match_jax(mt_models):
    """The validation criterion: loss, the main metrics and each aux task's
    term within 1e-5 relative, on the batch as it is and with the decoder
    CTC task's first row made longer than its canvas (zeroed) and its second
    as long as its canvas with a repeat (scored with log-epsilon, kept)."""
    task, jtask, batch, jm, variables, model = mt_models
    crit = NARSpeechToUnitLoss(0.2, multitask=task.multitask_tasks)
    jcrit = JNARLoss(Config(label_smoothing=0.2), jtask)
    hard = copy.deepcopy(batch)
    dec = hard["multitask"]["decoder_ctc"]
    canvas = (batch["prev_target"] != PAD).sum(1)
    width = max(int(canvas.max()) + 2, dec["target"].shape[1])
    tgt = np.full((4, width), PAD, np.int32)
    tgt[:, :dec["target"].shape[1]] = dec["target"]
    tgt[0, :canvas[0] + 1] = 4 + np.arange(canvas[0] + 1) % 6
    tgt[1, :canvas[1]] = 4 + np.arange(canvas[1]) % 6
    tgt[1, 1] = tgt[1, 0]
    dec["target"] = tgt
    for b in (batch, hard):
        want_loss, want, _ = jax.jit(lambda v, bb: jcrit(jm, v, bb, jax.random.PRNGKey(0),
                                                         train=False))(variables, b)
        with torch.no_grad():
            loss, got = crit(model, _nested_torch(b))
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        for key, value in want.items():
            np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    assert float(want["multitask_decoder_ctc_loss"]) > 1e3  # the kept impossible row


def _nested_torch(batch):
    return {k: _nested_torch(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v))
            for k, v in batch.items()}


def test_multitask_ctc_vocab_head_with_ctc_target_matches_jax():
    """--multitask-ctc-vocab 12 with an injected ctc_target (as
    tests/test_variants.py:79-99): the CTC head over the final encoder
    features, its mean loss and the total within 1e-5 relative."""
    rng = np.random.default_rng(4)
    b = {"src_tokens": rng.normal(size=(2, 48, 80)).astype(np.float32),
         "src_lengths": np.asarray([48, 30], np.int32),
         "target": np.asarray([[5, 6, 7, 8, 2], [9, 4, 2, 1, 1]], np.int32),
         "prev_target": np.asarray([[3, 6, 3, 8, 2], [3, 3, 2, 1, 1]], np.int32),
         "ctc_target": np.asarray([[5, 6, 7, 1], [4, 5, 1, 1]], np.int32)}
    kw = dict(encoder_dim=32, encoder_ffn_dim=64, encoder_layers=1, encoder_heads=2,
              decoder_dim=32, decoder_ffn_dim=64, decoder_layers=1, decoder_heads=2,
              depthwise_kernel_size=7, conv_channels=32, dropout=0.0, ctc_vocab=12)
    jm = JNARS2UTModule(vocab_size=CODES + 4, **kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), b["src_tokens"], b["src_lengths"],
                                 b["prev_target"], b["target"])
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(2))
    want_loss, want, _ = jax.jit(lambda v, bb: JNARLoss(Config(label_smoothing=0.2))(
        jm, v, bb, jax.random.PRNGKey(0), train=False))(variables, b)
    model = from_jax_variables(NARS2UTModule(vocab_size=CODES + 4, **kw), variables).eval()
    with torch.no_grad():
        loss, got = NARSpeechToUnitLoss(0.2)(model, _torch(b))
    assert "ctc_loss" in got and sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_three_trainer_updates_match_jax(mt_data):
    """3 float32 updates of JAX's Trainer (its task's batches, each with its
    own canvas draw, aux heads and loss weights, lr 5e-4, warmup 4, clip 10)
    and the port's from one initialization, the weight decaying with the
    update count: per update
    loss, gradient norm and each aux term within 1e-4 relative; the final
    parameters within 1e-4 of each leaf's scale (the key biases apart)."""
    task, jtask = _tasks(mt_data)
    rows = [(0, 1, 2, 3)] * 3  # one shape: JAX compiles its step once
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    jtrainer = JTrainer(make_trainer_config(jtask.cfg), jtask, jtask.build_model(),
                        JNARLoss(jtask.cfg, jtask), mesh=mesh)
    state = None
    model, trainer = None, None
    for u, r in enumerate(rows):
        for t in (task, jtask):
            t.set_num_updates(u)
        batch, jbatch = _batches(task, jtask, r, seed=u)
        if state is None:
            # replicated as the step returns it, so the step compiles once
            state = replicate(jtrainer.init_state(jax.random.PRNGKey(0), jbatch), mesh)
            model = from_jax_variables(task.build_model(), {
                "params": jax.device_get(state.params),
                "batch_stats": jax.device_get(state.model_state["batch_stats"])})
            trainer = Trainer(_trainer_cfg(), model, task.build_criterion())
        state, ref = jtrainer.train_step(state, [jbatch], jax.random.PRNGKey(u))
        got = trainer.train_step([batch])
        for key in ("loss", "gnorm", "multitask_target_letter_loss",
                    "multitask_source_unigram_loss", "multitask_decoder_ctc_loss"):
            np.testing.assert_allclose(got[key], ref[key], rtol=TRAJ_RTOL, err_msg=(u, key))
    _assert_trees_close(to_jax_variables(model)["params"], jax.device_get(state.params),
                        PARAM_TOL, "params", skip=KEY_BIASES)


# ---- tokenizers, BPEs, post_process ----

@pytest.mark.parametrize("symbol", ["letter", "subword_nmt", "@@ ", "sentencepiece",
                                    "wordpiece", "silence", "_EOW", "none"])
def test_post_process_matches_jax(symbol):
    for line in ("h e l l o | w o r l d |", "hel@@ lo wor@@ ld", "▁he llo ▁wor ld",
                 "a <SIL> b  <SIL>", "he_EOW llo_EOW", ""):
        assert encoders.post_process(line, symbol) == jencoders.post_process(line, symbol)


def test_tokenizers_and_bpes_match_jax(tmp_path):
    """space, characters, bytes and subword_nmt (a v0.2 codes file) encode
    and decode as JAX's; the optional-package ones are named in the
    registries."""
    codes = tmp_path / "codes"
    codes.write_text("#version: 0.2\nh e\nl l\nhe ll\no</w>\nw o\nr ld</w>\nl d</w>\n")
    text = "hello  world  héllo wold"
    for name in ("characters", "bytes"):
        ours, theirs = encoders.BPES[name](), jencoders.BPES.get(name)()
        assert ours.encode(text) == theirs.encode(text)
        assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
    cfg = {"bpe": "subword_nmt", "bpe_codes": str(codes)}
    ours, theirs = encoders.build_bpe(cfg), jencoders.build_bpe(cfg)
    assert ours.encode(text) == theirs.encode(text) and "@@" in ours.encode(text)
    assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
    tok = encoders.build_tokenizer({"tokenizer": "space"})
    assert tok.encode(text) == jencoders.build_tokenizer({"tokenizer": "space"}).encode(text)
    assert encoders.build_bpe(None) is None and encoders.build_tokenizer({}) is None
    assert {"moses", "nltk"} <= set(encoders.TOKENIZERS)
    assert {"sentencepiece", "bert", "gpt2"} <= set(encoders.BPES)
