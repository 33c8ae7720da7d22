"""UnitY in the port against the JAX package on the CPU, float32, at tiny
widths (tests/test_unity.py's: encoder and decoders 2 x 32, 2 heads, the
first pass 2 layers over a 6-letter dictionary, units of 10 codes): the
task's first-pass selection and prepared batches, the teacher-forced
two-pass forward (unit logits, first-pass logits, features, synthesize;
with a synthesizer encoder, an encoder- and a decoder-tapped CTC head and
a target speaker, and without any), each cached step of both passes against
JAX's and the port's own full forward, `unity_generate` (units and the
first-pass hypotheses equal, scores within 1e-5) and the
speech_to_unit_2pass criterion with one update's gradients against
jax.grad. Shared weights go through `weights.from_jax_variables`; inputs
come from numpy seeds."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.ce_loss import SpeechToUnit2PassLoss as JSpeechToUnit2PassLoss
from diffnorm_tpu.generate.unity import unity_generate as junity_generate
from diffnorm_tpu.models.unity import UnityS2UTModule as JUnity
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.generate.unity import handoff_tokens, unity_generate
from diffnorm_tpu_torch.models.unity import UnityS2UTModule
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.weights import from_jax_variables, to_jax_variables
from tests.test_torch_multitask import _assert_batches_equal, _nested_torch
from tests.test_torch_nar_train import FWD_TOL, GRAD_TOL, _assert_trees_close, _perturb
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

PAD, EOS = 1, 2
CODES = 10
LETTERS = [chr(ord("a") + k) for k in range(6)]
WIDTHS = dict(encoder_layers=2, decoder_layers=2, encoder_embed_dim=32,
              encoder_ffn_embed_dim=64, encoder_attention_heads=2, decoder_attention_heads=2,
              decoder_embed_dim=32, decoder_ffn_embed_dim=64, depthwise_conv_kernel_size=7,
              target_code_size=CODES, translation_decoder_layers=2)
SPK_DIM = 8
# JAX's own bound for a cached decode against the full forward
# (tests/test_ar.py::test_kv_cache_matches_full_forward)
CACHE_RTOL, CACHE_ATOL = 2e-3, 2e-4
LOSS_RTOL = 1e-5


def flags(values):
    return [f"--{k.replace('_', '-')}" + ("" if v is True else f"={v}")
            for k, v in values.items()]


def write_unity_corpus(root, seed=0, splits=(("train", 4), ("test", 2)), aux=True):
    """.npy sources of 36-56 frames with t // 4 + 2 units, letter targets of
    3-6 letters for the first pass (target_letter) and, with `aux`, an
    encoder-tapped (source_unigram) and a decoder-tapped (decoder_ctc) CTC
    head."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        rows = []
        for i in range(n):
            uid, t = f"{split}{i}", int(rng.integers(36, 56))
            np.save(root / f"{uid}.npy", rng.normal(size=(t, 80)).astype(np.float32))
            units = rng.integers(0, CODES, size=t // 4 + 2)
            rows.append({"id": uid, "src_audio": f"{uid}.npy", "src_n_frames": t,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump({"input_feat_per_channel": 80}))
    (root / "dict.letters.txt").write_text("".join(f"{w} 1\n" for w in LETTERS))
    tasks = ("source_unigram", "target_letter", "decoder_ctc") if aux else ("target_letter",)
    for task in tasks:
        (root / task).mkdir(exist_ok=True)
        for split, n in splits:
            lines = [f"{split}{i}\t{' '.join(rng.choice(LETTERS, size=int(rng.integers(3, 7))))}"
                     for i in range(n)]
            (root / task / f"{split}.tsv").write_text("id\ttgt_text\n" + "\n".join(lines) + "\n")
    config = {"target_letter": {"decoder_type": "transformer", "dict": "dict.letters.txt",
                                "data": "target_letter", "is_first_pass_decoder": True,
                                "loss_weight": 1.0, "decoder_args": {"dropout": 0.0}}}
    if aux:
        config["source_unigram"] = {"decoder_type": "ctc", "dict": "dict.letters.txt",
                                    "data": "source_unigram", "loss_weight": 8.0}
        config["decoder_ctc"] = {"decoder_type": "ctc", "dict": "dict.letters.txt",
                                 "data": "decoder_ctc", "decoder_layer": 2, "loss_weight": 1.0}
    (root / "multitask.yaml").write_text(yaml.safe_dump(config))
    return root


def unity_tasks(root, **extra):
    """(the port's task, JAX's task) on one config, both through
    --task speech_to_speech --target-is-code."""
    values = {**WIDTHS, "multitask_config_yaml": "multitask.yaml", **extra}
    args = train_cli.parse_args([str(root), "--task", "speech_to_speech", "--target-is-code",
                                 "--arch", "unity_conformer", "--max-update", "1",
                                 "--dropout", "0", *flags(values)])
    jtask = JTASKS.get("speech_to_speech").setup_task(Config(
        arch="unity_conformer", criterion="speech_to_unit_2pass", data=str(root),
        target_is_code=True, dropout=0.0, label_smoothing=0.1, **values))
    return TASKS[args.task](args), jtask


def prepared(task, jtask, split="train", rows=(0, 1, 2, 3)):
    out = []
    for t in (task, jtask):
        ds = t.dataset(split)
        out.append(t.prepare_batch(ds.collater([ds[i] for i in rows]),
                                   np.random.default_rng(0)))
    return out


def speaker(b):
    return np.random.default_rng(9).normal(size=(b, SPK_DIM)).astype(np.float32)


def mt_prev(batch):
    """{task: prev_output_tokens} of the batch's transformer tasks."""
    return {name: entry["prev_output_tokens"] for name, entry in batch["multitask"].items()
            if "prev_output_tokens" in entry}


def forward_kwargs(batch, spk=None):
    kw = dict(prev_tokens_mt=batch["multitask"]["target_letter"]["prev_output_tokens"],
              tgt_tokens=batch["target"], multitask_prev=mt_prev(batch))
    if spk is not None:
        kw["tgt_speaker"] = spk
    return kw


def build(root, speakers, **extra):
    """(port task, JAX task, batch, JAX module, perturbed variables, the
    port's model on them, tgt_speaker or None)."""
    spk_flags = dict(target_speaker_embed=True, speaker_embed_dim=SPK_DIM) if speakers else {}
    task, jtask = unity_tasks(root, **spk_flags, **extra)
    batch, jbatch = prepared(task, jtask)
    _assert_batches_equal(batch, jbatch)
    jm = jtask.build_model().module
    spk = speaker(batch["src_tokens"].shape[0]) if speakers else None
    variables = jax.jit(lambda b, s: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b["src_tokens"], b["src_lengths"], b["prev_output_tokens"], deterministic=True,
        **forward_kwargs(b, s)))(batch, spk)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    model = from_jax_variables(task.build_model(), variables).eval()
    return task, jtask, batch, jm, variables, model, spk


@pytest.fixture(scope="module")
def unity(tmp_path_factory):
    """The model with a synthesizer encoder layer, two CTC aux heads and a
    target speaker."""
    root = write_unity_corpus(tmp_path_factory.mktemp("unity"))
    return build(root, speakers=True, synthesizer_encoder_layers=1)


@pytest.fixture(scope="module")
def unity_plain(tmp_path_factory):
    """Without a synthesizer encoder, aux heads or speakers."""
    root = write_unity_corpus(tmp_path_factory.mktemp("unity0"), aux=False)
    return build(root, speakers=False)


def _torch_kwargs(batch, spk):
    return _nested_torch(forward_kwargs({k: batch[k] for k in ("target", "multitask")}, spk))


def test_first_pass_task_specs_and_prev_tokens(unity):
    """The first-pass task is the flagged one in both packages; the model's
    aux heads are the other tasks; first_pass_prev_tokens is the batch's,
    or JAX's [EOS, PAD] stub where the split has no first-pass text."""
    task, jtask, batch, jm, variables, model, _ = unity
    assert task.mt_task_name == jtask.mt_task_name == "target_letter"
    assert model.multitask == jm.multitask
    assert sorted(s.name for s in model.multitask) == ["decoder_ctc", "source_unigram"]
    assert "mt_target_letter_decoder" in variables["params"]
    assert "synthesizer_encoder" in variables["params"]
    np.testing.assert_array_equal(task.first_pass_prev_tokens(batch),
                                  jtask.first_pass_prev_tokens(batch))
    stub = {"target": batch["target"]}
    np.testing.assert_array_equal(task.first_pass_prev_tokens(stub),
                                  jtask.first_pass_prev_tokens(stub))
    np.testing.assert_array_equal(task.first_pass_prev_tokens(stub)[0], [EOS, PAD])


@pytest.mark.parametrize("case", ["synthesizer, aux heads, speaker", "no synthesizer"])
def test_two_pass_forward_matches_jax(unity, unity_plain, case):
    """An eval forward with the aux heads on: unit logits, the first pass's
    logits and every aux head's (with its mask) within 1e-5 of JAX's; then
    mt_features and synthesize on the batch's first-pass tokens."""
    task, jtask, batch, jm, variables, model, spk = (
        unity if case.startswith("synthesizer") else unity_plain)
    want = jax.jit(lambda v, b, s: jm.apply(v, b["src_tokens"], b["src_lengths"],
                                            b["prev_output_tokens"], deterministic=True,
                                            **forward_kwargs(b, s)))(variables, batch, spk)
    t = _nested_torch(batch)
    with torch.no_grad():
        got = model(t["src_tokens"], t["src_lengths"], t["prev_output_tokens"].long(),
                    **_torch_kwargs(batch, spk))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert sorted(got["multitask"]) == sorted(want["multitask"])
    for name, head in want["multitask"].items():
        for key, value in head.items():
            np.testing.assert_allclose(got["multitask"][name][key].float().numpy(),
                                       np.asarray(value, np.float32), rtol=FWD_TOL,
                                       atol=FWD_TOL, err_msg=f"{name}/{key}")
    prev_mt = batch["multitask"]["target_letter"]["prev_output_tokens"]

    def jax_handoff(v, b, s):
        enc, mask = jm.apply(v, b["src_tokens"], b["src_lengths"], method=JUnity.encode,
                             **({} if s is None else {"tgt_speaker": s}))
        feats = jm.apply(v, prev_mt, enc, mask, method=JUnity.mt_features)
        return feats, jm.apply(v, feats, prev_mt != PAD, method=JUnity.synthesize)[0]

    want_feats, want_t2u = jax.jit(jax_handoff)(variables, batch, spk)
    with torch.no_grad():
        enc, mask = model.encode(t["src_tokens"], t["src_lengths"],
                                 tgt_speaker=None if spk is None else torch.from_numpy(spk))
        prev = torch.from_numpy(prev_mt).long()
        feats = model.mt_features(prev, enc, mask)
        t2u, t2u_mask = model.synthesize(feats, prev != PAD)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(t2u.numpy(), np.asarray(want_t2u), rtol=FWD_TOL, atol=FWD_TOL)
    assert torch.equal(t2u_mask, prev != PAD)
    assert (t2u is feats) == (case == "no synthesizer")


def test_cached_steps_match_jax_and_the_full_forward(unity):
    """Five cached steps of each pass on the teacher-forced inputs: each
    step's logits within 1e-5 of JAX's decode_mt_step / decode_step (the
    cache collection threaded through), and together within JAX's tolerance
    of the port's own full forward before each row's first PAD."""
    task, jtask, batch, jm, variables, model, spk = unity
    t = _nested_torch(batch)
    prev_mt = batch["multitask"]["target_letter"]["prev_output_tokens"]
    prev = batch["prev_output_tokens"]
    steps, max_len = 5, 12
    tspk = torch.from_numpy(spk)

    def jax_steps(method, tokens, ctx, ctx_mask):
        step = jax.jit(lambda v, tok, pos: jm.apply(v, tok, ctx, ctx_mask, pos, max_len,
                                                    method=method, mutable=["cache"]))
        jax_vars, out = dict(variables), []
        for i in range(steps):
            logits, mutated = step(jax_vars, jnp.asarray(tokens[:, i:i + 1]),
                                   jnp.full((tokens.shape[0],), i))
            jax_vars["cache"] = mutated["cache"]
            out.append(np.asarray(logits))
        return np.stack(out, axis=1)

    jenc, jmask = jax.jit(lambda v: jm.apply(v, batch["src_tokens"], batch["src_lengths"],
                                             method=JUnity.encode, tgt_speaker=spk))(variables)
    jt2u, jt2u_mask = jax.jit(lambda v: jm.apply(
        v, jm.apply(v, prev_mt, jenc, jmask, method=JUnity.mt_features), prev_mt != PAD,
        method=JUnity.synthesize))(variables)
    want_mt = jax_steps(JUnity.decode_mt_step, prev_mt, jenc, jmask)
    want_units = jax_steps(JUnity.decode_step, prev, jt2u, jt2u_mask)
    with torch.no_grad():
        full = model(t["src_tokens"], t["src_lengths"], t["prev_output_tokens"].long(),
                     **_torch_kwargs(batch, spk))
        enc, mask = model.encode(t["src_tokens"], t["src_lengths"], tgt_speaker=tspk)
        pm = torch.from_numpy(prev_mt).long()
        t2u, t2u_mask = model.synthesize(model.mt_features(pm, enc, mask), pm != PAD)
        got = {}
        for what, init, step, toks, ctx, ctx_mask in (
                ("mt", model.init_mt_cache, model.decode_mt_step, pm, enc, mask),
                ("units", model.init_cache, model.decode_step, t["prev_output_tokens"].long(),
                 t2u, t2u_mask)):
            cache, out = init(ctx, ctx_mask, max_len), []
            for i in range(steps):
                logits, cache = step(toks[:, i:i + 1], cache, torch.full((toks.shape[0],), i))
                out.append(logits.numpy())
            got[what] = np.stack(out, axis=1)
    for what, want, full_logits, toks in (
            ("mt", want_mt, full["multitask"]["target_letter"]["logits"], prev_mt),
            ("units", want_units, full["logits"], prev)):
        np.testing.assert_allclose(got[what], want, rtol=FWD_TOL, atol=FWD_TOL, err_msg=what)
        real = np.cumprod(toks[:, :steps] != PAD, axis=1).astype(bool)
        assert real.sum() >= toks.shape[0] * 3
        np.testing.assert_allclose(got[what][real], full_logits[:, :steps].numpy()[real],
                                   rtol=CACHE_RTOL, atol=CACHE_ATOL, err_msg=what)


def test_handoff_layout():
    """The best hypothesis [tokens, EOS, PAD ..] becomes [EOS, tokens, PAD
    ..]; a hypothesis that fills the buffer loses its last token."""
    best = torch.tensor([[5, 6, EOS, PAD, PAD], [7, EOS, PAD, PAD, PAD], [4, 5, 6, 7, EOS]])
    np.testing.assert_array_equal(handoff_tokens(best).numpy(),
                                  [[EOS, 5, 6, PAD, PAD], [EOS, 7, PAD, PAD, PAD],
                                   [EOS, 4, 5, 6, 7]])


def test_unity_generate_matches_jax(unity):
    """Both beam passes (beam 3 / first-pass beam 2, ngram blocking 2, length
    penalties) with a target speaker: units and the first-pass hypotheses
    equal to JAX's, scores within 1e-5."""
    task, jtask, batch, jm, variables, model, spk = unity
    kw = dict(beam_size=3, beam_size_mt=2, max_len=10, max_len_mt=8, len_penalty=0.8,
              len_penalty_mt=1.2, no_repeat_ngram=2)
    holder = jtask.build_model()
    want = jax.jit(lambda v, s, n, sp: junity_generate(holder, v, s, n, tgt_speaker=sp, **kw))(
        variables, batch["src_tokens"], batch["src_lengths"], spk)
    t = _nested_torch(batch)
    seqs, scores, mt_best = unity_generate(model, t["src_tokens"], t["src_lengths"],
                                           tgt_speaker=torch.from_numpy(spk), **kw)
    assert seqs.shape == (4, 3, 10) and mt_best.shape == (4, 8)
    np.testing.assert_array_equal(mt_best.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]), rtol=FWD_TOL, atol=FWD_TOL)
    assert (mt_best[:, 0] != EOS).any()


def test_2pass_criterion_and_gradients_match_jax(unity):
    """A training forward at dropout 0 (batch statistics): the loss and
    every metric (the first pass's term and both CTC terms among them)
    within 1e-5 relative of JAX's speech_to_unit_2pass, and d loss / d params
    within 1e-4 of each leaf's scale against jax.grad, on CTC rows that can
    align (tests/test_torch_ar.py says why)."""
    task, jtask, batch, jm, variables, model, spk = unity
    batch = copy.deepcopy(batch)
    batch["tgt_speaker"] = spk
    dec = batch["multitask"]["decoder_ctc"]["target"]
    canvas = (batch["prev_output_tokens"] != PAD).sum(1)
    for row, n in enumerate(np.minimum((dec != PAD).sum(1), canvas)):
        dec[row] = PAD
        dec[row, :n] = 4 + np.arange(n) % 2
    jcrit = JSpeechToUnit2PassLoss(Config(label_smoothing=0.1), jtask)
    holder = jtask.build_model()

    @jax.jit
    @functools.partial(jax.value_and_grad, has_aux=True)
    def loss_fn(params, b):
        loss, mets, _ = jcrit(holder, {**variables, "params": params}, b,
                              jax.random.PRNGKey(0), train=True)
        return loss, mets

    (want_loss, want), ref = loss_fn(variables["params"], batch)
    crit = task.build_criterion()
    model = copy.deepcopy(model).train()
    loss, got = crit(model, _nested_torch(batch))
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
    _assert_trees_close(to_jax_variables(model)["params"], jax.device_get(ref), GRAD_TOL, "grad")


def test_unity_refuses_without_a_first_pass_task():
    with pytest.raises(ValueError, match="first-pass"):
        UnityS2UTModule(vocab_size=14)
