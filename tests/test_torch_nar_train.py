"""The port's NAR S2UT training (models/{conformer,nar_transformer}.py in
training mode, criterions/nar_loss.py, the trainer's model state and draw
streams, checkpoints with BatchNorm statistics, cli.train -> cli.s2st)
against the JAX package on the CPU, float32, at tiny widths (encoder 2 x 32,
ffn 64, 2 heads, decoder 2 layers, depthwise kernel 5, conv channels 32,
vocab 16 + 4). Shared weights go through `weights.from_jax_variables` with
non-zero biases and BatchNorm statistics; inputs come from numpy seeds.
Dropout masks cannot match JAX's PRNG: the comparisons run at dropout 0 with
the CG and SP draws injected, and dropout is checked by its statistics."""

import copy
import json
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.config import Config, make_trainer_config
from diffnorm_tpu.criterions.nar_loss import NARSpeechToUnitLoss as JNARLoss
from diffnorm_tpu.models.conformer import ConformerEncoder as JConformerEncoder
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.parallel.mesh import make_mesh
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.train.trainer import Trainer as JTrainer
from diffnorm_tpu_torch.cli import s2st as s2st_cli
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.models.conformer import BatchNorm, ConformerEncoder
from diffnorm_tpu_torch.models.hifigan import CodeHiFiGANVocoder
from diffnorm_tpu_torch.models.layers import Dropout, set_dropout_generator
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.ops.quant import quant_sites
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.tasks.nar_s2ut_task import random_mask
from diffnorm_tpu_torch.train.checkpoint import CheckpointManager, load_variables
from diffnorm_tpu_torch.train.optimizers import Bmuf
from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
from diffnorm_tpu_torch.weights import from_jax_variables, save_npz, to_jax_variables
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

CODES = 16
VOCAB = CODES + 4
NAR = dict(encoder_dim=32, encoder_ffn_dim=64, encoder_layers=2, encoder_heads=2,
           decoder_dim=32, decoder_ffn_dim=64, decoder_layers=2, decoder_heads=2,
           depthwise_kernel_size=5, conv_channels=32)
NAR_CFG = dict(target_code_size=CODES, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
               encoder_layers=2, encoder_attention_heads=2, decoder_layers=2,
               decoder_attention_heads=2, depthwise_conv_kernel_size=5, conv_channels=32)
B, T, L = 3, 64, 32  # batch, bucketed source frames, bucketed target length
N_UPDATES, UPDATE_FREQ, CLIP = 12, 2, 10.0
LR, WARMUP, WARMUP_INIT, BETAS, EPS = 5e-4, 4, 1e-7, (0.9, 0.98), 1e-8
# float32, the same functions summed in other orders: forwards within 1e-5,
# statistics within 1e-6, gradients within 1e-4 of each leaf's scale, the
# trajectory's losses and gradient norms within 1e-4 relative
FWD_TOL, STATS_TOL, GRAD_TOL, TRAJ_RTOL, PARAM_TOL = 1e-5, 1e-6, 1e-4, 1e-4, 1e-4
# a key projection's bias adds q . b to every score of a query, which the
# softmax cancels: its gradient is zero in exact arithmetic and rounding
# noise in float32 (< 1e-6 of the largest gradient, pinned below), which
# Adam normalizes into lr-sized steps, so the two trainers' key biases walk
# apart by their noise; the trajectory compares every other leaf
KEY_BIASES = ("k_proj/bias", "linear_k/bias")


def _perturb(variables, rng):
    """Non-zero biases, LayerNorm / BatchNorm scales != 1 and BatchNorm
    statistics away from (0, 1)."""

    def walk(tree):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = walk(leaf)
                continue
            a = np.array(leaf, dtype=np.float32)
            if key == "bias":
                a = a + rng.normal(scale=0.1, size=a.shape)
            elif key == "scale":
                a = a * (1.0 + rng.normal(scale=0.1, size=a.shape))
            elif key == "mean":
                a = rng.normal(scale=0.2, size=a.shape)
            elif key == "var":
                a = rng.uniform(0.5, 1.5, size=a.shape)
            out[key] = a.astype(np.float32)
        return out

    return {k: walk(v) for k, v in variables.items()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(got, want, tol, what, skip=()):
    """Every leaf of `want` in `got` within tol of the leaf's scale (but
    those whose path ends with one of `skip`)."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), what
    for k, ref in want.items():
        if k.endswith(skip):
            continue
        scale = max(np.abs(ref).max(), 1e-3)
        err = np.abs(got[k] - ref).max()
        assert err <= tol * scale, f"{what} {k}: {err:.3e} against scale {scale:.3e}"


def _batch(seed, b=B, lengths=(64, 41, 23), tgt_lengths=(20, 1, 11)):
    """A ragged batch padded to its buckets: fbank [B, T, 80], targets with
    EOS (one row of EOS alone) padded with 1, and the CMLM canvas."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths[:b], np.int32)
    mask = np.arange(T)[None, :] < lengths[:, None]
    src = (rng.normal(size=(b, T, 80)) * mask[..., None]).astype(np.float32)
    target = np.full((b, L), 1, np.int32)
    for i, n in enumerate(tgt_lengths[:b]):
        target[i, :n - 1] = rng.integers(4, VOCAB, size=n - 1)
        target[i, n - 1] = 2
    return {"src_tokens": src, "src_lengths": lengths, "target": target,
            "prev_target": random_mask(target, rng)}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def nar():
    """JAX NARS2UTModule variables (perturbed) and the port's model on them."""
    jm = JNARS2UTModule(vocab_size=VOCAB, dropout=0.0, **NAR)
    batch = _batch(0)
    variables = jm.init(jax.random.PRNGKey(0), batch["src_tokens"], batch["src_lengths"],
                        batch["prev_target"], tgt_tokens=batch["target"])
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    return variables


def _port(variables, **kw):
    return from_jax_variables(NARS2UTModule(vocab_size=VOCAB, **{"dropout": 0.0, **NAR, **kw}),
                              variables)


def test_conformer_training_forward_matches_jax():
    """A training forward at dropout 0 (batch statistics, padding frames
    included) against JAX's with mutable=["batch_stats"], ragged rows in a
    bucket-padded batch: features within 1e-5, the updated running
    statistics within 1e-6; then an eval forward on the updated statistics."""
    enc_kw = dict(dim=32, ffn_dim=64, layers=2, heads=2, depthwise_kernel_size=5,
                  conv_channels=32)
    jenc = JConformerEncoder(dropout=0.0, **enc_kw)
    batch = _batch(2)
    src, lengths = batch["src_tokens"], batch["src_lengths"]
    variables = _perturb(jax.device_get(dict(jenc.init(jax.random.PRNGKey(3), src, lengths))),
                         np.random.default_rng(4))
    (ref, ref_mask), mutated = jenc.apply(variables, src, lengths, deterministic=False,
                                          mutable=["batch_stats"],
                                          rngs={"dropout": jax.random.PRNGKey(5)})
    enc = from_jax_variables(ConformerEncoder(80, 32, 64, 2, 2, 5, 32, dropout=0.0), variables)
    out, mask = enc.train()(torch.from_numpy(src), torch.from_numpy(lengths))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert not mask.all()  # padding frames inside the batch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=FWD_TOL, atol=FWD_TOL)
    got_stats = to_jax_variables(enc)["batch_stats"]
    want_stats = jax.device_get(mutated["batch_stats"])
    for k, v in _flat(want_stats).items():
        np.testing.assert_allclose(_flat(got_stats)[k], v, rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=k)
        assert not np.allclose(v, _flat(variables["batch_stats"])[k])  # they moved
    (ref_eval, _) = jenc.apply({**variables, "batch_stats": want_stats}, src, lengths)
    with torch.no_grad():
        out_eval, _ = enc.eval()(torch.from_numpy(src), torch.from_numpy(lengths))
    np.testing.assert_allclose(out_eval.numpy(), np.asarray(ref_eval), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("use_prompt", [False, True])
def test_nar_forward_matches_jax_with_injected_draws(nar, monkeypatch, use_prompt):
    """NARS2UTModule.forward in training mode (dropout 0, cg_prob 0.5, use_sp)
    against JAX's __call__(deterministic=False), the CG drops [B] and the SP
    draw injected on both sides (JAX's through jax.random.bernoulli): logits,
    length logits within 1e-5, length_tgt and word_ins_mask equal, and the
    updated statistics within 1e-6."""
    batch = _batch(6)
    cg_drop = np.asarray([False, True, False])
    jm = JNARS2UTModule(vocab_size=VOCAB, dropout=0.0, cg_prob=0.5, use_sp=True, **NAR)

    def bernoulli(key, p=0.5, shape=None):
        return jnp.asarray(cg_drop) if shape is not None else jnp.asarray(use_prompt)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "bernoulli", bernoulli)
        ref, mutated = jm.apply(
            nar, batch["src_tokens"], batch["src_lengths"], batch["prev_target"],
            tgt_tokens=batch["target"], deterministic=False, mutable=["batch_stats"],
            rngs={k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "cg", "sp"))})
    model = _port(nar, cg_prob=0.5, use_sp=True).train()
    tb = _torch(batch)
    out = model(tb["src_tokens"], tb["src_lengths"], tb["prev_target"], tb["target"].long(),
                cg_drop=torch.from_numpy(cg_drop), use_prompt=torch.tensor(use_prompt))
    for key in ("logits", "length_logits"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   rtol=FWD_TOL, atol=FWD_TOL, err_msg=key)
    for key in ("length_tgt", "word_ins_mask"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    np.testing.assert_array_equal(out["length_tgt"].numpy(), (batch["target"] != 1).sum(1))
    _assert_trees_close(to_jax_variables(model)["batch_stats"],
                        jax.device_get(mutated["batch_stats"]), STATS_TOL, "batch_stats")


def test_criterion_metrics_match_jax(nar):
    """The validation criterion (eval mode, deterministic) on a batch with a
    row of target length 1 (ignored by the length CE): loss, nll_loss,
    loss_length, acc and the counts within 1e-6 relative."""
    batch = _batch(7)
    ref_loss, ref_mets, _ = JNARLoss(Config(label_smoothing=0.2))(
        JNARS2UTModule(vocab_size=VOCAB, dropout=0.0, **NAR), nar, batch,
        jax.random.PRNGKey(0), train=False)
    model = _port(nar).eval()
    with torch.no_grad():
        loss, mets = NARSpeechToUnitLoss(0.2)(model, _torch(batch))
    assert set(mets) == set(ref_mets)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for k, v in ref_mets.items():
        np.testing.assert_allclose(float(mets[k]), float(v), rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(mets["ntokens"]) == int((batch["target"] != 1).sum())


def test_gradients_match_jax_grad(nar):
    """d loss / d params of a training forward (dropout 0, batch statistics)
    against jax.grad of JAX's criterion with train=True: each leaf within
    1e-4 of its scale."""
    batch = _batch(8)
    jm = JNARS2UTModule(vocab_size=VOCAB, dropout=0.0, **NAR)
    crit = JNARLoss(Config(label_smoothing=0.2))

    def loss_fn(params):
        return crit(jm, {**nar, "params": params}, batch, jax.random.PRNGKey(0), train=True)[0]

    ref = jax.device_get(jax.grad(loss_fn)(nar["params"]))
    model = _port(nar).train()
    loss, _ = NARSpeechToUnitLoss(0.2)(model, _torch(batch))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
    got = to_jax_variables(holder)["params"]
    _assert_trees_close(got, ref, GRAD_TOL, "grad")
    for tree in (got, ref):
        flat = _flat(tree)
        top = max(np.abs(v).max() for v in flat.values())
        keys = [k for k in flat if k.endswith(KEY_BIASES)]
        assert len(keys) == 2 * NAR["decoder_layers"] + NAR["encoder_layers"]
        assert all(np.abs(flat[k]).max() <= 1e-6 * top for k in keys)


def test_dropout_keep_share_and_scale():
    """Dropout(p) keeps 1 - p of the elements (within 4 standard errors over
    2e5) scaled by 1 / (1 - p), draws from its generator (same seed, same
    mask), and is the identity in eval mode; a NAR training forward at
    dropout 0.1 differs between draws and repeats on a reseeded generator."""
    for p in (0.1, 0.3):
        drop = Dropout(p)
        drop.generator = torch.Generator().manual_seed(0)
        x = torch.ones(200_000)
        y = drop.train()(x)
        share = (y != 0).float().mean().item()
        assert abs(share - (1 - p)) < 4 * np.sqrt(p * (1 - p) / x.numel())
        assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1.0 / (1 - p)))
        drop.generator.manual_seed(0)
        assert torch.equal(drop(x), y)
        assert drop.eval()(x) is x
    torch.manual_seed(0)
    model = NARS2UTModule(vocab_size=VOCAB, dropout=0.1, **NAR).train()
    gen = torch.Generator().manual_seed(1)
    set_dropout_generator(model, gen)
    tb = _torch(_batch(9))
    args = (tb["src_tokens"], tb["src_lengths"], tb["prev_target"], tb["target"].long())
    with torch.no_grad():
        a, b = model(*args)["logits"], model(*args)["logits"]
        gen.manual_seed(1)
        again = model(*args)["logits"]
    assert not torch.equal(a, b) and torch.equal(a, again)


def _jax_nar_setup(micros):
    cfg = Config(arch="nar_s2ut_conformer", criterion="nar_speech_to_unit", dropout=0.0,
                 label_smoothing=0.2, lr=LR, lr_scheduler="inverse_sqrt",
                 warmup_updates=WARMUP, warmup_init_lr=WARMUP_INIT, adam_betas=BETAS,
                 adam_eps=EPS, clip_norm=CLIP, update_freq=UPDATE_FREQ, **NAR_CFG)
    task = JTASKS.get("speech_to_speech_fasttranslate").setup_task(cfg)
    jmodel = task.build_model()
    jtrainer = JTrainer(make_trainer_config(cfg), task, jmodel, JNARLoss(cfg, task),
                        mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    return jtrainer, jtrainer.init_state(jax.random.PRNGKey(0), micros[0])


def _trainer_cfg(dtype="float32", seed=1):
    return TrainerConfig(lr=LR, warmup_updates=WARMUP, warmup_init_lr=WARMUP_INIT,
                         adam_betas=BETAS, adam_eps=EPS, clip_norm=CLIP, dtype=dtype,
                         seed=seed)


def test_trajectory_matches_jax_trainer():
    """12 float32 updates of update_freq 2 (clip 10, lr 5e-4, inverse_sqrt
    warmup 4 from 1e-7, betas (0.9, 0.98), label smoothing 0.2, dropout 0)
    of JAX's Trainer with its NARS2UTTask and of the port's, from one
    initialization: per update the loss and gradient norm within 1e-4
    relative ("sum_loss" accumulation over micro-batches of different
    ntokens); the final parameters and the BatchNorm statistics, updated
    micro-batch by micro-batch, within 1e-4 of each leaf's scale (the key
    projections' biases apart: KEY_BIASES)."""
    lengths = [(64, 41, 23), (50, 50, 12), (33, 20, 9), (64, 60, 58)]
    tgt_lengths = [(20, 1, 11), (9, 16, 3), (25, 2, 7), (30, 12, 5)]
    micros = [_batch(40 + k, lengths=lengths[k % 4], tgt_lengths=tgt_lengths[k % 4])
              for k in range(N_UPDATES * UPDATE_FREQ)]
    jtrainer, state = _jax_nar_setup(micros)
    init = {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.model_state["batch_stats"])}
    model = _port(init)
    trainer = Trainer(_trainer_cfg(), model, NARSpeechToUnitLoss(0.2))
    ref_loss, ref_gnorm, loss, gnorm = [], [], [], []
    for u in range(N_UPDATES):
        chunk = micros[u * UPDATE_FREQ:(u + 1) * UPDATE_FREQ]
        state, ref = jtrainer.train_step(state, chunk, jax.random.PRNGKey(u))
        got = trainer.train_step(chunk)
        ref_loss.append(ref["loss"])
        ref_gnorm.append(ref["gnorm"])
        loss.append(got["loss"])
        gnorm.append(got["gnorm"])
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-6)
        assert got["sample_size"] == ref["sample_size"]
    np.testing.assert_allclose(loss, ref_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(gnorm, ref_gnorm, rtol=TRAJ_RTOL)
    assert gnorm[0] > CLIP  # the clip is exercised
    variables = to_jax_variables(model)
    _assert_trees_close(variables["params"], jax.device_get(state.params), PARAM_TOL, "params",
                        skip=KEY_BIASES)
    _assert_trees_close(variables["batch_stats"],
                        jax.device_get(state.model_state["batch_stats"]), PARAM_TOL, "stats")
    moved = [k for k, v in _flat(init["params"]).items()
             if not np.array_equal(v, _flat(variables["params"])[k])]
    assert len(moved) == len(_flat(init["params"]))


def test_bf16_training_keeps_float32_statistics(tmp_path):
    """--dtype bfloat16: the working copy's BatchNorm statistics stay float32
    and are the master's tensors, so training updates reach the master and
    its checkpoint; the master parameters stay float32."""
    torch.manual_seed(0)
    model = NARS2UTModule(vocab_size=VOCAB, dropout=0.1, cg_prob=0.2, use_sp=True, **NAR)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    trainer = Trainer(_trainer_cfg("bfloat16"), model, NARSpeechToUnitLoss(0.2))
    assert next(trainer.model.parameters()).dtype == torch.bfloat16
    pairs = [(m, w) for m, w in zip(model.modules(), trainer.model.modules())
             if isinstance(m, BatchNorm)]
    assert len(pairs) == NAR["encoder_layers"]
    for _ in range(2):
        mets = trainer.train_step([_batch(10), _batch(11)])
        assert np.isfinite(mets["loss"]) and np.isfinite(mets["gnorm"])
    for m, w in pairs:
        for name in BatchNorm.STATS:
            assert getattr(w, name).dtype == torch.float32
            assert getattr(w, name) is getattr(m, name)
    for k, v in before.items():
        assert not torch.equal(model.state_dict()[k], v), k
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(2, model, trainer.state_dict())
    stats = load_variables(ckpt.path(2))["batch_stats"]
    np.testing.assert_array_equal(
        stats["encoder"]["layer_0"]["conv_module"]["batch_norm"]["var"],
        model.encoder.layer_0.conv_module.batch_norm.running_var.numpy())


def test_resume_is_bit_equal_with_statistics(tmp_path):
    """Dropout 0.1, cg_prob 0.15 and self-prompting from the trainer's three
    generators: 3 updates, a checkpoint, a fresh trainer resumed from it, 3
    more give the same losses, gradient norms, parameters and BatchNorm
    statistics, bit for bit, as 6 updates in one run."""
    micros = [_batch(60 + k) for k in range(12)]

    def fresh():
        torch.manual_seed(0)
        model = NARS2UTModule(vocab_size=VOCAB, dropout=0.1, cg_prob=0.15, use_sp=True, **NAR)
        return model, Trainer(_trainer_cfg(seed=3), model, NARSpeechToUnitLoss(0.2))

    model, trainer = fresh()
    straight = [trainer.train_step(micros[2 * u:2 * u + 2]) for u in range(6)]
    model2, trainer2 = fresh()
    first = [trainer2.train_step(micros[2 * u:2 * u + 2]) for u in range(3)]
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(3, model2, trainer2.state_dict(), None, {"epoch": 1})
    model3, trainer3 = fresh()
    variables, state, _ = ckpt.load(ckpt.latest_step(), "cpu")
    from_jax_variables(model3, variables)
    trainer3.load_state_dict(state)
    resumed = first + [trainer3.train_step(micros[2 * u:2 * u + 2]) for u in range(3, 6)]
    assert [(m["loss"], m["gnorm"]) for m in resumed] == [
        (m["loss"], m["gnorm"]) for m in straight]
    for (n, a), (_, b) in zip(model.state_dict().items(), model3.state_dict().items()):
        assert torch.equal(a, b), n


def _write_wav_corpus(root, n=12, seed=0):
    """train (n), dev (3) and test (3) splits of 0.25-0.6 s 16 kHz WAV
    sources with 3-14 unit targets, and a config.yaml with utterance CMVN
    and SpecAugment on train."""
    rng = np.random.default_rng(seed)
    for split, m in (("train", n), ("dev", 3), ("test", 3)):
        rows = []
        for i in range(m):
            pcm = (rng.normal(size=int(rng.uniform(0.25, 0.6) * 16000)) * 3000).astype(np.int16)
            with wave.open(str(root / f"{split}{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(pcm.tobytes())
            units = rng.integers(0, CODES, size=int(rng.integers(3, 15)))
            rows.append({"id": f"{split}{i}", "src_audio": f"{split}{i}.wav",
                         "src_n_frames": (len(pcm) - 400) // 160 + 1,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump({
        "transforms": {"*": ["utterance_cmvn"], "_train": ["specaugment"]},
        "specaugment": {"freq_mask_N": 2, "freq_mask_F": 10, "time_mask_N": 2,
                        "time_mask_T": 10, "time_mask_p": 0.5}}))


def test_cli_chain_train_resume_s2st(tmp_path, capsys):
    """cli.train on 12 WAV utterances (scripts/s2ut_train.sh's flags at tiny
    widths, cg_prob 0.15, self-prompting, the side mask): 2 updates and a
    checkpoint, resumed to 4; then cli.s2st --params-npz on the step
    directory writes every utterance. The checkpoint's variables, loaded
    into JAX's NARS2UTModule, give the port's eval-mode encoder output
    within 1e-5."""
    _write_wav_corpus(tmp_path)
    save_dir = tmp_path / "ckpt"
    widths = ["--encoder-embed-dim", "32", "--encoder-ffn-embed-dim", "64",
              "--encoder-layers", "2", "--encoder-attention-heads", "2",
              "--decoder-layers", "2", "--decoder-attention-heads", "2",
              "--depthwise-conv-kernel-size", "5", "--conv-channels", "32"]
    args = [str(tmp_path), "--config-yaml", "config.yaml", "--cg-prob", "0.15",
            "--task", "speech_to_speech_fasttranslate", "--target-code-size", str(CODES),
            "--criterion", "nar_speech_to_unit", "--label-smoothing", "0.2",
            "--arch", "nar_s2ut_conformer", "--dropout", "0.1", "--train-subset", "train",
            "--valid-subset", "dev", "--save-dir", str(save_dir), "--keep-best-checkpoints",
            "5", "--best-checkpoint-metric", "loss", "--keep-last-epochs", "5", "--lr", "5e-4",
            "--lr-scheduler", "inverse_sqrt", "--warmup-init-lr", "1e-7", "--warmup-updates",
            "4", "--adam-betas", "(0.9,0.98)", "--clip-norm", "10.0", "--max-update", "2",
            "--max-tokens", "200", "--max-target-positions", "1024", "--seed", "42",
            "--prng-impl", "rbg", "--validate-interval", "5", "--save-interval", "5",
            "--dtype", "float32", "--use-sp", "--use-side", "--log-interval", "1", "--cpu",
            *widths]
    assert train_cli.main(args) == 0
    log = capsys.readouterr().err
    assert "epoch 1 | step 2 |" in log and "saved checkpoint at step 2" in log
    assert "valid |" in log and "loss_length" in log
    resume = args[:args.index("--max-update") + 1] + ["4"] + args[args.index("--max-update") + 2:]
    assert train_cli.main(resume) == 0
    log = capsys.readouterr().err
    assert "resumed from step 2" in log and "saved checkpoint at step 4" in log
    step_dir = save_dir / "step_000000004"
    variables = load_variables(str(step_dir))
    assert set(variables) == {"params", "batch_stats"}

    voc_cfg = dict(num_embeddings=CODES, embedding_dim=8, upsample_rates=[4, 2],
                   upsample_kernel_sizes=[8, 4], upsample_initial_channel=16,
                   resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]])
    torch.manual_seed(1)
    voc = CodeHiFiGANVocoder.from_config(voc_cfg, device="cpu")
    save_npz(str(tmp_path / "voc.npz"), to_jax_variables(voc.module))
    (tmp_path / "voc.json").write_text(json.dumps(voc_cfg))
    out = tmp_path / "wavs"
    assert s2st_cli.main([
        str(tmp_path), "--cpu", "--params-npz", str(step_dir), "--vocoder-npz",
        str(tmp_path / "voc.npz"), "--vocoder-cfg", str(tmp_path / "voc.json"),
        "--results-path", str(out), "--gen-subset", "test", "--batch-size", "2",
        "--target-code-size", str(CODES), *widths, "--max-target-positions", "16",
        "--iter-decode-max-iter", "3"]) == 0
    lines = (out / "s2st-test.unit").read_text().splitlines()
    assert sorted(line.split("|")[0] for line in lines) == ["test0", "test1", "test2"]
    assert all((out / f"test{i}_pred.wav").exists() for i in range(3))

    model = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, **NAR), variables).eval()
    src = np.random.default_rng(2).normal(size=(2, 64, 80)).astype(np.float32)
    lengths = np.asarray([64, 37], np.int32)
    with torch.no_grad():
        enc, _ = model.encode(torch.from_numpy(src), torch.from_numpy(lengths))
    ref, _ = JNARS2UTModule(vocab_size=VOCAB, **NAR).apply(
        variables, src, lengths, method=lambda m, s, n: m.encode(s, n))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref), rtol=FWD_TOL, atol=FWD_TOL)


# the flags ported since (error None) and the module each gives the model
PORTED_HEADS = {"--multitask-config-yaml": "mt_letters_ctc",
                "--target-speaker-embed": "spk_emb_proj", "--multitask-ctc-vocab": "ctc_proj",
                "--encoder-remat": "encoder"}


@pytest.mark.parametrize("extra, error", [
    (["--encoder-remat"], None), (["--quant-int8", "true"], None),
    (["--multitask-config-yaml", "mt.yaml"], None),
    (["--target-speaker-embed"], None),
    (["--multitask-ctc-vocab", "100"], None),
    (["--attn-type", "abs"], ValueError), (["--arch", "nar_transformer"], SystemExit),
    (["--ema-decay", "0.999"], None), (["--find-unused-parameters"], SystemExit),
    (["--use-bmuf"], None)])
def test_cli_flags_not_ported_raise(tmp_path, extra, error):
    """The NAR features the port leaves out raise by name, an arch or attention
    other than the recipes' is refused, and an unknown flag is an error;
    `--encoder-remat false` and the arch defaults parse. The multitask, CTC,
    target-speaker and encoder-remat flags (error None) parse and reach the
    model: the task builds it with their head, or a rematerializing
    encoder; --ema-decay (ported since) reaches the trainer's EMA,
    --quant-int8 (ported since) gives the model its int8 sites, and
    --use-bmuf (ported since) wraps the trainer's optimizer in BMUF."""
    base = [str(tmp_path), "--task", "speech_to_speech_fasttranslate", "--max-update", "1"]
    if error is None:
        (tmp_path / "dict.txt").write_text("a 1\nb 1\n")
        (tmp_path / "mt.yaml").write_text(yaml.safe_dump(
            {"letters": {"decoder_type": "ctc", "dict": "dict.txt", "encoder_layer": 1}}))
        args = train_cli.parse_args(base + extra + [
            "--target-code-size", str(CODES), "--encoder-embed-dim", "32",
            "--encoder-ffn-embed-dim", "64", "--encoder-layers", "2",
            "--encoder-attention-heads", "2", "--decoder-layers", "1",
            "--decoder-attention-heads", "2", "--conv-channels", "32"])
        model = TASKS[args.task](args).build_model()
        if extra[0] in ("--ema-decay", "--use-bmuf"):
            trainer = Trainer(train_cli.trainer_config(args), model,
                              TASKS[args.task](args).build_criterion())
            if extra[0] == "--ema-decay":
                assert trainer.ema is not None and trainer.ema.decay == 0.999
            else:
                assert isinstance(trainer.optimizer.transform, Bmuf)
        elif extra[0] == "--quant-int8":
            assert len(quant_sites(model)) > 0
        else:
            assert isinstance(getattr(model, PORTED_HEADS[extra[0]]), torch.nn.Module)
        assert model.encoder.remat is (extra[0] == "--encoder-remat")
    else:
        with pytest.raises(error):
            train_cli.parse_args(base + extra)
    args = train_cli.parse_args(base + ["--encoder-remat", "false", "--arch",
                                        "nar_s2ut_conformer_fisher"])
    assert args.encoder_remat is False
    assert (args.encoder_embed_dim, args.encoder_attention_heads, args.decoder_embed_dim,
            args.encoder_layers, args.dropout) == (256, 4, 256, 12, 0.1)
    assert args.tgt_feat_dir is None and args.config_yaml == "config.yaml"
    with pytest.raises(SystemExit):  # the main-path stages still need their features
        train_cli.parse_args(["data", "--task", "speech_decoder", "--max-update", "1"])


class _FirstBatch(Exception):
    """Raised by a recording train step to stop a CLI after its first batch."""


def test_cli_first_batch_matches_jax_cli(tmp_path, monkeypatch):
    """From one seed and corpus (SpecAugment on train), the port's cli.train
    and JAX's hand their trainers the same first batch: JAX draws an example
    item (`dataset[0]`) before training, which advances the dataset's
    SpecAugment generator, and the port draws it too. Each CLI's step
    records its batch and stops; JAX's model is not initialized (the first
    batch does not depend on it)."""
    from diffnorm_tpu.cli import train as jtrain_cli
    from diffnorm_tpu.cli.args import parse_args as jparse_args

    _write_wav_corpus(tmp_path)
    args = [str(tmp_path), "--config-yaml", "config.yaml", "--task",
            "speech_to_speech_fasttranslate", "--target-code-size", str(CODES),
            "--criterion", "nar_speech_to_unit", "--arch", "nar_s2ut_conformer",
            "--max-update", "2", "--max-tokens", "200", "--seed", "42", "--cpu",
            "--encoder-embed-dim", "32", "--encoder-ffn-embed-dim", "64",
            "--encoder-layers", "2", "--encoder-attention-heads", "2",
            "--decoder-layers", "2", "--decoder-attention-heads", "2",
            "--depthwise-conv-kernel-size", "5", "--conv-channels", "32"]
    seen = {}

    def port_step(self, batches):
        seen["port"] = np.asarray(batches[0]["src_tokens"])
        raise _FirstBatch

    def jax_step(self, state, batches, rng):
        seen["jax"] = np.asarray(batches[0]["src_tokens"])
        raise _FirstBatch

    monkeypatch.setattr(Trainer, "train_step", port_step)
    monkeypatch.setattr(JTrainer, "train_step", jax_step)
    monkeypatch.setattr(JTrainer, "init_state",
                        lambda self, rng, example: types.SimpleNamespace(params={}, step=0))
    with pytest.raises(_FirstBatch):
        train_cli.main(args + ["--save-dir", str(tmp_path / "port")])
    with pytest.raises(_FirstBatch):
        jtrain_cli.main(jparse_args(args + ["--save-dir", str(tmp_path / "jax")]))
    assert seen["port"].shape == seen["jax"].shape
    np.testing.assert_array_equal(seen["port"], seen["jax"])
