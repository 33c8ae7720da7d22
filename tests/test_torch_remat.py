"""`encoder_remat` in the port (each conformer layer recomputed in the
backward through torch.utils.checkpoint, JAX's nn.remat) on the CPU,
float32, at tests/test_torch_nar_train.py's tiny widths: with dropout on,
an update with remat leaves the loss, the gradients, the BatchNorm running
statistics and every generator's state equal to one without (the recompute
replays the forward's dropout masks and does not update the statistics a
second time); and the port's remat updates follow JAX's Trainer with
`encoder_remat` at the tolerances test_torch_nar_train.py uses."""

import jax
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config, make_trainer_config
from diffnorm_tpu.criterions.nar_loss import NARSpeechToUnitLoss as JNARLoss
from diffnorm_tpu.parallel.mesh import make_mesh
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.train.trainer import Trainer as JTrainer
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
from diffnorm_tpu_torch.models.conformer import BatchNorm, ConformerLayer
from diffnorm_tpu_torch.models.layers import set_dropout_generator
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.train.trainer import GENERATORS, Trainer
from diffnorm_tpu_torch.weights import to_jax_variables
from tests.test_torch_nar_train import (
    BETAS,
    CLIP,
    EPS,
    KEY_BIASES,
    LR,
    NAR,
    NAR_CFG,
    PARAM_TOL,
    TRAJ_RTOL,
    VOCAB,
    WARMUP,
    WARMUP_INIT,
    _assert_trees_close,
    _batch,
    _port,
    _torch,
    _trainer_cfg,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

DROPOUT = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)


def _model(remat, **kw):
    torch.manual_seed(0)
    return NARS2UTModule(vocab_size=VOCAB, encoder_remat=remat, **NAR, **kw)


def _count_layer_forwards(model):
    """A list that grows by one each time a conformer layer starts (its
    first sublayer runs: the recompute stops once it has what the backward
    needs, so the layer's own forward hook does not fire for it)."""
    calls = []
    for m in model.encoder.modules():
        if isinstance(m, ConformerLayer):
            m.ffn1.register_forward_hook(lambda *_: calls.append(1))
    return calls


def test_remat_gradients_equal_without_remat():
    """One training forward and backward with dropout 0.1 on every site: the
    loss and every gradient are equal with remat and without, each layer
    runs twice with remat (the forward and its recompute), the dropout
    generator ends in the same state and the BatchNorm running statistics
    took one update."""
    tb = _torch(_batch(3))
    out = {}
    for remat in (False, True):
        model = _model(remat, **DROPOUT).train()
        gen = torch.Generator().manual_seed(5)
        set_dropout_generator(model, gen)
        calls = _count_layer_forwards(model)
        loss, _ = NARSpeechToUnitLoss(0.2)(model, tb, generator=gen)
        n_forward = len(calls)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        stats = [b.clone() for m in model.modules() if isinstance(m, BatchNorm)
                 for b in (m.running_mean, m.running_var)]
        out[remat] = (loss.detach(), grads, stats, gen.get_state(), n_forward, len(calls))
    (l0, g0, s0, r0, f0, c0), (l1, g1, s1, r1, f1, c1) = out[False], out[True]
    assert (f0, c0) == (NAR["encoder_layers"],) * 2
    assert (f1, c1) == (NAR["encoder_layers"], 2 * NAR["encoder_layers"])
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert torch.equal(r0, r1)
    # the statistics moved once from (0, 1): 0.9 * 0 + 0.1 * mean
    assert not torch.equal(s1[0], torch.zeros_like(s1[0]))


def test_remat_updates_equal_without_remat():
    """Two Trainer updates of update_freq 2 with dropout 0.1, CG drops and
    self-prompting: the metrics, the parameters, the BatchNorm statistics
    and the dropout, CG and SP generators' states are equal with remat and
    without; validation (no gradient) does not recompute."""
    micros = [_batch(20 + k, lengths=((64, 41, 23), (50, 50, 12))[k % 2],
                     tgt_lengths=((20, 1, 11), (9, 16, 3))[k % 2]) for k in range(4)]
    runs = {}
    for remat in (False, True):
        model = _model(remat, cg_prob=0.3, use_sp=True, **DROPOUT)
        trainer = Trainer(_trainer_cfg(), model, NARSpeechToUnitLoss(0.2))
        mets = [trainer.train_step(micros[2 * u:2 * u + 2]) for u in range(2)]
        calls = _count_layer_forwards(trainer.model)
        valid = trainer.valid_step(micros[0], torch.Generator().manual_seed(0))
        states = [getattr(trainer, name).get_state() for name in GENERATORS]
        runs[remat] = (mets, to_jax_variables(model), states, valid, len(calls))
    (m0, v0, g0, val0, c0), (m1, v1, g1, val1, c1) = runs[False], runs[True]
    assert m0 == m1 and val0 == val1
    assert c0 == c1 == NAR["encoder_layers"]
    for col in ("params", "batch_stats"):
        _assert_trees_close(v1[col], v0[col], 0.0, col)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _jax_remat_trainer(micros):
    cfg = Config(arch="nar_s2ut_conformer", criterion="nar_speech_to_unit", dropout=0.0,
                 label_smoothing=0.2, lr=LR, lr_scheduler="inverse_sqrt",
                 warmup_updates=WARMUP, warmup_init_lr=WARMUP_INIT, adam_betas=BETAS,
                 adam_eps=EPS, clip_norm=CLIP, update_freq=1, encoder_remat=True, **NAR_CFG)
    task = JTASKS.get("speech_to_speech_fasttranslate").setup_task(cfg)
    jmodel = task.build_model()
    assert jmodel.module.encoder_remat
    jtrainer = JTrainer(make_trainer_config(cfg), task, jmodel, JNARLoss(cfg, task),
                        mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    return jtrainer, jtrainer.init_state(jax.random.PRNGKey(0), micros[0])


def test_remat_updates_match_jax_trainer_with_encoder_remat():
    """Three float32 updates (dropout 0) of JAX's Trainer with
    `encoder_remat` and of the port's with it, from one initialization: per
    update the loss and gradient norm within 1e-4 relative, the final
    parameters and BatchNorm statistics within 1e-4 of each leaf's scale
    (the key projections' biases apart, as test_torch_nar_train.py)."""
    micros = [_batch(60 + k) for k in range(3)]
    jtrainer, state = _jax_remat_trainer(micros)
    init = {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.model_state["batch_stats"])}
    model = _port(init, encoder_remat=True)
    trainer = Trainer(_trainer_cfg(), model, NARSpeechToUnitLoss(0.2))
    calls = _count_layer_forwards(trainer.model)
    for u, micro in enumerate(micros):
        state, ref = jtrainer.train_step(state, [micro], jax.random.PRNGKey(u))
        got = trainer.train_step([micro])
        for key in ("loss", "gnorm"):
            assert got[key] == pytest.approx(ref[key], rel=TRAJ_RTOL), key
    assert len(calls) == 2 * NAR["encoder_layers"] * len(micros)
    variables = to_jax_variables(model)
    _assert_trees_close(variables["params"], jax.device_get(state.params), PARAM_TOL, "params",
                        skip=KEY_BIASES)
    _assert_trees_close(variables["batch_stats"],
                        jax.device_get(state.model_state["batch_stats"]), PARAM_TOL, "stats")


def test_cli_encoder_remat_reaches_the_conformer(tmp_path):
    """`cli.train --encoder-remat` (alone or `true`) builds the task's model
    with a rematerializing encoder; `false` and its absence do not."""
    base = [str(tmp_path), "--task", "speech_to_speech_fasttranslate", "--max-update", "1",
            "--target-code-size", "16", "--encoder-embed-dim", "32",
            "--encoder-ffn-embed-dim", "64", "--encoder-layers", "1",
            "--encoder-attention-heads", "2", "--decoder-layers", "1",
            "--decoder-attention-heads", "2", "--conv-channels", "32"]
    for extra, remat in (([], False), (["--encoder-remat"], True),
                         (["--encoder-remat", "true"], True), (["--encoder-remat", "false"], False)):
        args = train_cli.parse_args(base + extra)
        assert TASKS[args.task](args).build_model().encoder.remat is remat
