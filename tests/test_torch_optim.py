"""The port's optimizers, LR schedules and EMA (diffnorm_tpu_torch/train/
{optimizers,lr_schedules}.py) against JAX's build_optimizer /
build_lr_schedule / EMA: 10 updates of seeded gradients on a small
parameter tree (a factored 130 x 140 kernel, a conv kernel, biases, and a
`w2v_model` subtree for freeze_finetune and composite groups), the
parameters held within 1e-6 relative in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from diffnorm_tpu.config import Config
from diffnorm_tpu.train.lr_schedules import build_lr_schedule as jbuild_lr_schedule
from diffnorm_tpu.train.optimizers import EMA as JEMA
from diffnorm_tpu.train.optimizers import build_optimizer as jbuild_optimizer
from diffnorm_tpu_torch.train.lr_schedules import build_lr_schedule
from diffnorm_tpu_torch.train.optimizers import EMA, build_optimizer
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_params, to_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

STEPS, REL = 10, 1e-6


class Tree(nn.Module):
    """{"enc": Dense 130 -> 140, "dec": Conv 4 -> 6 (k 3), "w2v_model":
    Dense 6 -> 5} in flax paths."""

    def __init__(self):
        super().__init__()
        self.enc = nn.Linear(130, 140)
        self.dec = nn.Conv1d(4, 6, 3)
        self.w2v_model = nn.Linear(6, 5)


def _setup(seed=0):
    """(JAX params, per-step JAX gradients, the port's module with the same
    params)."""
    rng = np.random.default_rng(seed)
    model = Tree()
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.5, to_jax_params(model))
    from_jax_params(model, params)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), params)
        for _ in range(STEPS)]
    return params, grads, model


def _port_grads(model, jgrads):
    """A JAX gradient tree in the port's parameter order and layout."""
    probe = Tree()
    from_jax_params(probe, jgrads)
    return [p.detach().clone() for p in probe.parameters()]


def _run_jax(cfg, params, grads, clip=0.0, epoch_events=(), ema=0.0):
    sched = jbuild_lr_schedule(cfg)
    tx = jbuild_optimizer(cfg, sched, clip)
    state = tx.init(params)
    host = sched if getattr(sched, "host_driven", False) else None
    ema_tx = JEMA(ema) if ema else None
    ema_p = ema_tx.init(params) if ema else None
    lrs = []
    for step, g in enumerate(grads):
        updates, state = tx.update(g, state, params)
        if host is not None:
            lr = host.step_update(step)
            lrs.append(lr)
            updates = jax.tree_util.tree_map(lambda u: u * jnp.float32(lr), updates)
        params = optax.apply_updates(params, updates)
        if ema_tx is not None:
            ema_p = ema_tx.update(ema_p, params)
        if host is not None and step in dict(epoch_events):
            host.step_epoch(step, dict(epoch_events)[step])
    return params, ema_p, lrs


def _run_port(cfg, model, grads, clip=0.0, epoch_events=(), ema=0.0):
    sched = build_lr_schedule(cfg)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    opt = build_optimizer(cfg, sched, params, names, clip)
    averager = EMA(params, ema) if ema else None
    host = sched if getattr(sched, "host_driven", False) else None
    lrs = []
    for step, g in enumerate(grads):
        lr = host.step_update(step) if host is not None else None
        if lr is not None:
            lrs.append(lr)
        opt.step(_port_grads(model, g), lr)
        if averager is not None:
            averager.update(params)
        if host is not None and step in dict(epoch_events):
            host.step_epoch(step, dict(epoch_events)[step])
    return opt, averager, lrs


def _close(got_tree, want_tree):
    got, want = flatten_tree(got_tree), flatten_tree(want_tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, rtol=REL, atol=REL * np.abs(w).max(),
                                   err_msg="/".join(k))


GROUP_SCHEDULE = {"optimizer": "adamax", "lr_scheduler": "cosine", "lr": 2e-3,
                  "warmup_updates": 2, "max_updates": 10}
CASES = {
    "adam": dict(optimizer="adam", weight_decay=0.01, lr_scheduler="inverse_sqrt",
                 warmup_updates=3),
    "adamax": dict(optimizer="adamax", weight_decay=0.01, lr_scheduler="cosine",
                   warmup_updates=2, max_updates=10),
    "adamax_no_bias_correction": dict(optimizer="adamax", no_bias_correction=True,
                                      lr_scheduler="fixed"),
    "adadelta": dict(optimizer="adadelta", weight_decay=0.01, lr=1.0, lr_scheduler="fixed"),
    "lamb": dict(optimizer="lamb", weight_decay=0.01, lr_scheduler="polynomial_decay",
                 warmup_updates=2, max_updates=10, power=2.0),
    "nag": dict(optimizer="nag", weight_decay=0.01, lr_scheduler="step", lr_decay_period=3,
                lr_decay=0.5, warmup_updates=2),
    "adafactor": dict(optimizer="adafactor", weight_decay=0.01, lr_scheduler="tri_stage",
                      warmup_steps=2, hold_steps=2, decay_steps=4),
    "adafactor_pass_through": dict(optimizer="adafactor", lr_scheduler="pass_through"),
    "adagrad": dict(optimizer="adagrad", initial_accumulator_value=0.1, lr=1e-2,
                    lr_scheduler="triangular", max_lr=5e-2, lr_period_updates=4),
    "sgd_nesterov": dict(optimizer="sgd", momentum=0.9, nesterov=True, lr=1e-2,
                         lr_scheduler="fixed", warmup_updates=3, warmup_init_lr=1e-3),
    "sgd": dict(optimizer="sgd", lr=1e-2, lr_scheduler="fixed"),
    "composite": dict(optimizer="composite", lr_scheduler="inverse_sqrt", warmup_updates=3,
                      composite_groups={"w2v_model": "sgd", "dec": GROUP_SCHEDULE}),
    "composite_pass_through": dict(optimizer="composite", lr_scheduler="pass_through",
                                   composite_default="adagrad",
                                   composite_groups={"enc": GROUP_SCHEDULE}),
    "clip_loss_scale": dict(optimizer="adam", lr_scheduler="inverse_sqrt", warmup_updates=3,
                            loss_scale=8.0),
    "freeze_finetune": dict(optimizer="adam", weight_decay=0.01, lr_scheduler="inverse_sqrt",
                            warmup_updates=3, freeze_finetune_updates=4),
    "manual": dict(optimizer="adamax", lr_scheduler="manual", epoch2lr="{'1': 1e-3}",
                   update2lr="{'2-4': 5e-4, '7': 2e-4}"),
    "reduce_lr_on_plateau": dict(optimizer="adam", lr_scheduler="reduce_lr_on_plateau",
                                 warmup_updates=2, lr_shrink=0.5, lr_patience=0),
}
EPOCH_EVENTS = ((3, 1.0), (5, 1.5), (7, 0.5), (8, 0.9))


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(case):
    """Every optimizer under a schedule (and the clip, loss-scale, freeze,
    composite, pass_through and host-driven wrappers) over 10 updates: the
    parameters within 1e-6 relative of JAX's; host-driven schedules run
    the chain at unit lr and scale the updates, with the epoch hook fed
    validation losses between updates."""
    cfg = dict(CASES[case], lr=CASES[case].get("lr", 1e-3))
    params, grads, model = _setup()
    clip = 1.0 if case in ("clip_loss_scale", "adam") else 0.0
    if case == "clip_loss_scale":
        grads = [jax.tree_util.tree_map(lambda g: g * 8.0, g) for g in grads]
    events = EPOCH_EVENTS if case == "reduce_lr_on_plateau" else ()
    want, _, want_lrs = _run_jax(Config(**cfg), params, grads, clip, events)
    opt, _, lrs = _run_port(cfg, model, grads, clip, events)
    _close(to_jax_params(model), want)
    assert lrs == pytest.approx(want_lrs, rel=1e-12)
    assert opt.count == STEPS
    if case == "freeze_finetune":  # frozen for 4 updates, then trained
        start, _, probe = _setup()
        frozen = start["w2v_model"]
        _run_port(cfg, probe, grads[:4])
        for k, v in to_jax_params(probe)["w2v_model"].items():
            np.testing.assert_array_equal(v, frozen[k])
        assert not np.allclose(to_jax_params(model)["w2v_model"]["kernel"], frozen["kernel"])


def test_ema_matches_jax_and_the_state_resumes():
    """EMA at 0.9 after every update, as JAX's; the optimizer's and the
    EMA's state dicts carry a run over a break exactly."""
    cfg = dict(optimizer="adafactor", lr_scheduler="cosine", warmup_updates=2,
               max_updates=10, lr=1e-3)
    params, grads, model = _setup(1)
    _, want_ema, _ = _run_jax(Config(**cfg), params, grads, ema=0.9)
    _, averager, _ = _run_port(cfg, model, grads, ema=0.9)
    probe = Tree()
    for p, e in zip(probe.parameters(), averager.params):
        p.data.copy_(e)
    _close(to_jax_params(probe), want_ema)

    # 6 updates, a state-dict round trip into fresh objects, 4 more
    _, _, whole = _setup(1)
    _run_port(cfg, whole, grads, ema=0.9)
    _, _, split = _setup(1)
    names = [n for n, _ in split.named_parameters()]
    ps = list(split.parameters())
    opt, ema = build_optimizer(cfg, build_lr_schedule(cfg), ps, names), EMA(ps, 0.9)
    for g in grads[:6]:
        opt.step(_port_grads(split, g))
        ema.update(ps)
    opt_state, ema_state = opt.state_dict(), ema.state_dict()
    opt2, ema2 = build_optimizer(cfg, build_lr_schedule(cfg), ps, names), EMA(ps, 0.9)
    opt2.load_state_dict(opt_state)
    ema2.load_state_dict(ema_state)
    for g in grads[6:]:
        opt2.step(_port_grads(split, g))
        ema2.update(ps)
    for a, b in zip(split.parameters(), whole.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["inverse_sqrt", "fixed", "cosine", "polynomial_decay",
                                  "step", "triangular", "tri_stage", "pass_through"])
def test_schedule_matches_jax(name):
    """Each schedule's lr over 40 counts, at JAX's float32 precision (JAX
    computes the schedules in float32: 1e-6 of the peak lr absolute)."""
    cfg = dict(lr=1e-3, lr_scheduler=name, warmup_updates=5, warmup_init_lr=1e-5,
               max_updates=30, min_lr=1e-5, end_learning_rate=1e-5, power=2.0,
               lr_decay_period=7, lr_decay=0.5, max_lr=4e-3, lr_period_updates=12,
               lr_shrink=0.5, hold_steps=4, decay_steps=20)
    mine, theirs = build_lr_schedule(cfg), jbuild_lr_schedule(Config(**cfg))
    got = [mine(s) for s in range(40)]
    want = [float(theirs(s)) for s in range(40)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * cfg["lr"])
    assert getattr(mine, "pass_through", False) == (name == "pass_through")


def test_host_driven_hooks_lr_sequence():
    """manual and reduce_lr_on_plateau through step_update,
    step_begin_epoch and step_epoch give JAX's lr sequence, and their state
    dicts carry over (plateau's best, bad-epoch count, warmup)."""
    for cfg in (dict(lr_scheduler="manual", lr=1e-3, epoch2lr="{'1,2': 1e-3, '3-4': 4e-4}",
                     update2lr="{'5': 3e-4, '9': 1e-4}"),
                dict(lr_scheduler="reduce_lr_on_plateau", lr=1e-3, warmup_updates=3,
                     lr_shrink=0.5, lr_patience=1, lr_threshold=0.01)):
        mine, theirs = build_lr_schedule(cfg), jbuild_lr_schedule(Config(**cfg))
        seq, want = [], []
        losses = iter([2.0, 1.9, 1.95, 1.94, 1.99, 1.0])
        for epoch in range(1, 7):
            seq.append(mine.step_begin_epoch(epoch))
            want.append(theirs.step_begin_epoch(epoch))
            for u in range(3):
                n = (epoch - 1) * 3 + u
                seq.append(mine.step_update(n))
                want.append(theirs.step_update(n))
            loss = next(losses)
            seq.append(mine.step_epoch(epoch, loss))
            want.append(theirs.step_epoch(epoch, loss))
            if epoch == 3:  # a resume mid-run
                state = mine.state_dict()
                mine = build_lr_schedule(cfg)
                mine.load_state_dict(state)
        assert seq == pytest.approx(want, rel=1e-12), cfg["lr_scheduler"]
        assert len(set(seq)) > 2
    with pytest.raises(TypeError, match="host-driven"):
        build_lr_schedule(dict(lr_scheduler="manual"))(0)


@pytest.mark.parametrize("cfg, match", [
    (dict(optimizer="nag", lr_scheduler="manual"), "nag"),
    (dict(optimizer="nag", lr_scheduler="reduce_lr_on_plateau"), "nag"),
    (dict(optimizer="adam", lr_scheduler="pass_through"), "pass_through"),
    (dict(optimizer="composite", composite_groups={"enc": {"lr_scheduler": "manual"}}),
     "host-driven"),
])
def test_refusals_match_jax(cfg, match):
    """nag under a host-driven schedule, pass_through without an optimizer
    that owns its schedule, and a host-driven schedule inside a composite
    group are refused by both packages."""
    _, _, model = _setup()
    with pytest.raises(ValueError, match=match):
        jbuild_optimizer(Config(**cfg), jbuild_lr_schedule(Config(**cfg)))
    with pytest.raises(ValueError, match=match):
        build_optimizer(cfg, build_lr_schedule(cfg), list(model.parameters()),
                        [n for n, _ in model.named_parameters()])
