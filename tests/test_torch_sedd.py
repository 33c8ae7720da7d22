"""SEDD in the port against the JAX package on the CPU, float32, at tiny
widths: the six math functions of the absorbing graph within 1e-6 (MATH_TOL),
the score network's log-scores and the training forward's loss parts on
JAX's own draws within 1e-5 (FWD_TOL), sedd_loss within 1e-5, the reverse
sampler and the NAT-canvas refinement on JAX's Gumbel uniforms token for
token, the times' float32 linspace bit for bit, the sedd_absorb arch, and
cli.train -> cli.validate against the in-process validation.

JAX draws its times, its perturbation's uniforms and each sampler step's
Gumbel uniforms inside its functions. The tests draw the same numbers from
the same keys, split as JAX splits them, and hand them to the port's seams
(`t`, `u`, `uniforms`, the batch's inject_times / inject_mask_u). The
port's weights are its seeded init, perturbed, checked against JAX's init
traced with `jax.eval_shape` by name and shape."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.sedd_loss import SEDDLoss as JSEDDLoss
from diffnorm_tpu.models import sedd as jsedd
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.sedd_loss import SEDDLoss
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.models import sedd
from diffnorm_tpu_torch.models.unit_lm import UnitLMModule
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_variables, to_jax_variables
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

MATH_TOL, FWD_TOL = 1e-6, 1e-5
CODES = 12  # units; the vocabulary is CODES + 4, MASK one more
TINY = dict(sedd_dim=32, sedd_depth=2, sedd_heads=2)


def _perturbed(tree, rng):
    """Every leaf moved by N(0, 0.1): biases away from 0, the FiLM
    projections and the output from their init."""
    return {k: _perturbed(v, rng) if isinstance(v, dict)
            else np.asarray(v, np.float32) + rng.normal(scale=0.1, size=np.shape(v))
            .astype(np.float32) for k, v in tree.items()}


def sedd_args(root, task="sedd", *extra):
    return train_cli.parse_args([str(root), "--task", task, "--max-update", "2",
                                 "--target-code-size", str(CODES), "--cpu",
                                 *(f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()),
                                 *extra])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(the port's task, its model in eval mode, JAX's module, variables)."""
    args = sedd_args(tmp_path_factory.mktemp("sedd"))
    task = TASKS[args.task](args)
    jtask = JTASKS.get("sedd").setup_task(Config(task="sedd", arch="sedd_absorb",
                                                 target_code_size=CODES, **TINY))
    jm = jtask.build_model().module
    batch = task.dummy_batch(3, 10)
    valid = np.arange(10)[None, :] < batch["target_lengths"][:, None]
    key = jax.random.PRNGKey(0)
    want = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                          batch["target_unit"], valid, key))
    torch.manual_seed(0)
    tree = to_jax_variables(task.build_model())
    assert ({k: tuple(np.shape(v)) for k, v in flatten_tree(tree).items()}
            == {k: tuple(v.shape) for k, v in flatten_tree(want).items()})
    variables = {"params": _perturbed(tree["params"], np.random.default_rng(1))}
    model = from_jax_variables(task.build_model(), variables).eval()
    return task, model, jm, variables


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def test_math_functions_match_jax():
    rng = np.random.default_rng(2)
    b, t, v = 3, 7, CODES + 5
    mask_id = v - 1
    ts = rng.uniform(0.01, 1.0, b).astype(np.float32)
    log_score = rng.normal(size=(b, t, v)).astype(np.float32)
    x_t = rng.integers(0, v, (b, t)).astype(np.int32)
    x_t[:, ::2] = mask_id
    x0 = rng.integers(4, mask_id, (b, t)).astype(np.int32)
    dsigma = rng.uniform(0.01, 0.5, b).astype(np.float32)
    u = rng.uniform(size=(b, t, v)).astype(np.float32)
    T = torch.from_numpy
    for got, want in zip(sedd.loglinear_sigma(T(ts)), jsedd.loglinear_sigma(jnp.asarray(ts))):
        _close(got, want, MATH_TOL)
    sigma = np.array(jsedd.loglinear_sigma(jnp.asarray(ts))[0])
    _close(sedd.score_entropy_absorb(T(log_score), T(sigma), T(x_t), T(x0), mask_id),
           jsedd.score_entropy_absorb(log_score, sigma, x_t, x0, mask_id), MATH_TOL)
    score = np.exp(log_score)
    _close(sedd.staggered_score_absorb(T(score), T(dsigma)),
           jsedd.staggered_score_absorb(score, dsigma), MATH_TOL)
    _close(sedd.transp_transition_absorb(T(x_t), T(dsigma), v),
           jsedd.transp_transition_absorb(x_t, dsigma, v), MATH_TOL)
    for truncate in (False, True):
        probs = sedd.analytic_update_probs(T(log_score), T(x_t), T(dsigma), mask_id, truncate)
        _close(probs, jsedd.analytic_update_probs(log_score, x_t, dsigma, mask_id, truncate),
               MATH_TOL)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, probs.shape))
    np.testing.assert_array_equal(sedd.sample_categorical(probs, T(u)).numpy(),
                                  np.asarray(jsedd.sample_categorical(jnp.asarray(probs), key)))
    np.testing.assert_array_equal(sedd.jax_linspace(1.0, 1e-5, 65).numpy(),
                                  np.asarray(jnp.linspace(1.0, 1e-5, 65)))


def _training_draws(key, b, shape):
    """JAX's times and perturbation uniforms of SEDDModule.__call__(rng=key)."""
    r_t, r_p = jax.random.split(key)
    t = (1.0 - 1e-3) * jax.random.uniform(r_t, (b,)) + 1e-3
    return torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(
        jax.random.uniform(r_p, shape)))


def test_score_model_and_loss_parts_match_jax(built):
    task, model, jm, variables = built
    batch = task.dummy_batch(3, 10)
    tokens, lengths = batch["target_unit"], batch["target_lengths"]
    valid = np.arange(tokens.shape[1])[None, :] < lengths[:, None]
    rng = np.random.default_rng(4)
    x_t = np.where(rng.random(tokens.shape) < 0.5, model.mask_id, tokens).astype(np.int32)
    sigma = rng.uniform(0.05, 3.0, 3).astype(np.float32)
    got = model.log_score(torch.from_numpy(x_t), torch.from_numpy(sigma), torch.from_numpy(valid))
    want = jm.apply(variables, x_t, sigma, valid, method=jsedd.SEDDModule.score)
    _close(got.detach(), want, FWD_TOL)

    key = jax.random.PRNGKey(5)
    t, u = _training_draws(key, 3, tokens.shape)
    with torch.no_grad():
        out = model(torch.from_numpy(tokens), torch.from_numpy(valid), t=t, u=u)
    ref = jm.apply(variables, tokens, valid, key, deterministic=True)
    np.testing.assert_array_equal(out["x_t"].numpy(), np.asarray(ref["x_t"]))
    np.testing.assert_array_equal(out["n_masked"].numpy(), np.asarray(ref["n_masked"]))
    assert out["n_masked"].sum() > 0
    for k in ("loss_per_pos", "weight"):
        _close(out[k], ref[k], FWD_TOL)


def test_sedd_loss_matches_jax(built):
    task, model, jm, variables = built
    batch = task.dummy_batch(4, 12)
    key = jax.random.PRNGKey(6)
    r_model, _ = jax.random.split(key)
    t, u = _training_draws(r_model, 4, batch["target_unit"].shape)
    loss, mets = SEDDLoss()(model, {"target_unit": torch.from_numpy(batch["target_unit"]),
                                    "target_lengths": torch.from_numpy(batch["target_lengths"]),
                                    "inject_times": t, "inject_mask_u": u})
    jloss, jmets, _ = JSEDDLoss()(jm, variables, batch, key, train=False)
    _close(loss.detach(), jloss, FWD_TOL)
    _close(mets["n_masked"], jmets["n_masked"], FWD_TOL)
    assert (int(mets["ntokens"]), mets["sample_size"]) == (int(jmets["ntokens"]), 4)


def _gumbel_draws(key, steps, shape):
    """Each sampler step's uniforms, from JAX's split chain."""
    out = []
    for _ in range(steps):
        key, r = jax.random.split(key)
        out.append(torch.from_numpy(np.asarray(jax.random.uniform(r, shape))))
    return out


def test_sampler_and_refine_match_jax(built):
    task, model, jm, variables = built
    holder = types.SimpleNamespace(module=jm)
    b, t, steps, v = 3, 9, 6, model.mask_id + 1
    valid = np.ones((b, t), bool)
    valid[2, 5:] = False
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsedd.sedd_sample(holder, variables, b, t, key, steps=steps,
                                        valid_mask=jnp.asarray(valid)))
    got = sedd.sedd_sample(model, b, t, steps=steps, valid_mask=torch.from_numpy(valid),
                           uniforms=_gumbel_draws(key, steps, (b, t, v)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got < model.mask_id).all()  # every MASK resolved

    rng = np.random.default_rng(8)
    canvas = rng.integers(4, 4 + CODES, (b, t)).astype(np.int32)
    canvas[rng.random((b, t)) < 0.4] = sedd.UNK
    canvas[0, :3] = sedd.UNK
    key = jax.random.PRNGKey(9)
    want = np.asarray(jsedd.sedd_refine(holder, variables, jnp.asarray(canvas),
                                        jnp.asarray(valid), key, steps=steps))
    got = sedd.sedd_refine(model, torch.from_numpy(canvas), torch.from_numpy(valid),
                           steps=steps, uniforms=_gumbel_draws(key, steps, (b, t, v)))
    np.testing.assert_array_equal(got.numpy(), want)
    unmasked = canvas != sedd.UNK
    np.testing.assert_array_equal(got.numpy()[unmasked], canvas[unmasked])
    assert (got.numpy()[~unmasked] != sedd.UNK).any()


def test_arch_and_dummy_batch_match_jax(tmp_path):
    args = train_cli.parse_args([str(tmp_path), "--task", "sedd", "--max-update", "1",
                                 "--cpu"])
    assert (args.arch, args.criterion, args.sedd_dim, args.sedd_depth, args.sedd_heads,
            args.target_code_size) == ("sedd_absorb", "sedd_loss", 512, 8, 8, 1000)
    model = TASKS["sedd"](args).build_model()
    assert model.mask_id == 1004 and model.score.out.out_features == 1005
    assert model.score.transformer.layer("attn", 0).dropout == 0.1  # JAX's default
    # the SEDD tasks also take the unit LM, with its criterion (JAX's eval_lm
    # scores the unit LM under sedd_lm)
    lm_args = train_cli.parse_args([str(tmp_path), "--task", "sedd", "--arch", "transformer_lm",
                                    "--max-update", "1"])
    assert lm_args.criterion == "lm_cross_entropy"
    assert isinstance(TASKS["sedd"](lm_args).build_model(), UnitLMModule)
    with pytest.raises(SystemExit):
        train_cli.parse_args([str(tmp_path), "--task", "sedd", "--arch", "transformer_lm",
                              "--criterion", "sedd_loss", "--max-update", "1"])
    task = TASKS["dummy_sedd"](sedd_args(tmp_path, "sedd", "--batch-size", "3"))
    jtask = JTASKS.get("dummy_sedd").setup_task(Config(task="dummy_sedd",
                                                       target_code_size=CODES, batch_size=3))
    got, want = task.dataset("train")[0], next(iter(jtask.dataset("train")))
    for k in ("target_unit", "target_lengths"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(task.dataset("train")) == 8


def write_unit_corpus(root, seed=0, splits=(("train", 12), ("dev", 4), ("test", 5))):
    """{split}.tsv translation manifests whose targets are unit strings of
    5-30 units of CODES."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        rows = []
        for i in range(n):
            units = rng.integers(0, CODES, size=int(rng.integers(5, 31)))
            rows.append({"id": f"{split}{i}", "src_audio": "none.npy", "src_n_frames": 10,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    return root


def test_cli_train_then_validate(tmp_path):
    """cli.train --task sedd_lm (2 updates, blocks of 16) then cli.validate
    on its step directory: the validation loss equals the in-process valid
    step's on the same weights (generator seeded 0)."""
    from diffnorm_tpu_torch.cli import validate
    from diffnorm_tpu_torch.train import metrics as metrics_mod
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    data = write_unit_corpus(tmp_path)
    flags = [str(data), "--task", "sedd_lm", "--cpu", "--target-code-size", str(CODES),
             *(f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()),
             "--tokens-per-sample", "16", "--sample-break-mode", "none"]
    assert train_cli.main(flags + ["--max-update", "2", "--max-tokens", "64",
                                   "--save-dir", str(tmp_path / "ck"),
                                   "--log-interval", "1"]) == 0
    step = str(tmp_path / "ck" / "step_000000002")
    args = validate.parse_args(flags + ["--path", step])
    vals = validate.validate(args)

    task = TASKS["sedd_lm"](args)
    model = from_jax_variables(task.build_model(), load_variables(step))
    trainer = Trainer(TrainerConfig(), model, task.build_criterion())
    ds = task.dataset("dev")
    assert ds.sizes.tolist() == [16] * (len(ds) - 1) + [ds.sizes[-1]]
    generator = torch.Generator().manual_seed(0)
    with metrics_mod.aggregate() as agg:
        for b in train_cli.iterate_valid(ds):
            trainer.valid_step(b, generator)
    want = agg.get_smoothed_values()
    assert np.isfinite(vals["loss"]) and vals["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert vals["ntokens"] == sum(ds.sizes)
