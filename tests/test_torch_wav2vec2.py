"""wav2vec 2.0 pretraining in the port against the JAX package on the CPU at
tiny widths: the Gumbel quantizer (eval codes, and the straight-through
training sample on JAX's own uniforms: forward and gradient within 1e-5),
the audio_pretraining task's batches (masked_pos, masked_valid, neg_idxs,
the mask budget and its defensive subsample; bit for bit), the Gumbel
temperature schedule, Wav2Vec2PretrainModule's contrastive logits (the
finite entries within 1e-5, the removed negatives at the same places), the
wav2vec criterion's loss and metrics (1e-5; a single loss weight serving
both extra losses) and the pretraining state's converter (bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.wav2vec_loss import Wav2VecLoss as JWav2VecLoss
from diffnorm_tpu.models import wav2vec2 as jw2v
from diffnorm_tpu.tasks.audio_pretrain_task import AudioPretrainingTask as JTask
from diffnorm_tpu.utils import convert_weights as jcw
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.wav2vec_loss import Wav2VecLoss
from diffnorm_tpu_torch.models.wav2vec2 import GumbelVectorQuantizer, Wav2Vec2PretrainModule
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.utils import convert_weights as cw
from diffnorm_tpu_torch.weights import flatten_tree
from tests.test_torch_hubert_pretrain import (
    CLI_TINY,
    SPEC,
    TINY,
    ZERO,
    fairseq_hubert_state,
    jtree,
    port_params,
    wav_batch,
    write_pretrain_corpus,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

W2V = dict(final_dim=16, latent_vars=6, latent_groups=2, dropout_features=0.0)


@pytest.mark.parametrize("combine_groups", [False, True], ids=["groups", "combined"])
def test_quantizer_matches_jax_on_its_uniforms(combine_groups):
    """Eval: the hard codes, the quantized vectors and both perplexities
    (weighted by the valid slots) within 1e-5. Training, on the uniforms
    JAX draws from its key: the straight-through sample's output and the
    gradient of a loss through it (the soft sample's) within 1e-5."""
    torch.manual_seed(2)
    q = GumbelVectorQuantizer(24, num_vars=5, groups=2, vq_dim=8, combine_groups=combine_groups)
    params = port_params(q, seed=2)
    jq = jw2v.GumbelVectorQuantizer(dim=24, num_vars=5, groups=2, vq_dim=8,
                                    combine_groups=combine_groups)
    x = np.random.default_rng(3).normal(size=(2, 7, 24)).astype(np.float32)
    valid = np.ones((2, 7), bool)
    valid[1, 5:] = False
    key = jax.random.PRNGKey(4)
    u = np.array(jax.random.uniform(key, (2, 7, 2, 5), jnp.float32,
                                      minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))
    w_out = np.random.default_rng(5).normal(size=(2, 7, 8)).astype(np.float32)
    for train in (False, True):
        def jfn(p, xx):
            out = jq.apply({"params": p}, xx, 1.5, valid=jnp.asarray(valid), train=train,
                           gumbel_rng=key if train else None)
            return jnp.sum(out["x"] * w_out), out

        (jl, jout), jgrad = jax.value_and_grad(jfn, argnums=1, has_aux=True)(
            jtree(params), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        out = q.train(train)(xt, 1.5, valid=torch.from_numpy(valid),
                             uniforms=torch.from_numpy(u))
        (out["x"] * torch.from_numpy(w_out)).sum().backward()
        np.testing.assert_array_equal(out["targets"].numpy(), np.asarray(jout["targets"]))
        np.testing.assert_allclose(out["x"].detach().numpy(), np.asarray(jout["x"]), atol=1e-5)
        for key_ in ("code_perplexity", "prob_perplexity"):
            np.testing.assert_allclose(out[key_].item(), float(jout[key_]), rtol=1e-5)
        assert out["num_vars"] == jout["num_vars"] == 10
        # eval's hard codes pass no gradient (JAX's zeros)
        grad = torch.zeros_like(xt) if xt.grad is None else xt.grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=1e-5)
        assert train == bool(grad.abs().sum() > 0)


def task_pair(root, **extra):
    values = {**CLI_TINY, "num_negatives": 5, **extra}
    args = train_cli.parse_args([str(root), "--task", "audio_pretraining", "--max-update", "1",
                                 *[f"--{k.replace('_', '-')}={v}" for k, v in values.items()]])
    jvalues = {**values, "conv_feature_layers": [list(t) for t in SPEC]}
    if "latent_temp" in jvalues:
        jvalues["latent_temp"] = list(args.latent_temp)
    return TASKS["audio_pretraining"](args), JTask(Config(task="audio_pretraining",
                                                          data=str(root), **jvalues))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_pretrain_corpus(tmp_path_factory.mktemp("w2v_data"))


@pytest.mark.parametrize("case", ["static", "uniform", "over_budget"])
def test_task_batches_match_jax(corpus, case):
    """audio_pretraining's prepare_batch on collated batches and its dummy
    batch from one generator seed: mask_indices, masked_pos,
    masked_valid, neg_idxs and gumbel_temp bit for bit, at two update
    counts. `over_budget` forces a budget of 3 slots: the defensive
    subsample, on the same generator."""
    extra = dict(mask_prob=0.5, mask_length=2, max_sample_size=2000, min_sample_size=1000)
    if case != "over_budget":
        extra["mask_selection"] = case
    task, jtask = task_pair(corpus, **extra)
    if case == "over_budget":
        task.mask_budget = lambda n: 3
        jtask.mask_budget = lambda n: 3
    jds, tds = jtask.dataset("train"), task.dataset("train")
    for step in (0, 3):
        task.set_num_updates(10_000 * step)
        jtask.set_num_updates(10_000 * step)
        want = jtask.prepare_batch(jds.collater([jds[0], jds[2], jds[3]]),
                                   np.random.default_rng(6))
        got = task.prepare_batch(tds.collater([tds[0], tds[2], tds[3]]),
                                 np.random.default_rng(6))
        dummies = task.dummy_batch(3, 2400), jtask.dummy_batch(3, 2400)
        for ours, theirs in ((got, want), dummies):
            assert sorted(ours) == sorted(theirs)
            for key, value in theirs.items():
                np.testing.assert_array_equal(ours[key], value, err_msg=key)
    if case == "over_budget":
        assert got["masked_valid"].all() and got["masked_pos"].shape[1] == 3
    else:
        assert (got["neg_idxs"] != np.arange(got["neg_idxs"].shape[1])[None, :, None]).all()


def test_temperature_schedule_matches_jax(corpus):
    """max(max_t * decay ** updates, min_t) through set_num_updates, the
    recipe's default and wav2vec2_large's (2, 0.1, 0.999995)."""
    for extra in ({}, {"latent_temp": "(2,0.1,0.999995)"}):
        task, jtask = task_pair(corpus, **extra)
        for n in (0, 1, 1000, 250_000, 10**7):
            task.set_num_updates(n)
            jtask.set_num_updates(n)
            assert task.gumbel_temp == jtask.gumbel_temp
    assert task.gumbel_temp == 0.1


LOSS_WEIGHTS = {"recipe": [0.1, 10.0], "single": [0.5]}
KEYS = ("src_tokens", "src_lengths", "mask_indices", "masked_pos", "masked_valid", "neg_idxs")


def prepared_batch(corpus):
    task, _ = task_pair(corpus, mask_prob=0.5, mask_length=2)
    wav, lengths = wav_batch(seed=9)
    return task.prepare_batch({"src_tokens": wav, "src_lengths": lengths},
                              np.random.default_rng(10))


@pytest.fixture(scope="module")
def w2v_run(corpus):
    """The port's model at TINY width with its params, a prepared batch, and
    one compiled JAX run on them: the eval forward and the criterion under
    each LOSS_WEIGHTS."""
    torch.manual_seed(3)
    model = Wav2Vec2PretrainModule(**W2V, **TINY, **ZERO)
    params = port_params(model, seed=3)
    batch = prepared_batch(corpus)
    jm = jw2v.Wav2Vec2PretrainModule(**W2V, **TINY, **ZERO)

    def run(p):
        out = jm.apply({"params": p}, *(jnp.asarray(batch[k]) for k in KEYS),
                       temp=batch["gumbel_temp"])
        crits = {name: JWav2VecLoss({"loss_weights": lw})(jm, {"params": p}, batch, None,
                                                         train=False)[:2]
                 for name, lw in LOSS_WEIGHTS.items()}
        return out, crits

    return model, batch, jax.device_get(jax.jit(run)(jtree(params)))


@pytest.mark.parametrize("weights", list(LOSS_WEIGHTS))
def test_contrastive_forward_and_criterion_match_jax(w2v_run, weights):
    """Eval forwards on a prepared batch: the [B, M, 1 + N] logits' -inf
    (a negative equal to its positive: 6 codes a group make them common)
    at JAX's places and the rest within 1e-5, features_pen and the
    perplexities within 1e-5; the wav2vec criterion's loss and metrics
    within 1e-5 (the recipe's weights, and a single one serving both extra
    losses)."""
    model, batch, (want, crits) = w2v_run
    model.eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.asarray(batch[k])) for k in KEYS),
                    temp=batch["gumbel_temp"])
    wl, gl = np.asarray(want["logits"]), got["logits"].numpy()
    np.testing.assert_array_equal(np.isfinite(gl), np.isfinite(wl))
    assert not np.isfinite(wl).all()
    np.testing.assert_allclose(gl[np.isfinite(gl)], wl[np.isfinite(wl)], atol=1e-5, rtol=1e-5)
    for key in ("features_pen", "prob_perplexity", "code_perplexity"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    jloss, jmet = crits[weights]
    with torch.no_grad():
        loss, met = Wav2VecLoss(LOSS_WEIGHTS[weights])(
            model, {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()})
    assert sorted(met) == sorted(jmet)
    for key, value in jmet.items():
        np.testing.assert_allclose(float(met[key]), float(value), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_training_forward_draws_and_backward(corpus):
    """A training forward (the Gumbel sample from the generator the trainer
    sets, the recipe's dropouts) and its backward: finite loss, gradients
    into every trainable leaf but the extractor's scaled ones, seeded
    draws reproducible."""
    from diffnorm_tpu_torch.models.layers import set_dropout_generator

    torch.manual_seed(4)
    model = Wav2Vec2PretrainModule(**{**W2V, "dropout_features": 0.1}, **TINY)
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in prepared_batch(corpus).items()}
    losses = []
    for seed in (0, 0):
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        model.zero_grad()
        loss, _ = Wav2VecLoss()(model.train(), batch)
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert model.quantizer.weight_proj.weight.grad.abs().sum() > 0
    assert model.encoder.feature_extractor.conv_0.weight.grad.abs().sum() > 0


def test_pretrain_state_converter_matches_jax():
    g = torch.Generator().manual_seed(5)
    sd = {k: v for k, v in fairseq_hubert_state(seed=1).items() if k != "label_embs_concat"}
    sd["quantizer.vars"] = torch.rand(1, 12, 8, generator=g)
    sd["quantizer.weight_proj.weight"] = torch.randn(12, 32, generator=g)
    sd["quantizer.weight_proj.bias"] = torch.randn(12, generator=g)
    sd["project_q.weight"], sd["project_q.bias"] = (torch.randn(16, 16, generator=g),
                                                    torch.randn(16, generator=g))
    got = flatten_tree(cw.convert_wav2vec2_pretrain_state(sd, layers=2))
    want = flatten_tree(jcw.convert_wav2vec2_pretrain_state(sd, layers=2))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=str(key))
