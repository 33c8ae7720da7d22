"""AR generation in the port against the JAX package on the CPU, float32:
the ngram-blocking mask, fairseq's beam search on a seeded table-driven
decode step (beams 1, 2 and 5, length and unk penalties, min_len, ngram
blocking, forced prefixes with a free PAD position; its state reordered
with the beams), `ar_generate` on the tiny AR S2UT model alone and as a
2-member ensemble, the greedy stacked decode, sampling where the top-k or
top-p cut leaves one token (the draw is then certain, so JAX's PRNG does
not enter), and the AR reranker of mask-predict's length beam. It mirrors
tests/test_ar.py and tests/test_beam_reference_parity.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.generate import beam_search as jbeam
from diffnorm_tpu.generate.mask_predict import ar_rerank_scores as jax_rerank_scores
from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jax_mask_predict
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu_torch.generate import beam_search
from diffnorm_tpu_torch.generate.mask_predict import ar_rerank_scores, mask_predict_decode
from tests.test_torch_ar import jax_model, prepared, write_ar_corpus, ar_tasks
from tests.test_torch_nar_train import NAR, _batch, _port, _perturb
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

PAD, BOS, EOS, UNK = 1, 0, 2, 3
V, L, B = 16, 9, 3
SCORE_TOL = 1e-5  # float32, the same sums


def tables(seed):
    """Logits by (position, fed token) and by a row's history hash, EOS
    raised so that hypotheses finish at several steps."""
    rng = np.random.default_rng(seed)
    by_token = rng.normal(size=(L, V, V)).astype(np.float32) * 2
    by_token[:, :, EOS] += 1.0
    return by_token, rng.normal(size=(7, V)).astype(np.float32)


def jax_step(by_token, by_hash):
    def step(cache, tokens, positions):
        logits = jnp.asarray(by_token)[positions, tokens[:, 0]] + jnp.asarray(by_hash)[cache]
        return logits, (cache * 3 + tokens[:, 0]) % 7
    return step


def torch_step(by_token, by_hash):
    t, h = torch.from_numpy(by_token), torch.from_numpy(by_hash)

    def step(cache, tokens, positions):
        return t[positions, tokens[:, 0]] + h[cache], (cache * 3 + tokens[:, 0]) % 7
    return step


@pytest.mark.parametrize("ngram", [2, 3])
def test_ngram_blocking_mask_equals_jax(ngram):
    rng = np.random.default_rng(ngram)
    seqs = rng.integers(4, 8, size=(4, 10)).astype(np.int32)
    for step in range(11):
        want = np.asarray(jbeam.ngram_blocking_mask(jnp.asarray(seqs), jnp.asarray(step), V,
                                                    ngram))
        got = beam_search.ngram_blocking_mask(torch.from_numpy(seqs).long(), step, V, ngram)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"step {step}")
    assert (want < 0).any()


BEAM_CASES = [
    (1, {}),
    (2, dict(len_penalty=0.6, unk_penalty=0.5, min_len=3)),
    (5, dict(no_repeat_ngram=2)),
    (5, dict(prefix=True, len_penalty=1.3, min_len=4)),
    (2, dict(prefix=True, no_repeat_ngram=2, unk_penalty=1.0, len_penalty=0.8)),
]


@pytest.mark.parametrize("beam, opts", BEAM_CASES)
def test_beam_search_equals_jax(beam, opts):
    """Every finalized hypothesis [B, K, L] equal to JAX's and its score
    within 1e-5 (empty slots -inf in both)."""
    opts = dict(opts)
    by_token, by_hash = tables(beam + len(opts))
    prefix = None
    if opts.pop("prefix", False):
        prefix = np.asarray([[5, 6], [7, PAD], [4, 4]], np.int32)
    want = jbeam.beam_search(jax_step(by_token, by_hash), jnp.zeros((B * beam,), jnp.int32), B,
                             beam, L, V, prefix_tokens=None if prefix is None
                             else jnp.asarray(prefix), **opts)
    got = beam_search.beam_search(torch_step(by_token, by_hash),
                                  torch.zeros(B * beam, dtype=torch.int64), B, beam, L, V,
                                  prefix_tokens=None if prefix is None
                                  else torch.from_numpy(prefix), **opts)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    assert np.isfinite(got[1][:, 0].numpy()).all()
    if prefix is not None:
        np.testing.assert_array_equal(got[0][:, 0, 0].numpy(), prefix[:, 0])


@pytest.mark.parametrize("cut", [dict(sampling_topk=1), dict(sampling_topp=0.01)])
def test_sampling_with_one_token_left_equals_jax(cut):
    """sample_generate where the cut leaves one token a row: seqs equal and
    the drawn log-probs' sums within 1e-5 (min_len, the unk penalty and a
    forced prefix as well)."""
    by_token, by_hash = tables(11)
    n = 4
    prefix = np.asarray([[5], [PAD], [6], [7]], np.int32)
    kw = dict(min_len=2, unk_penalty=0.5, temperature=0.7, **cut)
    want = jbeam.sample_generate(jax_step(by_token, by_hash), jnp.zeros((n,), jnp.int32), n, L,
                                 V, jax.random.PRNGKey(0), prefix_tokens=jnp.asarray(prefix),
                                 **kw)
    got = beam_search.sample_generate(torch_step(by_token, by_hash),
                                      torch.zeros(n, dtype=torch.int64), n, L, V,
                                      generator=torch.Generator().manual_seed(0),
                                      prefix_tokens=torch.from_numpy(prefix), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny s2ut_conformer (1 + 1 layers) and its stacked twin: (JAX
    holder, variables, the port's models, the batch) each, the first with a
    second member for the ensemble."""
    root = write_ar_corpus(tmp_path_factory.mktemp("beam"), multitask=False)
    out = {}
    for k in (1, 2):
        task, jtask = ar_tasks(root, criterion="label_smoothed_cross_entropy", multitask=False,
                               encoder_layers=1, decoder_layers=1, n_frames_per_step=k)
        batch, _ = prepared(task, jtask)
        members = [jax_model(task, jtask, batch, seed=s) for s in (1, 2)[:3 - k]]
        holder = types.SimpleNamespace(module=members[0][0])
        out[k] = (holder, [v for _, v, _ in members], [m.eval() for _, _, m in members], batch)
    return out


def _src(batch):
    return torch.from_numpy(batch["src_tokens"]), torch.from_numpy(batch["src_lengths"])


@pytest.mark.parametrize("members", [1, 2])
def test_ar_generate_equals_jax(tiny, members):
    """ar_generate with one model and with a 2-member ensemble (beam 3,
    ngram blocking 2): hypotheses equal, scores within 1e-5."""
    holder, variables, models, batch = tiny[1]
    kw = dict(beam_size=3, max_len=10, no_repeat_ngram=2)
    want = jax.jit(lambda v, s, n: jbeam.ar_generate(holder, v, s, n, **kw))(
        variables[0] if members == 1 else variables, batch["src_tokens"], batch["src_lengths"])
    got = beam_search.ar_generate(models[0] if members == 1 else models, *_src(batch), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_ar_generate_sampling_top1_equals_jax(tiny):
    """--sampling --sampling-topk 1 through the model: 3 draws a sentence,
    equal to JAX's, their normalized scores within 1e-5."""
    holder, variables, models, batch = tiny[1]
    kw = dict(beam_size=3, max_len=10, sampling=True, sampling_topk=1, len_penalty=0.8)
    want = jax.jit(lambda v, s, n: jbeam.ar_generate(holder, v, s, n, rng=jax.random.PRNGKey(3),
                                                     **kw))(
        variables[0], batch["src_tokens"], batch["src_lengths"])
    got = beam_search.ar_generate(models[0], *_src(batch),
                                  generator=torch.Generator().manual_seed(3), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_ar_generate_stacked_equals_jax(tiny):
    """The greedy stacked decode (k = 2): packed ids and sub-units equal."""
    holder, variables, models, batch = tiny[2]
    want = jax.jit(lambda v, s, n: jbeam.ar_generate_stacked(holder, v, s, n, max_len=8))(
        variables[0], batch["src_tokens"], batch["src_lengths"])
    got = beam_search.ar_generate_stacked(models[0], *_src(batch), max_len=8)
    assert got[1].shape == (batch["src_tokens"].shape[0], 8, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ar_rerank_scores_and_the_reranked_decode_equal_jax(tiny):
    """ar_rerank_scores of seeded candidates within 1e-5; mask_predict_decode
    with a length beam of 3 and the AR model as reranker picks JAX's
    candidates (tokens and scores as JAX's), on the NAR model of
    tests/test_torch_nar_train.py."""
    holder, variables, models, batch = tiny[1]
    rng = np.random.default_rng(5)
    n = batch["src_tokens"].shape[0]
    cand = rng.integers(4, 20, size=(n, 9)).astype(np.int32)
    cand[1, 6:] = PAD
    want = jax.jit(lambda v, s, n, c: jax_rerank_scores(holder, v, s, n, c))(
        variables[0], batch["src_tokens"], batch["src_lengths"], cand)
    with torch.no_grad():
        got = ar_rerank_scores(models[0], *_src(batch), torch.from_numpy(cand).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCORE_TOL, atol=SCORE_TOL)

    jnar = JNARS2UTModule(vocab_size=20, dropout=0.0, **NAR)
    nb = _batch(0)
    nar_vars = jax.jit(jnar.init)(jax.random.PRNGKey(0), nb["src_tokens"], nb["src_lengths"],
                                  nb["prev_target"], tgt_tokens=nb["target"])
    nar_vars = _perturb(jax.device_get(dict(nar_vars)), np.random.default_rng(1))
    kw = dict(max_iter=3, max_len=12, length_beam=3)
    want = jax.jit(lambda v, r, s, n: jax_mask_predict(
        types.SimpleNamespace(module=jnar), v, s, n, reranker=(holder, r), **kw))(
            nar_vars, variables[0], nb["src_tokens"], nb["src_lengths"])
    got = mask_predict_decode(_port(nar_vars).eval(), torch.from_numpy(nb["src_tokens"]),
                              torch.from_numpy(nb["src_lengths"]), reranker=models[0], **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
