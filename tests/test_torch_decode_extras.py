"""The NAR decode's extras in the port against the JAX package on the CPU,
float32, at tiny widths (one conformer and one decoder layer, vocab 16 + 4):
model ensembles (`mask_predict_decode` over a list of models), the
per-step history (`retain_history`), the chunked decode
(`mask_predict_decode_chunked`) and `cli.generate --path a:b
--retain-iter-history --decode-chunk N`. Tokens, histories and n_steps are
equal; scores agree within 1e-5 (the CLI's printed scores within 2e-4, as
tests/test_torch_eval.py holds them). Shared weights go through
`from_jax_variables` / `save_npz`; inputs come from numpy seeds."""

import types

import jax
import numpy as np
import pytest
import torch

from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jax_mask_predict
from diffnorm_tpu.generate.mask_predict import (
    mask_predict_decode_chunked as jax_mask_predict_chunked,
)
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu_torch.generate.mask_predict import (
    mask_predict_decode,
    mask_predict_decode_chunked,
)
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.weights import from_jax_variables, save_npz
from tests.test_torch_eval import (  # noqa: F401
    WIDTH_FLAGS,
    _assert_generate_files_agree,
    _generate_lines,
    generate_corpus,
)
from tests.test_torch_nar_train import _batch
from tests.test_torch_s2st import _perturb
from tests.test_torch_stacked import NAR1, VOCAB, _stacked_batch
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

SCORE_TOL = 1e-5
SPK_DIM = 8


def _models(k=1, n=2, **kw):
    """(JAX module, n perturbed variables trees, the port's models on them)
    of one architecture."""
    jm = JNARS2UTModule(vocab_size=VOCAB, n_frames_per_step=k, **NAR1, **kw)
    batch = _stacked_batch(0, k) if k > 1 else _batch(0)
    init_kw = {}
    if kw.get("target_speaker_embed"):
        init_kw["tgt_speaker"] = np.zeros((3, SPK_DIM), np.float32)
    init = jax.jit(lambda key: jm.init(key, batch["src_tokens"], batch["src_lengths"],
                                       batch["prev_target"], batch["target"], **init_kw))
    trees = [_perturb(jax.device_get(dict(init(jax.random.PRNGKey(i)))),
                      np.random.default_rng(10 + i)) for i in range(n)]
    models = [from_jax_variables(NARS2UTModule(vocab_size=VOCAB, n_frames_per_step=k,
                                               **NAR1, **kw), v).eval() for v in trees]
    return jm, trees, models


@pytest.fixture(scope="module")
def ensemble():
    return {k: _models(k) for k in (1, 2)}


def _jax_decode(jm, trees, src, lengths, k, **kw):
    return jax.jit(lambda v, s, n: jax_mask_predict(
        types.SimpleNamespace(module=jm), v, s, n, n_frames_per_step=k, **kw))(
            trees, src, lengths)


def _assert_outputs_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    assert len(got) == len(want)
    if len(want) == 4:
        assert got[3].shape == np.asarray(want[3]).shape
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("case", ["plain", "cg2", "beam3", "k2_beam3_cg2"])
def test_ensemble_matches_jax(ensemble, case):
    """A 2-member ensemble against JAX's `mask_predict_decode(variables=[v1,
    v2])`: tokens and n_steps equal, scores within 1e-5; its tokens differ
    from either member's alone."""
    k = 2 if case.startswith("k2") else 1
    jm, trees, models = ensemble[k]
    batch = _batch(11)
    src, lengths = batch["src_tokens"], batch["src_lengths"]
    kw = dict(max_iter=3, max_len=12)
    if "cg2" in case:
        kw["cond_scale"] = 2.0
    if "beam3" in case:
        kw["length_beam"] = 3
    want = _jax_decode(jm, trees, src, lengths, k, **kw)
    got = mask_predict_decode(models, torch.from_numpy(src), torch.from_numpy(lengths), **kw)
    _assert_outputs_equal(got, want)
    tokens = np.asarray(want[0])
    assert tokens.shape == (3, 12 * k) and (tokens >= 4).sum() >= 6
    alone = [mask_predict_decode(m, torch.from_numpy(src), torch.from_numpy(lengths), **kw)[0]
             for m in models]
    assert all(not np.array_equal(a.numpy(), tokens) for a in alone)


@pytest.mark.parametrize("case", ["beam3", "k2_ensemble_beam3"])
def test_retain_history_matches_jax(ensemble, case):
    """`retain_history=True` returns [max_iter + 1, B, T] equal to JAX's
    (the early exit off, frozen rows repeating their canvas, the best beam's
    history, stacked units unpacked to the full-rate stream); its last step
    is the returned canvas, and the tokens equal the decode without
    history."""
    k = 2 if case.startswith("k2") else 1
    jm, trees, models = ensemble[k]
    if "ensemble" not in case:
        trees, models = trees[0], models[0]
    batch = _batch(12)
    src, lengths = batch["src_tokens"], batch["src_lengths"]
    kw = dict(max_iter=4, max_len=12, length_beam=3)
    want = _jax_decode(jm, trees, src, lengths, k, retain_history=True, **kw)
    got = mask_predict_decode(models, torch.from_numpy(src), torch.from_numpy(lengths),
                              retain_history=True, **kw)
    _assert_outputs_equal(got, want)
    history = got[3].numpy()
    assert history.shape == (5, 3, 12 * k)
    np.testing.assert_array_equal(history[-1], got[0].numpy())
    assert not np.array_equal(history[0], history[-1])
    plain = mask_predict_decode(models, torch.from_numpy(src), torch.from_numpy(lengths), **kw)
    np.testing.assert_array_equal(plain[0].numpy(), got[0].numpy())


def test_chunked_decode_matches_jax():
    """`mask_predict_decode_chunked` with chunk 2 over B = 5 (the last chunk
    padded), forced lengths, speaker embeddings and the history against
    JAX's: equal; and equal to the port's unchunked decode. chunk 0 and
    chunk >= B are the plain call."""
    jm, trees, models = _models(n=1, target_speaker_embed=True, speaker_embed_dim=SPK_DIM)
    batch = _batch(13, b=5, lengths=(64, 50, 41, 30, 23), tgt_lengths=(9, 5, 11, 2, 7))
    src, lengths = batch["src_tokens"], batch["src_lengths"]
    rng = np.random.default_rng(14)
    true_length = np.asarray([7, 1, 12, 4, 9], np.int32)
    spk = rng.normal(size=(5, SPK_DIM)).astype(np.float32)
    kw = dict(max_iter=3, max_len=14, retain_history=True)
    want = jax.jit(lambda v, s, n, t, p: jax_mask_predict_chunked(
        types.SimpleNamespace(module=jm), v, s, n, chunk=2, true_length=t, tgt_speaker=p,
        **kw))(trees[0], src, lengths, true_length, spk)
    args = (models[0], torch.from_numpy(src), torch.from_numpy(lengths))
    row = dict(true_length=torch.from_numpy(true_length), tgt_speaker=torch.from_numpy(spk))
    got = mask_predict_decode_chunked(*args, chunk=2, **row, **kw)
    _assert_outputs_equal(got, want)
    assert got[0].shape == (5, 14) and got[3].shape == (4, 5, 14)
    whole = mask_predict_decode(*args, **row, **kw)
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for chunk in (0, 5):
        same = mask_predict_decode_chunked(*args, chunk=chunk, **row, **kw)
        np.testing.assert_array_equal(same[3].numpy(), whole[3].numpy())


def test_cli_generate_ensemble_history_chunked_matches_jax_cli(generate_corpus, tmp_path):  # noqa: F811
    """`cli.generate --path a:b --retain-iter-history --decode-chunk 3`
    against JAX's CLI with the same flags (JAX reads orbax checkpoints, the
    port save_npz files): the T-, H-, D- and E- lines equal (scores within
    2e-4); every sentence has max_iter + 1 E- lines, the last one its
    hypothesis."""
    import orbax.checkpoint as ocp

    from diffnorm_tpu.cli import generate as jax_generate
    from diffnorm_tpu.config import Config
    from diffnorm_tpu_torch.cli import generate
    from tests.test_torch_eval import NAR_CFG

    root = generate_corpus
    ckptr = ocp.StandardCheckpointer()
    restored = ckptr.restore(str(root / "nar_ck"))
    second = _perturb(jax.device_get(dict(restored)), np.random.default_rng(21))
    ckptr.save(str(tmp_path / "nar2_ck"), second)
    ckptr.wait_until_finished()
    save_npz(str(tmp_path / "nar2.npz"), second)
    out = tmp_path / "out"
    jax_cfg = dict(data=str(root), path=f"{root / 'nar_ck'}:{tmp_path / 'nar2_ck'}", cpu=True,
                   gen_subset="test", max_tokens=120, retain_iter_history=True,
                   decode_chunk=3, **NAR_CFG)
    assert jax_generate.main(Config(results_path=str(out / "jax"), **jax_cfg)) == 0
    assert generate.main([str(root), "--cpu", "--path",
                          f"{root / 'nar.npz'}:{tmp_path / 'nar2.npz'}", "--gen-subset", "test",
                          "--max-tokens", "120", "--retain-iter-history", "--decode-chunk", "3",
                          *WIDTH_FLAGS, "--results-path", str(out / "port")]) == 0
    want = _generate_lines(out / "jax" / "generate-test.txt")
    got = _generate_lines(out / "port" / "generate-test.txt")
    _assert_generate_files_agree(got, want)
    hyps = {line.split("\t")[0][2:]: line.split("\t")[2] for line in got
            if line.startswith("H-")}
    steps = [line for line in got if line.startswith("E-")]
    assert len(hyps) == 5 and len(steps) == 5 * (NAR_CFG["iter_decode_max_iter"] + 1)
    for sid, hyp in hyps.items():
        last = [line for line in steps if line.startswith(f"E-{sid}_")][-1]
        assert last == f"E-{sid}_{NAR_CFG['iter_decode_max_iter']}\t{hyp}"
