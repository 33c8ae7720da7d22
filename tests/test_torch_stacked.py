"""Stacked units (n_frames_per_step = k > 1) in the port against the JAX
package on the CPU, float32, at tiny widths (tests/test_torch_nar_train.py's
NAR model, vocab 16 + 4): the packing, the StackedEmbedding, the stacked NAR
forward and criterion, mask-predict over packed canvases, and the int32 wrap
of JAX's packing at the released vocabulary, which the port does not share.
Shared weights go through `weights.from_jax_variables`; inputs come from
numpy seeds."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.nar_loss import NARSpeechToUnitLoss as JNARLoss
from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jax_mask_predict
from diffnorm_tpu.models import stacked as jstacked
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.tasks.ar_s2ut_task import stack_target as jstack_target
from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.models.stacked import (
    StackedEmbedding,
    pack_units,
    stack_target,
    unpack_units,
)
from diffnorm_tpu_torch.tasks.nar_s2ut_task import random_mask
from diffnorm_tpu_torch.weights import from_jax_params, from_jax_variables
from tests.test_torch_nar_train import FWD_TOL, NAR, _batch, _perturb, _torch
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

CODES = 16
VOCAB = CODES + 4
NAR1 = dict(NAR, encoder_layers=1, decoder_layers=1)  # one layer each: the file's cost


def _unit_targets(seed, lengths=(11, 1, 6, 7, 2), width=14):
    """Unit targets with EOS and pad tails; lengths with EOS, so unit counts
    that are and are not multiples of 2 and 3, and a row of EOS alone."""
    rng = np.random.default_rng(seed)
    target = np.full((len(lengths), width), 1, np.int32)
    for i, n in enumerate(lengths):
        target[i, :n - 1] = rng.integers(4, VOCAB, size=n - 1)
        target[i, n - 1] = 2
    return target


@pytest.mark.parametrize("k", [2, 3])
def test_packing_and_stack_target_equal_jax(k):
    """pack_units, unpack_units (specials pass through in every slot) and
    stack_target equal JAX's, the packed canvas's EOS step included."""
    rng = np.random.default_rng(k)
    raw = rng.integers(0, CODES, size=(4, 5, k)).astype(np.int32)
    packed = pack_units(torch.from_numpy(raw), CODES, k)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jstacked.pack_units(jnp.asarray(raw), CODES, k)))
    tokens = np.concatenate([packed.numpy(), [[0, 1, 2, 3, 4]]]).astype(np.int32)
    got = unpack_units(torch.from_numpy(tokens), CODES, k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jstacked.unpack_units(
        jnp.asarray(tokens), CODES, k)))
    np.testing.assert_array_equal(got[:4], raw + 4)  # round trip
    target = _unit_targets(10 + k)
    for ours, theirs in zip(stack_target(target, CODES, k), jstack_target(target, CODES, k)):
        np.testing.assert_array_equal(ours, theirs)


def test_stacked_embedding_matches_jax():
    emb = jstacked.StackedEmbedding(num_embeddings=VOCAB, embed_dim=8, num_stacked=2)
    tokens = np.asarray([[0, 1, 2, 3, 4, 5, 200, 259]], np.int32)
    params = emb.init(jax.random.PRNGKey(0), tokens)["params"]
    want = np.asarray(emb.apply({"params": params}, tokens))
    model = from_jax_params(StackedEmbedding(VOCAB, 8, 2), jax.device_get(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def _stacked_batch(seed, k):
    batch = _batch(seed)
    packed, sub = stack_target(batch["target"], CODES, k)
    return dict(batch, target=sub, target_packed=packed,
                prev_target=random_mask(packed, np.random.default_rng(seed)))


@pytest.fixture(scope="module", params=[2, 3])
def stacked(request):
    """(k, perturbed JAX variables of a stacked model)."""
    k = request.param
    jm = JNARS2UTModule(vocab_size=VOCAB, dropout=0.0, n_frames_per_step=k, **NAR1)
    batch = _stacked_batch(0, k)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), batch["src_tokens"],
                                 batch["src_lengths"], batch["prev_target"], batch["target"])
    return k, _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))


def test_stacked_forward_and_loss_match_jax(stacked, monkeypatch):
    """A training forward (dropout 0, CG at 0.5 and self-prompting, whose
    draft packs the sub-frames' argmax, draws injected) gives logits
    [B, T, k, V] and length logits within 1e-5 of JAX's; the validation
    criterion's loss and metrics within 1e-6 relative."""
    k, variables = stacked
    batch = _stacked_batch(5, k)
    cg_drop = np.asarray([False, True, False])
    jm = JNARS2UTModule(vocab_size=VOCAB, dropout=0.0, cg_prob=0.5, use_sp=True,
                        n_frames_per_step=k, **NAR1)

    def bernoulli(key, p=0.5, shape=None):
        return jnp.asarray(cg_drop) if shape is not None else jnp.asarray(True)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "bernoulli", bernoulli)
        ref, _ = jax.jit(lambda v, *a: jm.apply(
            v, *a, deterministic=False, mutable=["batch_stats"],
            rngs={n: jax.random.PRNGKey(i) for i, n in enumerate(("dropout", "cg", "sp"))}))(
                variables, batch["src_tokens"], batch["src_lengths"], batch["prev_target"],
                batch["target"])
    model = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, dropout=0.0, cg_prob=0.5,
                                             use_sp=True, n_frames_per_step=k, **NAR1),
                               variables).train()
    tb = _torch(batch)
    out = model(tb["src_tokens"], tb["src_lengths"], tb["prev_target"], tb["target"],
                cg_drop=torch.from_numpy(cg_drop), use_prompt=torch.tensor(True))
    assert out["logits"].shape == (3, batch["target"].shape[1], k, VOCAB)
    for key in ("logits", "length_logits"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   rtol=FWD_TOL, atol=FWD_TOL, err_msg=key)
    np.testing.assert_array_equal(out["length_tgt"].numpy(), np.asarray(ref["length_tgt"]))

    jm_eval = JNARS2UTModule(vocab_size=VOCAB, dropout=0.0, n_frames_per_step=k, **NAR1)
    ref_loss, ref_mets, _ = jax.jit(lambda v, b: JNARLoss(Config(label_smoothing=0.2))(
        jm_eval, v, b, jax.random.PRNGKey(0), train=False))(variables, batch)
    model = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, dropout=0.0,
                                             n_frames_per_step=k, **NAR1), variables).eval()
    with torch.no_grad():
        loss, mets = NARSpeechToUnitLoss(0.2)(model, tb)
    assert set(mets) == set(ref_mets)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for key, v in ref_mets.items():
        np.testing.assert_allclose(float(mets[key]), float(v), rtol=1e-6, atol=1e-7, err_msg=key)
    assert int(mets["ntokens"]) == int((batch["target"] != 1).sum())


def test_stacked_mask_predict_matches_jax(stacked):
    """mask_predict_decode over packed canvases, with a length beam of 3
    and CG 2: the full-rate tokens [B, max_len * k] and n_steps equal
    JAX's, scores within 1e-4."""
    k, variables = stacked
    src, lengths = _batch(11)["src_tokens"], _batch(11)["src_lengths"]
    kw = dict(max_iter=4, max_len=10, length_beam=3, cond_scale=2.0)
    jm = JNARS2UTModule(vocab_size=VOCAB, n_frames_per_step=k, **NAR1)
    want = jax.jit(lambda v, s, n: jax_mask_predict(types.SimpleNamespace(module=jm), v, s, n,
                                                    n_frames_per_step=k, **kw))(
                                                        variables, src, lengths)
    model = from_jax_variables(NARS2UTModule(vocab_size=VOCAB, n_frames_per_step=k, **NAR1),
                               variables).eval()
    got = mask_predict_decode(model, torch.from_numpy(src), torch.from_numpy(lengths), **kw)
    tokens = np.asarray(want[0])
    assert tokens.shape == (3, 10 * k)
    np.testing.assert_array_equal(got[0].numpy(), tokens)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    assert (tokens >= 4).sum() >= 4


def test_int32_packing_fault_of_the_reference_is_not_the_ports():
    """At the released V = 1000 and k = 4, V^k + 4 > 2^31: JAX's pack_units
    wraps to a negative id, which its unpack_units passes through as a
    special, and its stack_target wraps alike. The port packs in int64:
    exact, and the ids round-trip."""
    units = np.full((1, 4), 999, np.int32)
    wrapped = int(np.asarray(jstacked.pack_units(jnp.asarray(units), 1000, 4))[0])
    assert wrapped == -727379965
    assert (np.asarray(jstacked.unpack_units(jnp.asarray([wrapped]), 1000, 4)) == wrapped).all()
    target = np.asarray([[1003, 1003, 1003, 1003, 2]], np.int32)
    assert jstack_target(target, 1000, 4)[0][0, 0] == wrapped

    packed = pack_units(torch.from_numpy(units), 1000, 4)
    assert packed.dtype == torch.int64 and int(packed[0]) == 1_000_000_000_003
    np.testing.assert_array_equal(unpack_units(packed, 1000, 4).numpy(), units + 4)
    ours, sub = stack_target(target, 1000, 4)
    assert ours[0, 0] == 1_000_000_000_003 and (sub[0, 0] == 1003).all()
    assert ours.tolist()[0][1] == 2  # the EOS step
    assert (pack_units(torch.tensor([[999, 999, 999]]), 1000, 3)
            == int(np.asarray(jstacked.pack_units(jnp.full((1, 3), 999), 1000, 3))[0])).all()
