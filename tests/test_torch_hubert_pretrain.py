"""HuBERT pretraining in the port against the JAX package on the CPU at tiny
widths (2 layers, dim 32, a 3-conv extractor): the span mask on both numpy
streams, the pretraining dataset and the task's batches (bit for bit), the
encoder's training path and HubertPretrainModule's forward (float32 within
1e-5), the hubert criterion's loss and metrics (1e-5), gradients through
feature_grad_mult 0.1 and 0 (1e-4), and the pretraining state's converter
(bit for bit). Weights are the port's seeded init with biases and norm
scales moved, carried to JAX's tree by `to_jax_variables`; JAX's training
forwards run at dropouts and LayerDrop 0, since flax's dropout streams are
not torch's; the port's draws at rates above 0 are checked on their own."""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.hubert_loss import HubertLoss as JHubertLoss
from diffnorm_tpu.data.dictionary import Dictionary as JDictionary
from diffnorm_tpu.data.hubert_dataset import HubertPretrainDataset as JDataset
from diffnorm_tpu.models import hubert as jhubert
from diffnorm_tpu.tasks.hubert_pretrain_task import HubertPretrainingTask as JTask
from diffnorm_tpu.utils import convert_weights as jcw
from diffnorm_tpu.utils import masking as jmasking
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.hubert_loss import HubertLoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.hubert_dataset import HubertPretrainDataset
from diffnorm_tpu_torch.models.hubert import HubertPretrainModule
from diffnorm_tpu_torch.models.layers import set_dropout_generator
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.utils import convert_weights as cw
from diffnorm_tpu_torch.utils import masking
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_params, to_jax_variables
from tests.test_torch_prepare import _perturb
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

SPEC = ((32, 10, 5), (32, 3, 2), (32, 2, 2))  # a 20x downsample
TINY = dict(dim=32, layers=2, heads=2, ffn_dim=64, conv_feature_layers=SPEC)
ZERO = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0,
            layerdrop=0.0)
K = 12  # label classes
N_SAMPLES, LENGTHS = 2400, (2400, 1700)
SPEC_FLAG = "[(32,10,5),(32,3,2),(32,2,2)]"
CLI_TINY = dict(encoder_embed_dim=32, encoder_layers=2, encoder_attention_heads=2,
                encoder_ffn_embed_dim=64, conv_feature_layers=SPEC_FLAG, final_dim=16)


def port_params(model, seed=0):
    """The port model's params tree with biases and norm scales moved off
    their init, loaded back into the model; returns the tree."""
    params = _perturb(to_jax_variables(model)["params"], np.random.default_rng(seed))
    from_jax_params(model, params)
    return params


def jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def wav_batch(seed=1, n=N_SAMPLES, lengths=LENGTHS):
    """Waveforms [B, n] (0.1-scaled normals, zero past each length) and
    their lengths."""
    wav = (np.random.default_rng(seed).normal(size=(len(lengths), n)) * 0.1).astype(np.float32)
    for i, length in enumerate(lengths):
        wav[i, length:] = 0.0
    return wav, np.asarray(lengths, np.int32)


def span_mask(wav, lengths, seed=2, spec=SPEC):
    """A span mask over the valid frames (the task's draw)."""
    n = jhubert.frames_for_samples(wav.shape[1], spec)
    valid = [jhubert.frames_for_samples(int(x), spec) for x in lengths]
    padding = np.arange(n)[None, :] >= np.asarray(valid)[:, None]
    return masking.compute_mask_indices(wav.shape[:1] + (n,), padding, 0.3, 3, min_masks=2,
                                        rng=np.random.default_rng(seed)) & ~padding


# ------------------------------------------------------------------ masking

MASK_CASES = {
    "static": dict(mask_type="static"),
    "uniform": dict(mask_type="uniform", mask_other=1),
    "normal": dict(mask_type="normal", mask_other=2.0),
    "poisson": dict(mask_type="poisson"),
    "no_overlap": dict(mask_type="uniform", mask_other=1, no_overlap=True, min_space=1),
    "mask_dropout": dict(mask_type="static", mask_dropout=0.2),
    "ragged_rows": dict(mask_type="static", require_same_masks=False, min_masks=2),
    "no_padding": dict(mask_type="static", padded=False),
}


@pytest.mark.parametrize("stream", ["legacy", "generator"])
@pytest.mark.parametrize("case", list(MASK_CASES))
def test_compute_mask_indices_matches_jax(stream, case):
    """Bit-equal masks from one seed: the legacy global np.random stream
    (rng=None) and an explicit Generator, every mask type, no_overlap's
    free-interval placement, mask_dropout, unequal rows."""
    kw = dict(MASK_CASES[case])
    padded = kw.pop("padded", True)
    padding = np.zeros((4, 120), bool)
    if padded:
        for i, n in enumerate((120, 97, 64, 110)):
            padding[i, n:] = True
    args = ((4, 120), padding if padded else None, 0.5, 5)
    outs = []
    for fn in (jmasking.compute_mask_indices, masking.compute_mask_indices):
        if stream == "legacy":
            np.random.seed(7)
            outs.append(fn(*args, **kw))
        else:
            outs.append(fn(*args, rng=np.random.default_rng(7), **kw))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[1].any()


def test_length_masks_and_apply_mask_match_jax():
    lengths = np.asarray([5, 2, 7])
    np.testing.assert_array_equal(
        masking.lengths_to_padding_mask(torch.from_numpy(lengths), 8).numpy(),
        np.asarray(jmasking.lengths_to_padding_mask(jnp.asarray(lengths), 8)))
    x = np.random.default_rng(0).normal(size=(3, 8, 4)).astype(np.float32)
    mask = masking.lengths_to_mask(torch.from_numpy(lengths), 8)
    np.testing.assert_array_equal(
        masking.apply_mask(torch.from_numpy(x), mask, fill=-1.0).numpy(),
        np.asarray(jmasking.apply_mask(jnp.asarray(x), jnp.asarray(mask.numpy()), fill=-1.0)))


# ------------------------------------------------------------------ data

def write_wav(path, samples):
    pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def write_pretrain_corpus(root, seed=3, splits=(("train", 6), ("dev", 2)), k=K):
    """16 kHz WAVs of 1500-4000 samples (one of 900, under
    min_sample_size), a wav2vec manifest, 50 Hz k-means labels over K
    units and dict.km.txt."""
    rng = np.random.default_rng(seed)
    (root / "dict.km.txt").write_text("".join(f"{i} 1\n" for i in range(k)))
    for split, n in splits:
        lines, labels = [str(root)], []
        for i in range(n):
            size = 900 if (split == "train" and i == 1) else int(rng.integers(1500, 4001))
            write_wav(root / f"{split}{i}.wav", rng.normal(size=size) * 0.1)
            lines.append(f"{split}{i}.wav\t{size}")
            n_labels = int(size / 16000 * 50) + int(rng.integers(-1, 2))
            labels.append(" ".join(map(str, rng.integers(0, k, size=n_labels))))
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")
        (root / f"{split}.km").write_text("\n".join(labels) + "\n")
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_pretrain_corpus(tmp_path_factory.mktemp("hubert_data"))


@pytest.mark.parametrize("split", ["train", "dev"])
@pytest.mark.parametrize("labels", [True, False], ids=["labels", "audio_only"])
def test_pretrain_dataset_matches_jax(corpus, split, labels):
    """The manifest filter, the crops to a 2000-sample canvas (random from
    the dataset's generator in training, prefix in validation), the labels
    aligned at 50 Hz and the collater: each batch bit for bit, in the
    datasets' order."""
    kw = dict(max_sample_size=2000, min_sample_size=1000, is_train=split == "train",
              conv_layers=SPEC)
    label_file = str(corpus / f"{split}.km") if labels else None
    jds = JDataset.from_manifest(str(corpus / f"{split}.tsv"), label_file,
                                 JDictionary.load(str(corpus / "dict.km.txt")), **kw)
    tds = HubertPretrainDataset.from_manifest(str(corpus / f"{split}.tsv"), label_file,
                                              Dictionary.load(str(corpus / "dict.km.txt")), **kw)
    assert len(tds) == len(jds) and tds.n_frames == jds.n_frames
    np.testing.assert_array_equal(tds.ordered_indices(), jds.ordered_indices())
    order = tds.ordered_indices()
    for rows in (order[:2], order[2:]):
        if not len(rows):
            continue
        want = jds.collater([jds[int(i)] for i in rows])
        got = tds.collater([tds[int(i)] for i in rows])
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def task_pair(root, name="hubert_pretraining", **extra):
    """The port's task (cli.train's flags) and JAX's (its Config) over one
    configuration."""
    values = {**CLI_TINY, **extra}
    argv = [str(root), "--task", name, "--max-update", "1", "--target-code-size", str(K - 4),
            *[f"--{k.replace('_', '-')}={v}" for k, v in values.items()]]
    args = train_cli.parse_args(argv)
    jvalues = {**values, "conv_feature_layers": [list(t) for t in SPEC]}
    jtask = JTask(Config(task=name, data=str(root), target_code_size=K - 4, **jvalues))
    return TASKS[name](args), jtask


@pytest.mark.parametrize("selection", ["static", "uniform"])
def test_task_batches_match_jax(corpus, selection):
    """hubert_pretraining's prepare_batch on a collated training batch (the
    mask over the labelled frames, min_masks 2) and the dummy batch, bit for
    bit from one generator seed."""
    task, jtask = task_pair(corpus, mask_prob=0.4, mask_length=3, mask_selection=selection,
                            max_sample_size=2000, min_sample_size=1000)
    assert len(task.tgt_dict) == len(jtask.tgt_dict) == K + 4
    jds, tds = jtask.dataset("train"), task.dataset("train")
    want = jtask.prepare_batch(jds.collater([jds[0], jds[2]]), np.random.default_rng(5))
    got = task.prepare_batch(tds.collater([tds[0], tds[2]]), np.random.default_rng(5))
    for ours, theirs in ((got, want), (task.dummy_batch(3, 2400), jtask.dummy_batch(3, 2400))):
        assert sorted(ours) == sorted(theirs)
        for key, value in theirs.items():
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        assert ours["mask_indices"].any()


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def pretrain_pair():
    """HubertPretrainModule at TINY width, float32, its params tree."""
    torch.manual_seed(0)
    model = HubertPretrainModule(num_classes=K, final_dim=16, **TINY, **ZERO)
    return model, port_params(model)


def jax_pretrain(**kw):
    cfg = dict(TINY, **ZERO)
    return jhubert.HubertPretrainModule(num_classes=K, final_dim=16, **{**cfg, **kw})


def test_pretrain_forward_and_criterion_match_jax(pretrain_pair):
    """Eval forwards: the [B, F, K] logits and features_pen within 1e-5;
    the hubert criterion (with the unmasked term and the feature penalty)
    loss and every metric within 1e-5, counts equal."""
    model, params = pretrain_pair
    model.eval()
    wav, lengths = wav_batch()
    mask = span_mask(wav, lengths)
    jm = jax_pretrain()
    want = jax.jit(jm.apply)({"params": jtree(params)}, jnp.asarray(wav), jnp.asarray(lengths),
                             jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(wav), torch.from_numpy(lengths), torch.from_numpy(mask))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["features_pen"]), float(want["features_pen"]),
                               rtol=1e-5)
    n = got["mask"].shape[1]
    target = np.random.default_rng(4).integers(0, K, size=(2, n)).astype(np.int64)
    target[~got["mask"].numpy()] = -1
    target[0, 3] = -1
    batch = dict(src_tokens=wav, src_lengths=lengths, target=target, mask_indices=mask)
    cfg = {"pred_nomask_weight": 0.5, "loss_weights": [10.0]}
    jloss, jmet = jax.jit(lambda p: JHubertLoss(cfg)(jm, {"params": p}, batch, None,
                                                     train=False)[:2])(jtree(params))
    with torch.no_grad():
        loss, met = HubertLoss(1.0, 0.5, [10.0])(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(met) == sorted(jmet)
    for key, value in jmet.items():
        np.testing.assert_allclose(float(met[key]), float(value), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("mult", [0.1, 0.0])
def test_gradients_through_feature_grad_mult_match_jax(pretrain_pair, mult):
    """One training forward (dropouts and LayerDrop 0) and the criterion's
    gradient: every parameter's within 1e-4 of jax.grad's, the extractor's
    scaled by feature_grad_mult (all zero at 0)."""
    model, params = pretrain_pair
    model.train()
    model.encoder.feature_grad_mult = mult
    wav, lengths = wav_batch(seed=6)
    mask = span_mask(wav, lengths, seed=7)
    n = mask.shape[1]
    target = np.random.default_rng(8).integers(0, K, size=(2, n)).astype(np.int64)
    batch = dict(src_tokens=wav, src_lengths=lengths, target=target, mask_indices=mask)
    jm = jax_pretrain(feature_grad_mult=mult)
    crit = JHubertLoss({"loss_weights": [10.0]})

    def jloss(p):
        return crit(jm, {"params": p}, batch, jax.random.PRNGKey(0), train=True)[0]

    want = flatten_tree(jax.device_get(jax.jit(jax.grad(jloss))(jtree(params))))
    loss, _ = HubertLoss(loss_weights=[10.0])(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                allow_unused=True)
    got = flatten_tree(to_jax_variables(model)["params"])
    by_name = dict(zip(names, grads))
    model.encoder.feature_grad_mult = 0.1
    for path, g in want.items():
        name = ".".join(path[:-1] + ("weight" if path[-1] in ("kernel", "scale")
                                     else path[-1],))
        ours = by_name[name]
        if ours is None:  # no gradient reaches it (the extractor at 0)
            ours = torch.zeros(got[path].shape)
        elif path[-1] == "kernel" and ours.dim() == 2:
            ours = ours.T
        elif path[-1] == "kernel":
            ours = ours.permute(2, 1, 0)
        np.testing.assert_allclose(ours.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4,
                                   err_msg="/".join(path))
        if "feature_extractor" in path and mult == 0.0:
            assert not np.asarray(g).any()


def test_training_draws_and_layerdrop():
    """At dropout 0.1 and LayerDrop 0.5 a training forward draws from the
    generator the trainer sets (the same seed, the same output; another
    seed, another), eval keeps every layer and draws nothing, and a
    training forward without a generator raises."""
    torch.manual_seed(1)
    model = HubertPretrainModule(num_classes=K, final_dim=16, **TINY, dropout=0.1,
                                 attention_dropout=0.1, layerdrop=0.5)
    wav, lengths = wav_batch()
    args = (torch.from_numpy(wav), torch.from_numpy(lengths),
            torch.from_numpy(span_mask(wav, lengths)))
    outs = []
    for seed in (0, 0, 1):
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(model.train()(*args)["logits"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    set_dropout_generator(model, None)
    with torch.no_grad():
        a, b = model.eval()(*args)["logits"], model(*args)["logits"]
    assert torch.equal(a, b) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="generator"):
        model.train()(*args)


# ------------------------------------------------------------------ converter

def fairseq_hubert_state(seed=0, layers=2):
    """A seeded fairseq HubertModel state dict at TINY width."""
    from tests.test_torch_prepare import fairseq_state_dict

    g = torch.Generator().manual_seed(seed)
    sd = dict(fairseq_state_dict(seed))
    sd["label_embs_concat"] = torch.randn(K, 16, generator=g)
    sd["final_proj.weight"], sd["final_proj.bias"] = (torch.randn(16, 64, generator=g),
                                                      torch.randn(16, generator=g))
    sd["mask_emb"] = torch.rand(64, generator=g)
    return sd


def test_pretrain_state_converter_matches_jax():
    sd = fairseq_hubert_state()
    got = flatten_tree(cw.convert_hubert_pretrain_state(sd, layers=2))
    want = flatten_tree(jcw.convert_hubert_pretrain_state(sd, layers=2))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=str(key))
