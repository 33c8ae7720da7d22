"""The S2T model in the port against the JAX package on the CPU, float32, at
tiny widths (encoder and decoder 2 x 16, 2 heads, 80-bin `.npy` sources):
the S2T manifests' reader and writer and the speech_to_text dataset's
collated, prepared batches (the dictionary from the data config's
vocab_filename; the unit dictionary without one) and dummy_s2t's; the
teacher-forced logits of s2t_transformer_xs and s2t_conformer (the decoder
over an encoder of another width), with the output projection shared and
not; the beam decode's hypotheses through the KV cache; the
label_smoothed_cross_entropy criterion; and the fairseq S2T encoder
converter against JAX's.

Tolerances: logits and losses within 1e-5 (FWD_TOL), beam scores within
1e-5, hypotheses equal token for token, converted trees bit for bit."""

import jax
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.ce_loss import LabelSmoothedCrossEntropy as JLabelSmoothedCE
from diffnorm_tpu.data.s2t_dataset import read_s2t_manifest as jread_s2t_manifest
from diffnorm_tpu.data.s2t_dataset import write_s2t_manifest as jwrite_s2t_manifest
from diffnorm_tpu.generate import beam_search as jbeam
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.utils.convert_weights import convert_s2t_encoder_state as jconvert
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.data.s2t_dataset import read_s2t_manifest, write_s2t_manifest
from diffnorm_tpu_torch.generate.beam_search import ar_generate
from diffnorm_tpu_torch.models.s2t_transformer import S2TTransformerEncoder
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.utils.convert_weights import convert_s2t_encoder_state
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_variables
from tests.test_torch_multitask import _assert_batches_equal, _nested_torch
from tests.test_torch_nar_train import FWD_TOL
from tests.test_torch_tts import seeded_variables
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

PAD, EOS = 1, 2
WORDS = [f"w{k}" for k in range(10)]
TINY = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=2,
            decoder_embed_dim=16, decoder_ffn_embed_dim=32, decoder_layers=2,
            encoder_attention_heads=2, decoder_attention_heads=2, conv_channels=16,
            depthwise_conv_kernel_size=7, dropout=0.0)
BEAM = dict(beam_size=3, max_len=8, no_repeat_ngram=2)


def flags(values):
    return [f"--{k.replace('_', '-')}={v}" for k, v in values.items()]


def write_s2t_corpus(root, seed=11, splits=(("train", 4), ("dev", 2), ("test", 3)),
                     vocab=True):
    """Sources of 24-56 frames, 3-5 words a row; with `vocab` the word
    dictionary named by the data config's vocab_filename."""
    rng = np.random.default_rng(seed)
    if vocab:
        (root / "words.txt").write_text("".join(f"{w} {100 - i}\n" for i, w in enumerate(WORDS)))
        (root / "config.yaml").write_text("vocab_filename: words.txt\n")
    for split, n in splits:
        rows = []
        for i in range(n):
            t = int(rng.integers(24, 57))
            np.save(root / f"{split}{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
            rows.append(dict(id=f"{split}{i}", audio=f"{split}{i}.npy", n_frames=t,
                             tgt_text=" ".join(rng.choice(WORDS, size=int(rng.integers(3, 6))))))
        write_s2t_manifest(str(root / f"{split}.tsv"), rows)
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_s2t_corpus(tmp_path_factory.mktemp("s2t"))


def s2t_tasks(root, arch, **extra):
    values = {**TINY, **extra}
    args = train_cli.parse_args([str(root), "--task", "speech_to_text", "--arch", arch,
                                 "--max-update", "1", *flags(values)])
    jtask = JTASKS.get("speech_to_text").setup_task(Config(
        task="speech_to_text", arch=arch, data=str(root), **values))
    return TASKS[args.task](args), jtask


def prepared(task, jtask, rows=(0, 1, 2, 3)):
    out = []
    for t in (task, jtask):
        ds = t.dataset("train")
        out.append(t.prepare_batch(ds.collater([ds[i] for i in rows]),
                                   np.random.default_rng(0)))
    return out


def build(root, arch, **extra):
    """(port task, JAX task, batch, JAX module, perturbed variables, the
    port's model on them, in eval mode)."""
    task, jtask = s2t_tasks(root, arch, **extra)
    batch, jbatch = prepared(task, jtask)
    _assert_batches_equal(batch, jbatch)
    jm = jtask.build_model()
    variables = seeded_variables(task, jtask, jm, batch)
    model = from_jax_variables(task.build_model(), variables).eval()
    return task, jtask, batch, jm, variables, model


@pytest.fixture(scope="module")
def xs(corpus):
    return build(corpus, "s2t_transformer_xs")


@pytest.fixture(scope="module")
def conformer(corpus):
    """s2t_conformer with its decoder 24 wide over the 16-wide encoder, the
    output projection tied to the embedding."""
    return build(corpus, "s2t_conformer", decoder_embed_dim=24, decoder_ffn_embed_dim=48,
                 share_decoder_input_output_embed=True)


def test_manifests_and_dataset_collate_as_jax(corpus, tmp_path):
    """The S2T manifest written and read as JAX's; the dictionary from
    vocab_filename, the order and the collated, prepared batch
    (prev_output_tokens) equal to JAX's; without a vocab file the unit
    dictionary of --target-code-size."""
    for split in ("train", "test"):
        rows = read_s2t_manifest(str(corpus / f"{split}.tsv"))
        assert rows == jread_s2t_manifest(str(corpus / f"{split}.tsv"))
        write_s2t_manifest(str(tmp_path / "port.tsv"), rows)
        jwrite_s2t_manifest(str(tmp_path / "jax.tsv"), rows)
        assert (tmp_path / "port.tsv").read_text() == (tmp_path / "jax.tsv").read_text()
    task, jtask = s2t_tasks(corpus, "s2t_transformer_xs")
    assert task.tgt_dict.symbols == jtask.tgt_dict.symbols and len(task.tgt_dict) == 14
    got, want = prepared(task, jtask, rows=(2, 0, 3, 1))
    _assert_batches_equal(got, want)
    assert (got["prev_output_tokens"][:, 0] == EOS).all()
    np.testing.assert_array_equal(task.dataset("train").ordered_indices(),
                                  jtask.dataset("train").ordered_indices())
    bare = write_s2t_corpus(tmp_path, seed=3, vocab=False)
    task, jtask = s2t_tasks(bare, "s2t_transformer_xs", target_code_size=30)
    assert len(task.tgt_dict) == len(jtask.tgt_dict) == 34


def test_dummy_s2t_batches_match_jax(corpus):
    """dummy_s2t: dummy_batch (prepared) equal to JAX's, the dataset
    `dataset_size` copies of it."""
    from diffnorm_tpu.tasks.s2t_task import DummyS2TTask as JDummy

    args = train_cli.parse_args([str(corpus), "--task", "speech_to_text", "--max-update", "1"])
    args.batch_size, args.dataset_size = 3, 5
    jtask = JDummy(Config(arch="s2t_transformer", data=str(corpus),
                          input_feat_per_channel=80))
    task = TASKS["dummy_s2t"](args)
    _assert_batches_equal(task.dummy_batch(3, 40), jtask.dummy_batch(3, 40))
    ds = task.dataset("train")
    assert len(ds) == 5
    _assert_batches_equal(ds[4], jtask.dummy_batch(3, 48))


@pytest.mark.parametrize("arch", ["s2t_transformer_xs", "s2t_conformer"])
def test_forward_and_criterion_match_jax(xs, conformer, arch):
    """The teacher-forced logits within FWD_TOL of JAX's (the conformer's
    decoder cross-attending another width, its output projection tied; the
    transformer's unshared), then label_smoothed_cross_entropy in the
    validation forward: loss, nll_loss, acc and the counts within FWD_TOL
    relative."""
    task, jtask, batch, jm, variables, model = xs if arch == "s2t_transformer_xs" else conformer
    assert hasattr(model.decoder, "output_proj") == (arch == "s2t_transformer_xs")
    jcrit = JLabelSmoothedCE(Config(label_smoothing=0.1), jtask)
    holder = jtask.build_model()

    def jax_run(v, b):
        logits = jm.apply(v, b["src_tokens"], b["src_lengths"], b["prev_output_tokens"],
                          deterministic=True)["logits"]
        return logits, jcrit(holder, v, b, jax.random.PRNGKey(0), train=False)[:2]

    want_logits, (want_loss, want) = jax.jit(jax_run)(variables, batch)
    t = _nested_torch(batch)
    with torch.no_grad():
        got = model(t["src_tokens"], t["src_lengths"], t["prev_output_tokens"].long())
        loss, mets = task.build_criterion()(model, t)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want_logits), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert sorted(mets) == sorted(want)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=FWD_TOL)
    for key, value in want.items():
        np.testing.assert_allclose(float(mets[key]), float(value), rtol=FWD_TOL, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ["s2t_transformer_xs", "s2t_conformer"])
def test_beam_decode_matches_jax(xs, conformer, arch):
    """ar_generate (beam 3, ngram blocking 2, 8 steps) through the KV cache:
    the hypotheses equal to JAX's ar_generate token for token, their scores
    within 1e-5."""
    task, jtask, batch, jm, variables, model = xs if arch == "s2t_transformer_xs" else conformer
    holder = jtask.build_model()
    want = jax.jit(lambda v, s, n: jbeam.ar_generate(holder, v, s, n, **BEAM))(
        variables, batch["src_tokens"], batch["src_lengths"])
    seqs, scores = ar_generate(model, torch.from_numpy(batch["src_tokens"]),
                               torch.from_numpy(batch["src_lengths"]), **BEAM)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]), rtol=FWD_TOL, atol=FWD_TOL)
    assert (seqs[:, 0, 0] != EOS).any()


def test_convert_s2t_encoder_state_matches_jax():
    """A seeded fairseq S2TTransformerEncoder state dict (keys under
    `encoder.`, two subsampler convs, two layers): the port's tree equal to
    JAX's bit for bit, and it loads into the port's encoder."""
    g = torch.Generator().manual_seed(0)
    shapes = {"subsample.conv_layers.0.weight": (32, 80, 5), "subsample.conv_layers.0.bias": (32,),
              "subsample.conv_layers.1.weight": (32, 16, 5), "subsample.conv_layers.1.bias": (32,),
              "layer_norm.weight": (16,), "layer_norm.bias": (16,)}
    for n in range(2):
        p = f"transformer_layers.{n}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{p}.self_attn.{proj}.weight"] = (16, 16)
            shapes[f"{p}.self_attn.{proj}.bias"] = (16,)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            shapes[f"{p}.{ln}.weight"], shapes[f"{p}.{ln}.bias"] = (16,), (16,)
        shapes[f"{p}.fc1.weight"], shapes[f"{p}.fc1.bias"] = (32, 16), (32,)
        shapes[f"{p}.fc2.weight"], shapes[f"{p}.fc2.bias"] = (16, 32), (16,)
    sd = {f"encoder.{k}": torch.randn(v, generator=g) for k, v in shapes.items()}
    sd["decoder.embed_tokens.weight"] = torch.randn(5, 16, generator=g)
    got, want = convert_s2t_encoder_state(sd, layers=2), jconvert(sd, layers=2)
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg="/".join(key))
    enc = S2TTransformerEncoder(dim=16, ffn_dim=32, layers=2, heads=2, conv_channels=32)
    from_jax_variables(enc, convert_s2t_encoder_state(sd, layers=2))
    torch.testing.assert_close(enc.layer_1.fc1.weight,
                               sd["encoder.transformer_layers.1.fc1.weight"])
