"""The CTC fine-tune in the port against the JAX package on the CPU at tiny
widths: HubertCTCModule's forward in eval and in training with the time
and channel masks (float32 within 1e-5, dropouts and LayerDrop 0), the ctc
criterion's loss and metrics with a row that cannot align (1e-5: optax's
large finite loss, which JAX keeps), the audio_finetuning task's masks and
dummy batch and the use_audio_input dataset's batches (bit for bit), the
CTC checkpoint converter and the --w2v-path warm start from fairseq
pretraining states (bit for bit), and one CLI chain: cli.train
hubert_pretraining -> cli.train audio_finetuning --w2v-path (graft checked
bit for bit, then a resume that drops it) -> cli.validate -> cli.generate,
whose generate-test.txt equals JAX's cli.generate on the same weights (the
greedy tokens equal, scores within 2e-4; one JAX CLI run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.ctc_loss import CtcLoss as JCtcLoss
from diffnorm_tpu.data.dictionary import Dictionary as JDictionary
from diffnorm_tpu.data.s2t_dataset import SpeechToTextDataset as JDataset
from diffnorm_tpu.models import hubert as jhubert
from diffnorm_tpu.tasks.s2t_task import AudioFinetuningTask as JTask
from diffnorm_tpu.utils import convert_weights as jcw
from diffnorm_tpu_torch.cli import generate, train, validate
from diffnorm_tpu_torch.criterions.ctc_loss import CtcLoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.s2t_dataset import SpeechToTextDataset, write_s2t_manifest
from diffnorm_tpu_torch.models.hubert import HubertCTCModule
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.utils import convert_weights as cw
from diffnorm_tpu_torch.weights import flatten_tree, to_jax_variables
from tests.test_torch_ar_cli import save_orbax
from tests.test_torch_eval import _assert_generate_files_agree, _generate_lines
from tests.test_torch_hubert_pretrain import (
    CLI_TINY,
    SPEC,
    TINY,
    ZERO,
    fairseq_hubert_state,
    jtree,
    port_params,
    span_mask,
    wav_batch,
    write_pretrain_corpus,
    write_wav,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

LETTERS = list("abcdefghij") + ["|"]
VOCAB = len(LETTERS) + 4
WIDTHS = {k: v for k, v in CLI_TINY.items() if k != "final_dim"}
JWIDTHS = {**WIDTHS, "conv_feature_layers": [list(t) for t in SPEC]}


def flags(values):
    return [f"--{k.replace('_', '-')}" + ("" if v is True else f"={v}")
            for k, v in values.items()]


def write_ctc_corpus(root, seed=21, splits=(("train", 4), ("dev", 2), ("test", 3))):
    """16 kHz WAVs of 2000-4000 samples with 3-8 letters each, S2T manifests
    (n_frames the sample count) and a data config with use_audio_input and
    the letter dictionary."""
    rng = np.random.default_rng(seed)
    (root / "dict.ltr.txt").write_text("".join(f"{c} {50 - i}\n" for i, c in enumerate(LETTERS)))
    (root / "config.yaml").write_text(yaml.safe_dump({"use_audio_input": True,
                                                      "vocab_filename": "dict.ltr.txt"}))
    for split, n in splits:
        rows = []
        for i in range(n):
            size = int(rng.integers(2000, 4001))
            write_wav(root / f"{split}{i}.wav", rng.normal(size=size) * 0.1)
            text = " ".join(rng.choice(LETTERS, size=int(rng.integers(3, 9))))
            rows.append(dict(id=f"{split}{i}", audio=f"{split}{i}.wav", n_frames=size,
                             tgt_text=text))
        write_s2t_manifest(str(root / f"{split}.tsv"), rows)
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_ctc_corpus(tmp_path_factory.mktemp("ctc_data"))


@pytest.fixture(scope="module")
def ctc_pair():
    torch.manual_seed(5)
    model = HubertCTCModule(VOCAB, apply_mask=True, **TINY, **ZERO)
    return model, port_params(model, seed=5)


@pytest.mark.parametrize("mode", ["eval", "train_masked"])
def test_ctc_forward_matches_jax(ctc_pair, mode):
    """Frame logits and lengths against JAX's; in training with the time
    mask (mask_emb substituted) and the channel mask (dropouts 0), in eval
    with the masks given and ignored."""
    model, params = ctc_pair
    wav, lengths = wav_batch(seed=11)
    mask = span_mask(wav, lengths, seed=12)
    channel = np.zeros((2, 32), bool)
    channel[0, 4:9], channel[1, 20:23] = True, True
    train_ = mode != "eval"
    jm = jhubert.HubertCTCModule(vocab_size=VOCAB, apply_mask=True, feature_grad_mult=0.0,
                                 **{k: v for k, v in {**TINY, **ZERO}.items()
                                    if k != "dropout_input"})
    rngs = {"dropout": jax.random.PRNGKey(0)} if train_ else {}
    want = jm.apply({"params": jtree(params)}, jnp.asarray(wav[..., None]), jnp.asarray(lengths),
                    deterministic=not train_, mask_indices=jnp.asarray(mask),
                    channel_mask=jnp.asarray(channel), rngs=rngs)
    with torch.no_grad():
        got = model.train(train_)(torch.from_numpy(wav[..., None]), torch.from_numpy(lengths),
                                  mask_indices=torch.from_numpy(mask),
                                  channel_mask=torch.from_numpy(channel))
    np.testing.assert_array_equal(got["logit_lengths"].numpy(), np.asarray(want["logit_lengths"]))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-5,
                               rtol=1e-5)
    if train_:  # the masks moved the logits
        with torch.no_grad():
            plain = model.eval()(torch.from_numpy(wav), torch.from_numpy(lengths))["logits"]
        assert not torch.allclose(plain, got["logits"])


def test_ctc_criterion_matches_jax_with_a_row_that_cannot_align(ctc_pair):
    """Eval: loss (summed over rows / ntokens), nll_loss, n_emit and the
    counts within 1e-5 of JAX's, with the second row's target longer than
    its frames (optax's log-epsilon paths give it a large finite loss)."""
    model, params = ctc_pair
    wav, lengths = wav_batch(seed=13, lengths=(2400, 300))
    frames = jhubert.frames_for_samples(300, SPEC)
    tgt = np.full((2, frames + 4), 1, np.int32)
    tgt[0, :6] = [5, 6, 6, 7, 8, 2]
    tgt[1, :] = np.random.default_rng(14).integers(4, VOCAB, size=frames + 4)
    batch = dict(src_tokens=wav, src_lengths=lengths, target=tgt)
    jm = jhubert.HubertCTCModule(vocab_size=VOCAB, apply_mask=True,
                                 **{k: v for k, v in {**TINY, **ZERO}.items()
                                    if k != "dropout_input"})
    jloss, jmet, _ = JCtcLoss()(jm, {"params": jtree(params)}, batch, None, train=False)
    with torch.no_grad():
        loss, met = CtcLoss()(model.eval(), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(met) == sorted(jmet)
    for key, value in jmet.items():
        np.testing.assert_allclose(float(met[key]), float(value), rtol=1e-5, err_msg=key)
    assert float(loss) * int(met["ntokens"]) > 1e4  # the row that cannot align counts


def task_pair(root, **extra):
    values = {**WIDTHS, **extra}
    args = train.parse_args([str(root), "--task", "audio_finetuning", "--max-update", "1",
                             *flags(values)])
    jvalues = {**JWIDTHS, **{k: v for k, v in extra.items()}}
    return TASKS["audio_finetuning"](args), JTask(Config(task="audio_finetuning", data=str(root),
                                                         **jvalues))


def test_finetune_task_and_audio_input_batches_match_jax(corpus):
    """The use_audio_input dataset (waveforms [T, 1], no feature
    transforms, letters with EOS) and audio_finetuning's prepare_batch with
    --apply-mask (the time mask over the valid frames, the channel mask over
    the 32 channels) bit for bit from one generator seed; the unprepared
    dummy batch."""
    task, jtask = task_pair(corpus, apply_mask=True, mask_prob=0.3, mask_length=3,
                            mask_channel_prob=0.25, mask_channel_length=4)
    jds = JDataset.from_tsv(str(corpus), "train", JDictionary.load(str(corpus / "dict.ltr.txt")))
    tds = SpeechToTextDataset.from_tsv(str(corpus), "train",
                                       Dictionary.load(str(corpus / "dict.ltr.txt")))
    assert len(task.tgt_dict) == len(jtask.tgt_dict) == VOCAB
    want = jtask.prepare_batch(jds.collater([jds[0], jds[1], jds[3]]), np.random.default_rng(3))
    got = task.prepare_batch(tds.collater([tds[0], tds[1], tds[3]]), np.random.default_rng(3))
    assert got["src_tokens"].shape[2] == 1 and {"mask_indices", "channel_mask"} <= set(got)
    for ours, theirs in ((got, want), (task.dummy_batch(3, 2000), jtask.dummy_batch(3, 2000))):
        assert sorted(ours) == sorted(theirs)
        for key, value in theirs.items():
            np.testing.assert_array_equal(ours[key], value, err_msg=key)


def test_ctc_converter_and_w2v_graft_match_jax(tmp_path):
    """convert_hubert_ctc_checkpoint on a fairseq envelope (with mask_emb)
    and load_pretrained_encoder + graft_encoder_params from a HuBERT and a
    wav2vec2 pretraining .pt: trees bit for bit equal to JAX's; a depth or
    width that does not match raises."""
    import chip_smoke

    sd = fairseq_hubert_state(seed=2)
    ctc = {f"w2v_encoder.w2v_model.{k}": v for k, v in sd.items()}
    g = torch.Generator().manual_seed(6)
    ctc["w2v_encoder.proj.weight"] = torch.randn(VOCAB, 64, generator=g)
    ctc["w2v_encoder.proj.bias"] = torch.randn(VOCAB, generator=g)
    torch.save(chip_smoke.fairseq_envelope(torch, ctc), tmp_path / "ctc.pt")
    got = flatten_tree(cw.convert_hubert_ctc_checkpoint(str(tmp_path / "ctc.pt"), layers=2))
    want = flatten_tree(jcw.convert_hubert_ctc_checkpoint(str(tmp_path / "ctc.pt"), layers=2))
    assert sorted(got) == sorted(want) and ("params", "mask_emb") in got
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=str(key))
    cw.conversion_inventory(ctc, cw.convert_hubert_ctc_state(ctc, layers=2),
                            expected_unconsumed=cw.EXPECTED_UNCONSUMED["hubert_ctc"])

    w2v = {k: v for k, v in sd.items() if k != "label_embs_concat"}
    w2v["quantizer.vars"] = torch.rand(1, 12, 8, generator=g)
    for name, shape in (("quantizer.weight_proj", (12, 64)), ("project_q", (16, 16))):
        w2v[f"{name}.weight"] = torch.randn(*shape, generator=g)
        w2v[f"{name}.bias"] = torch.randn(shape[0], generator=g)
    torch.manual_seed(0)
    model = HubertCTCModule(VOCAB, dim=64, layers=2, heads=2, ffn_dim=128,
                            conv_feature_layers=SPEC, apply_mask=True)
    mine = to_jax_variables(model)
    for name, state in (("hubert", sd), ("wav2vec2", w2v)):
        torch.save({"model": state}, tmp_path / f"{name}.pt")
        enc, emb = cw.load_pretrained_encoder(str(tmp_path / f"{name}.pt"), layers=2)
        jenc, jemb = jcw.load_pretrained_encoder(str(tmp_path / f"{name}.pt"), layers=2)
        got = flatten_tree(cw.graft_encoder_params(mine, enc, mask_emb=emb))
        want = flatten_tree(jcw.graft_encoder_params(mine, jenc, mask_emb=jemb))
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=str(key))
    with pytest.raises(ValueError, match="transformer layers"):
        cw.load_pretrained_encoder(str(tmp_path / "hubert.pt"), layers=3)
    small = to_jax_variables(HubertCTCModule(VOCAB, **TINY, apply_mask=True))
    with pytest.raises(ValueError, match="does not match"):
        cw.graft_encoder_params(small, enc)


def test_cli_chain_matches_jax_cli(corpus, tmp_path):
    """cli.train hubert_pretraining (1 update) -> cli.train audio_finetuning
    --w2v-path on its step directory (2 updates with the time and channel
    masks, a frozen extractor and freeze_finetune_updates; the model built
    from the flags carries the pretraining encoder and mask_emb bit for
    bit; a resume to 3 updates drops --w2v-path) -> cli.validate ->
    cli.generate against JAX's cli.generate on an orbax copy of the same
    weights: generate-test.txt's lines agree."""
    (tmp_path / "pre").mkdir()
    pre = write_pretrain_corpus(tmp_path / "pre")
    common = ["--cpu", "--lr", "1e-3", "--warmup-updates", "2", "--log-interval", "1",
              "--seed", "3", "--validate-interval", "5"]
    assert train.main([str(pre), "--task", "hubert_pretraining", "--save-dir",
                       str(pre / "ckpt"), "--max-update", "1", "--max-tokens", "8000",
                       "--max-sample-size", "2000", "--min-sample-size", "1000",
                       "--mask-prob", "0.4", "--mask-length", "3", *common,
                       *flags(CLI_TINY)]) == 0
    pre_step = pre / "ckpt" / "step_000000001"
    fine = dict(WIDTHS, apply_mask=True, mask_prob=0.3, mask_length=3, mask_channel_prob=0.25,
                mask_channel_length=4, feature_grad_mult=0.0)
    base = [str(corpus), "--task", "audio_finetuning", *flags(fine)]
    args = train.parse_args(base + ["--max-update", "1", "--w2v-path", str(pre_step)])
    pre_params = load_variables(str(pre_step))["params"]
    grafted = to_jax_variables(TASKS["audio_finetuning"](args).build_model())["params"]
    for key, value in flatten_tree(pre_params["encoder"]).items():
        np.testing.assert_array_equal(flatten_tree(grafted["w2v_model"])[key], value)
    np.testing.assert_array_equal(grafted["mask_emb"], pre_params["mask_emb"])

    save = tmp_path / "ft"
    run = base + ["--save-dir", str(save), "--max-tokens", "12000", "--w2v-path",
                  str(pre_step), "--freeze-finetune-updates", "1", *common]
    assert train.main(run + ["--max-update", "2"]) == 0
    assert train.main(run + ["--max-update", "3"]) == 0  # resumes; --w2v-path ignored
    step = save / "step_000000003"
    assert validate.main(base + ["--cpu", "--path", str(step), "--valid-subset", "dev",
                                 "--max-tokens", "12000"]) == 0
    save_orbax(tmp_path / "ft_ck", load_variables(str(step)))
    from diffnorm_tpu.cli import generate as jax_generate

    out = tmp_path / "gen"
    assert jax_generate.main(Config(data=str(corpus), cpu=True, gen_subset="test",
                                    task="audio_finetuning", arch="hubert_ctc",
                                    path=str(tmp_path / "ft_ck"), max_tokens=12000,
                                    results_path=str(out / "jax"), apply_mask=True,
                                    **JWIDTHS)) == 0
    assert generate.main(base + ["--cpu", "--path", str(step), "--gen-subset", "test",
                                 "--max-tokens", "12000", "--results-path",
                                 str(out / "port")]) == 0
    got = _generate_lines(out / "port" / "generate-test.txt")
    want = _generate_lines(out / "jax" / "generate-test.txt")
    _assert_generate_files_agree(got, want)
    assert sum(1 for line in got if line.startswith("D-")) == 3


@pytest.mark.parametrize("name", ["dummy_hubert", "dummy_wav2vec2", "dummy_ctc"])
def test_dummy_tasks_train_in_process(tmp_path, name):
    """Each dummy task serves `dataset_size` copies of its task's dummy
    batch (JAX's _SyntheticDataset), and the Trainer takes an update on it
    at tiny width: a finite loss and gradient norm."""
    from diffnorm_tpu_torch.train.trainer import Trainer

    real = {"dummy_hubert": "hubert_pretraining", "dummy_wav2vec2": "audio_pretraining",
            "dummy_ctc": "audio_finetuning"}[name]
    values = {**CLI_TINY, "tokens_per_sample": 2400}
    args = train.parse_args([str(tmp_path), "--task", real, "--max-update", "1",
                             "--target-code-size", "8", *flags(values)])
    args.task = name
    task = TASKS[name](args)
    ds = task.dataset("train")
    assert len(ds) == 4 and all(b is ds[0] for b in ds)
    for key, value in task.dummy_batch(2, 2400).items():
        np.testing.assert_array_equal(ds[0][key], value, err_msg=key)
    torch.manual_seed(0)
    trainer = Trainer(train.trainer_config(args), task.build_model(), task.build_criterion())
    mets = trainer.train_step([ds[0]])
    assert np.isfinite(mets["loss"]) and np.isfinite(mets["gnorm"])
