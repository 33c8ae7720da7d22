"""Text-input TTS and the S2T model through the port's CLIs on the CPU at
tiny widths: cli.train (2 updates) -> cli.validate -> cli.generate for the
tts_transformer (the prenet's dropout 0.5 on), FastSpeech2 and
s2t_transformer_xs, each CLI's output against the same computation in
process on the same weights: cli.validate's metrics against the trainer's
valid step over the same batch (rtol 1e-6); the TTS `{id}.npy` frames
against `ar_speech_generate` with a generator seeded --seed and against
FastSpeech2's forward cut by its frame mask (equal), with a mel-input
vocoder's `{id}_pred.wav`; the S2T H- lines against `ar_generate` (beam
and --sampling; equal strings) and --score-reference's against the
references, with T- lines and the BLEU line as JAX's
tests/test_cli_chains.py::test_s2t_transformer_train_generate_chain reads
them; and the refusals of the options these models lack."""

import copy
import json
import re
import wave

import numpy as np
import pytest
import torch

from diffnorm_tpu_torch.cli import generate, train, validate
from diffnorm_tpu_torch.cli.generate import strip_special
from diffnorm_tpu_torch.generate.beam_search import ar_generate
from diffnorm_tpu_torch.generate.speech_ar import ar_speech_generate
from diffnorm_tpu_torch.models.fastspeech2 import NonARSpeechGenerator
from diffnorm_tpu_torch.models.hifigan import FeatureGenerator
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
from diffnorm_tpu_torch.weights import from_jax_variables, save_npz, to_jax_variables
from tests.test_torch_repr_to_speech import VOC_CFG
from tests.test_torch_s2t import TINY as S2T_TINY
from tests.test_torch_s2t import write_s2t_corpus
from tests.test_torch_tts import FS2_TINY, MEL, TTS_TINY, write_tts_corpus
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

TRAIN = ["--cpu", "--max-update", "2", "--lr", "1e-3", "--warmup-updates", "2",
         "--log-interval", "1", "--seed", "3", "--validate-interval", "5"]
TTS = {k: v for k, v in TTS_TINY.items() if k != "prenet_dropout"}


def flags(values):
    return [f"--{k.replace('_', '-')}={v}" for k, v in values.items()]


def trained(root, task, arch, widths, max_tokens):
    """cli.train for 2 updates: the step directory."""
    assert train.main([str(root), "--task", task, "--arch", arch, "--save-dir",
                       str(root / "ckpt"), "--max-tokens", max_tokens, *TRAIN,
                       *flags(widths)]) == 0
    return root / "ckpt" / "step_000000002"


def assert_validate_matches(root, task_name, arch, widths, step, keys):
    """cli.validate on `step` against the trainer's valid step over the dev
    split's one batch, in the dataset's order."""
    base = [str(root), "--cpu", "--task", task_name, "--arch", arch, "--valid-subset", "dev",
            "--max-tokens", "4000", *flags(widths)]
    got = validate.validate(validate.parse_args(base + ["--path", str(step)]))
    args = train.parse_args(base + ["--max-update", "1"])
    task = TASKS[args.task](args)
    torch.manual_seed(args.seed)
    model = from_jax_variables(task.build_model(), load_variables(str(step)))
    trainer = Trainer(TrainerConfig(seed=args.seed), model, task.build_criterion())
    ds = task.dataset("dev")
    batch = task.prepare_batch(ds.collater([ds[int(i)] for i in ds.ordered_indices()]),
                               np.random.default_rng(args.seed))
    want = trainer.valid_step(batch, torch.Generator().manual_seed(0))
    assert got["nsentences"] == 2
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    return got


@pytest.fixture(scope="module")
def vocoder(tmp_path_factory):
    """A seeded mel-input FeatureGenerator's .npz and config (MEL bins)."""
    root = tmp_path_factory.mktemp("voc")
    torch.manual_seed(0)
    voc = FeatureGenerator(**{**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in VOC_CFG.items() if k != "model_in_dim"},
                              "feature_dim": MEL, "resblock_dilation_sizes": ((1, 2),)})
    save_npz(str(root / "voc.npz"), to_jax_variables(voc))
    (root / "voc.json").write_text(json.dumps({k: v for k, v in VOC_CFG.items()
                                               if k != "model_in_dim"}))
    return ["--vocoder", str(root / "voc.npz"), "--vocoder-cfg", str(root / "voc.json")]


def test_tts_transformer_cli_train_validate_generate(tmp_path, vocoder):
    """The tts_transformer: cli.validate's l1, mse and eos losses against the
    valid step (the prenet drawing from a generator seeded 0 in both); every
    `{id}.npy` of cli.generate (10 rollout steps, --seed 5) equal to the
    in-process rollout with a generator seeded 5, each `{id}_pred.wav` of
    frames x hop samples."""
    root = write_tts_corpus(tmp_path, variances=False)
    step = trained(root, "text_to_speech", "tts_transformer", TTS, "40")
    assert {"enc_bn_0", "enc_bn_1", "postnet"} <= set(load_variables(str(step))["batch_stats"])
    assert_validate_matches(root, "text_to_speech", "tts_transformer", TTS, step,
                            ("loss", "l1_loss", "mse_loss", "eos_loss", "ntokens"))
    gen_flags = [str(root), "--cpu", "--gen-subset", "test", "--max-tokens", "1000",
                 "--task", "text_to_speech", "--arch", "tts_transformer", "--path", str(step),
                 "--max-target-positions", "10", "--seed", "5", *flags(TTS)]
    assert generate.main(gen_flags + ["--results-path", str(root / "out"), *vocoder]) == 0
    task, model = generate.build_task_model(generate.parse_args(gen_flags), str(step),
                                            torch.device("cpu"), torch.float32)
    assert model.dec_prenet.p == 0.5
    ds = task.dataset("test")
    batch = ds.collater([ds[int(i)] for i in ds.ordered_indices()])
    feat, out_lens, _ = ar_speech_generate(model, torch.from_numpy(batch["src_tokens"]),
                                           max_iter=10, generator=torch.Generator().manual_seed(5))
    hop = int(np.prod(VOC_CFG["upsample_rates"]))
    for i, sid in enumerate(batch["id"].tolist()):
        got = np.load(root / "out" / f"{sid}.npy")
        np.testing.assert_array_equal(got, feat[i, :int(out_lens[i])].numpy())
        with wave.open(str(root / "out" / f"{sid}_pred.wav")) as w:
            assert w.getnframes() == got.shape[0] * hop


def test_fastspeech2_cli_train_validate_generate(tmp_path, vocoder):
    """FastSpeech2 on gold durations, pitches and energies: cli.validate's
    l1, duration, pitch and energy losses against the valid step; then
    cli.generate on the trained weights with the duration head's bias set to
    log(1 + 2) (so the rows have frames): every `{id}.npy` equal to the
    in-process forward on predicted variances cut by its frame mask, and
    its `{id}_pred.wav`."""
    root = write_tts_corpus(tmp_path)
    step = trained(root, "text_to_speech", "fastspeech2", FS2_TINY, "40")
    got = assert_validate_matches(root, "text_to_speech", "fastspeech2", FS2_TINY, step,
                                  ("loss", "l1_loss", "dur_loss", "pitch_loss", "energy_loss"))
    assert got["sample_size"] == 2
    variables = copy.deepcopy(load_variables(str(step)))
    variables["params"]["dur_predictor"]["proj"]["bias"] = np.asarray([np.log(3.0)],
                                                                      np.float32)
    save_npz(str(root / "fs2.npz"), variables)
    gen_flags = [str(root), "--cpu", "--gen-subset", "test", "--max-tokens", "1000",
                 "--task", "text_to_speech", "--arch", "fastspeech2", "--path",
                 str(root / "fs2.npz"), *flags(FS2_TINY)]
    assert generate.main(gen_flags + ["--results-path", str(root / "out"), *vocoder]) == 0
    task, model = generate.build_task_model(generate.parse_args(gen_flags),
                                            str(root / "fs2.npz"), torch.device("cpu"),
                                            torch.float32)
    assert model.max_frames == 32
    ds = task.dataset("test")
    batch = ds.collater([ds[int(i)] for i in ds.ordered_indices()])
    out = NonARSpeechGenerator(model).generate(torch.from_numpy(batch["src_tokens"]))
    lengths = []
    for i, sid in enumerate(batch["id"].tolist()):
        got = np.load(root / "out" / f"{sid}.npy")
        np.testing.assert_array_equal(got, out["feature"][i][out["frame_mask"][i]])
        lengths.append(got.shape[0])
        with wave.open(str(root / "out" / f"{sid}_pred.wav")) as w:
            assert w.getnframes() == got.shape[0] * int(np.prod(VOC_CFG["upsample_rates"]))
    assert min(lengths) > 0


def test_s2t_cli_train_validate_generate(tmp_path):
    """s2t_transformer_xs on the word dictionary of the data config:
    cli.validate's loss, nll_loss and acc against the valid step; cli.generate
    with beam 2 and with --sampling (--seed 7): H- lines equal to in-process
    ar_generate decodes through the dictionary, T- lines the references, a
    BLEU summary line; --score-reference: each H- line its reference, its
    score a negative mean log-prob."""
    root = write_s2t_corpus(tmp_path)
    step = trained(root, "speech_to_text", "s2t_transformer_xs", S2T_TINY, "400")
    assert_validate_matches(root, "speech_to_text", "s2t_transformer_xs", S2T_TINY, step,
                            ("loss", "nll_loss", "acc", "ntokens"))
    base = [str(root), "--cpu", "--gen-subset", "test", "--max-tokens", "1000", "--task",
            "speech_to_text", "--arch", "s2t_transformer_xs", "--path", str(step),
            "--max-target-positions", "8", *flags(S2T_TINY)]
    task, model = generate.build_task_model(generate.parse_args(base), str(step),
                                            torch.device("cpu"), torch.float32)
    ds = task.dataset("test")
    batch = ds.collater([ds[int(i)] for i in ds.ordered_indices()])
    src, lengths = torch.from_numpy(batch["src_tokens"]), torch.from_numpy(batch["src_lengths"])
    sampler = torch.Generator().manual_seed(7)
    for i, (extra, decode) in enumerate((
            (["--beam", "2"], lambda: ar_generate(model, src, lengths, beam_size=2,
                                                  max_len=8)[0][:, 0]),
            (["--beam", "2", "--sampling", "--seed", "7"], lambda: ar_generate(
                model, src, lengths, beam_size=2, max_len=8, sampling=True,
                generator=sampler)[0][:, 0]),
            (["--score-reference"], None))):
        out = root / f"gen{i}"
        assert generate.main(base + extra + ["--results-path", str(out)]) == 0
        text = (out / "generate-test.txt").read_text()
        lines = dict(re.findall(r"^([HT]-\d+)\t(.*)$", text, flags=re.M))
        refs = {k[2:]: v for k, v in lines.items() if k.startswith("T-")}
        hyps = {k[2:]: v.split("\t")[1] if "\t" in v else "" for k, v in lines.items()
                if k.startswith("H-")}
        assert re.search(r"BLEU4? = [0-9.]+", text) and len(refs) == 3
        assert refs == {str(sid): strip_special(batch["target"][j], task.tgt_dict)
                        for j, sid in enumerate(batch["id"].tolist())}
        if decode is None:
            assert hyps == refs
            scores = [float(v.split("\t")[0]) for k, v in lines.items() if k.startswith("H-")]
            assert all(s < 0 for s in scores)
            continue
        with torch.no_grad():
            tokens = decode().numpy()
        assert hyps == {str(sid): strip_special(tokens[j], task.tgt_dict)
                        for j, sid in enumerate(batch["id"].tolist())}


def test_cli_refusals_and_arch_defaults(tmp_path):
    """The TTS and S2T tasks refuse the options their models lack, a
    criterion of the other TTS model and the S2T flags elsewhere; the arch
    chains give the published widths (s2t_transformer_xs from _s from the
    base)."""
    tr = [str(tmp_path), "--cpu", "--max-update", "1"]
    for extra in (["--task", "text_to_speech", "--arch", "fastspeech2", "--criterion",
                   "tacotron2_loss"],
                  ["--task", "text_to_speech", "--multitask-config-yaml", "m.yaml"],
                  ["--task", "speech_to_text", "--n-frames-per-step", "2"],
                  ["--task", "speech_to_text", "--target-speaker-embed"],
                  ["--task", "speech_to_speech_ar", "--share-decoder-input-output-embed"]):
        with pytest.raises(SystemExit):
            train.parse_args(tr + extra)
    args = train.parse_args(tr + ["--task", "speech_to_text", "--arch", "s2t_transformer_xs"])
    assert (args.encoder_embed_dim, args.encoder_ffn_embed_dim, args.encoder_layers,
            args.decoder_layers, args.decoder_embed_dim, args.decoder_ffn_embed_dim,
            args.encoder_attention_heads, args.decoder_attention_heads, args.encoder_type,
            args.criterion, args.label_smoothing) == (
        256, 1024, 6, 3, 256, 1024, 4, 4, "transformer", "label_smoothed_cross_entropy", 0.1)
    args = train.parse_args(tr + ["--task", "speech_to_text", "--arch", "s2t_conformer"])
    assert (args.encoder_type, args.encoder_layers, args.decoder_attention_heads) == (
        "conformer", 16, 8)
    args = train.parse_args(tr + ["--task", "text_to_speech", "--arch", "fastspeech2_base"])
    assert (args.criterion, args.encoder_embed_dim, args.encoder_attention_heads,
            args.max_target_positions) == ("fastspeech2_loss", 256, 2, None)
    args = train.parse_args(tr + ["--task", "text_to_speech"])
    assert (args.arch, args.criterion, args.encoder_transformer_layers,
            args.encoder_conv_layers, args.encoder_dropout, args.prenet_dim) == (
        "tts_transformer", "tacotron2_loss", 6, 3, 0.5, 256)
    gen = [str(tmp_path), "--cpu", "--path", "m.npz"]
    assert generate.parse_args(gen + ["--task", "text_to_speech", "--arch",
                                      "fastspeech2"]).model.criterion == "fastspeech2_loss"
    with pytest.raises(NotImplementedError, match="no decode branch"):
        generate.parse_args(gen + ["--task", "speech_to_text", "--arch", "cmlm_transformer"])
