"""The two-pass and spectrogram families through the port's CLIs on the CPU
at tiny widths: cli.train --task speech_to_speech (--target-is-code,
--arch unity_conformer, speech_to_unit_2pass) for 2 updates, then
cli.generate on its step directory against JAX's cli.generate on the same
weights (an orbax copy): generate-test.txt line for line; Translatotron2
(s2spect2_conformer, speech_to_spectrogram_2pass) through cli.train and
cli.generate, whose `{id}.npy` frames equal the port's in-process
translatotron2_generate with the same seed (prenet dropout on), with a
mel-input vocoder writing `{id}_pred.wav`; cli.validate for both; and the
refusals: fastspeech2 under the spectrogram task and text MT (ROADMAP), a
criterion a two-pass model does not train with."""

import json

import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.weights import save_npz
from tests.test_torch_ar_cli import save_orbax
from tests.test_torch_eval import _assert_generate_files_agree, _generate_lines
from tests.test_torch_repr_to_speech import VOC_CFG
from tests.test_torch_s2spect import MEL, write_spect_corpus
from tests.test_torch_s2spect import TINY as SPECT_TINY
from tests.test_torch_unity import WIDTHS as UNITY_WIDTHS
from tests.test_torch_unity import write_unity_corpus
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

SPLITS = (("train", 4), ("dev", 2), ("test", 3))
MAX_TOKENS = "240"
TRAIN = ["--cpu", "--max-update", "2", "--max-tokens", MAX_TOKENS, "--lr", "1e-3",
         "--warmup-updates", "2", "--log-interval", "1", "--seed", "3",
         "--validate-interval", "5"]
UNITY = {**UNITY_WIDTHS, "multitask_config_yaml": "multitask.yaml",
         "synthesizer_encoder_layers": 1}
SPECT = {**{k: v for k, v in SPECT_TINY.items() if k != "prenet_dropout"},
         "multitask_config_yaml": "multitask.yaml", "translation_decoder_layers": 2,
         "synthesizer_encoder_layers": 1}


def flags(values):
    return [f"--{k.replace('_', '-')}={v}" for k, v in values.items()]


@pytest.fixture(scope="module")
def unity_trained(tmp_path_factory):
    """cli.train on UnitY: (root, the step directory)."""
    from diffnorm_tpu_torch.cli import train

    root = write_unity_corpus(tmp_path_factory.mktemp("unity_cli"), splits=SPLITS)
    save_dir = root / "ckpt"
    assert train.main([str(root), "--task", "speech_to_speech", "--target-is-code",
                       "--arch", "unity_conformer", "--save-dir", str(save_dir), *TRAIN,
                       *flags(UNITY)]) == 0
    step = save_dir / "step_000000002"
    variables = load_variables(str(step))
    assert {"encoder", "decoder", "mt_target_letter_decoder", "synthesizer_encoder",
            "mt_source_unigram_ctc"} <= set(variables["params"])
    return root, step


def test_unity_cli_generate_matches_jax_cli(unity_trained):
    """Both beam passes (--beam 3, --beam-mt 2, --max-len-b-mt 6, ngram
    blocking 2): the port's H- and D- lines equal to JAX's on the same
    weights (tokens equal, scores within 2e-4), the summary line equal."""
    from diffnorm_tpu.cli import generate as jax_generate
    from diffnorm_tpu_torch.cli import generate

    root, step = unity_trained
    save_orbax(root / "unity_ck", load_variables(str(step)))
    opts = dict(beam=3, beam_mt=2, max_len_b_mt=6, no_repeat_ngram_size=2,
                max_target_positions=10)
    assert jax_generate.main(Config(
        data=str(root), cpu=True, gen_subset="test", max_tokens=int(MAX_TOKENS),
        task="speech_to_speech", target_is_code=True, arch="unity_conformer",
        path=str(root / "unity_ck"), results_path=str(root / "jax"), **UNITY, **opts)) == 0
    assert generate.main([str(root), "--cpu", "--gen-subset", "test", "--max-tokens",
                          MAX_TOKENS, "--task", "speech_to_speech", "--target-is-code",
                          "--arch", "unity_conformer", "--path", str(step), "--results-path",
                          str(root / "port"), *flags(UNITY), *flags(opts)]) == 0
    got = _generate_lines(root / "port" / "generate-test.txt")
    want = _generate_lines(root / "jax" / "generate-test.txt")
    _assert_generate_files_agree(got, want)
    hyps = [line.split("\t")[2] for line in got if line.startswith("H-")]
    assert len(hyps) == 3 and got[-1].startswith("Generate test with beam=3: ")


def test_unity_cli_validate(unity_trained):
    """cli.validate --arch unity_conformer on the step directory: the 2-pass
    criterion's metrics over dev, the first pass's term among them."""
    from diffnorm_tpu_torch.cli import validate

    root, step = unity_trained
    got = validate.validate(validate.parse_args(
        [str(root), "--cpu", "--task", "speech_to_speech_ar", "--arch", "unity_conformer",
         "--valid-subset", "dev", "--max-tokens", MAX_TOKENS, "--path", str(step),
         *flags(UNITY)]))
    assert got["nsentences"] == 2 and np.isfinite(got["loss"]) and got["loss"] > 0
    assert np.isfinite(got["multitask_target_letter_loss"])


def test_translatotron2_cli_train_generate_validate(tmp_path):
    """cli.train --task speech_to_speech --arch s2spect2_conformer (prenet
    dropout 0.5), cli.generate with a mel-input vocoder: each `{id}.npy`
    equal to the in-process rollout of the same weights with a generator
    seeded --seed (one batch), the MT- lines logged, `{id}_pred.wav` of
    frames x hop samples; cli.validate's metrics finite."""
    from diffnorm_tpu_torch.cli import generate, train, validate
    from diffnorm_tpu_torch.data.dictionary import Dictionary
    from diffnorm_tpu_torch.generate.translatotron2 import translatotron2_generate
    from diffnorm_tpu_torch.models.hifigan import FeatureGenerator
    from diffnorm_tpu_torch.weights import to_jax_variables

    root = write_spect_corpus(tmp_path, splits=SPLITS)
    assert train.main([str(root), "--task", "speech_to_speech", "--arch",
                       "s2spect2_conformer", "--save-dir", str(root / "ckpt"), *TRAIN,
                       *flags(SPECT)]) == 0
    step = root / "ckpt" / "step_000000002"
    assert "postnet" in load_variables(str(step))["batch_stats"]
    torch.manual_seed(0)
    voc = FeatureGenerator(**{**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in VOC_CFG.items() if k != "model_in_dim"},
                              "feature_dim": MEL,
                              "resblock_dilation_sizes": ((1, 2),)})
    save_npz(str(root / "voc.npz"), to_jax_variables(voc))
    (root / "voc.json").write_text(json.dumps({k: v for k, v in VOC_CFG.items()
                                               if k != "model_in_dim"}))
    gen_flags = [str(root), "--cpu", "--gen-subset", "test", "--max-tokens", "1000",
                 "--task", "speech_to_speech", "--arch", "s2spect2_conformer",
                 "--path", str(step), "--beam", "2", "--max-target-positions", "10",
                 "--max-len-b-mt", "8", "--seed", "5", *flags(SPECT)]
    assert generate.main(gen_flags + ["--results-path", str(root / "out"), "--vocoder",
                                      str(root / "voc.npz"), "--vocoder-cfg",
                                      str(root / "voc.json")]) == 0
    args = generate.parse_args(gen_flags)
    task, model = generate.build_task_model(args, str(step), torch.device("cpu"),
                                            torch.float32)
    batch = task.dataset("test").collater([task.dataset("test")[i] for i in range(3)])
    feat, out_lens, _, mt_best = translatotron2_generate(
        model, torch.from_numpy(batch["src_tokens"]), torch.from_numpy(batch["src_lengths"]),
        beam_size_mt=2, max_len_mt=8, max_iter=10,
        generator=torch.Generator().manual_seed(5))
    assert len(set(out_lens.tolist())) >= 1 and mt_best.shape[0] == 3
    for i, sid in enumerate(batch["id"].tolist()):
        got = np.load(root / "out" / f"{sid}.npy")
        np.testing.assert_array_equal(got, feat[i, :int(out_lens[i])].numpy())
        wav_frames = got.shape[0] * int(np.prod(VOC_CFG["upsample_rates"]))
        import wave

        with wave.open(str(root / "out" / f"{sid}_pred.wav")) as w:
            assert w.getnframes() == wav_frames
    assert isinstance(task.multitask_tasks["target_letter"].tgt_dict, Dictionary)
    got = validate.validate(validate.parse_args(
        [str(root), "--cpu", "--task", "speech_to_speech_spect", "--arch",
         "s2spect2_conformer", "--valid-subset", "dev", "--max-tokens", MAX_TOKENS,
         "--path", str(step), *flags(SPECT)]))
    assert got["nsentences"] == 2 and all(np.isfinite(v) for v in got.values())
    assert {"l1_loss", "mse_loss", "eos_loss", "multitask_target_letter_loss"} <= set(got)


def test_cli_refusals(tmp_path):
    """fastspeech2 is not a spectrogram translator (it is text_to_speech's,
    ported since: tests/test_torch_tts_s2t_cli.py) and SEDD has no decode
    branch (it samples in process, as in JAX; text MT is ported since:
    tests/test_torch_text_cli.py); a two-pass model trains with its own criterion alone,
    and a single-pass one not with it; --task speech_to_speech picks its
    task on --target-is-code."""
    from diffnorm_tpu_torch.cli import generate, train

    base = [str(tmp_path), "--cpu", "--path", "m.npz"]
    for extra in (["--task", "sedd"],
                  ["--task", "speech_to_speech", "--arch", "fastspeech2"]):
        with pytest.raises(NotImplementedError, match="no decode branch"):
            generate.parse_args(base + extra)
    tr = [str(tmp_path), "--cpu", "--max-update", "1", "--task", "speech_to_speech"]
    with pytest.raises(SystemExit):
        train.parse_args(tr + ["--target-is-code", "--arch", "unity_conformer", "--criterion",
                               "speech_to_unit"])
    with pytest.raises(SystemExit):
        train.parse_args(tr + ["--arch", "s2spect_conformer", "--criterion",
                               "speech_to_spectrogram_2pass"])
    with pytest.raises(SystemExit):
        train.parse_args(tr + ["--arch", "s2spect_conformer", "--target-speaker-embed"])
    args = train.parse_args(tr + ["--target-is-code", "--arch", "unity_conformer"])
    assert (args.task, args.criterion, args.encoder_layers, args.decoder_embed_dim,
            args.translation_decoder_layers) == (
        "speech_to_speech_ar", "speech_to_unit_2pass", 16, 256, 4)
    args = train.parse_args(tr + ["--arch", "s2spect2_conformer"])
    assert (args.task, args.criterion, args.decoder_embed_dim, args.decoder_ffn_embed_dim,
            args.output_frame_dim, args.prenet_dim) == (
        "speech_to_speech_spect", "speech_to_spectrogram_2pass", 512, 2048, 80, 256)
    args = train.parse_args(tr + ["--arch", "s2spect_transformer_fisher"])
    assert (args.encoder_embed_dim, args.prenet_dim, args.encoder_type,
            args.criterion) == (256, 32, "transformer", "speech_to_spectrogram")
    with pytest.raises(NotImplementedError, match="n_frames_per_step"):
        generate.parse_args(base + ["--task", "speech_to_speech_ar", "--arch",
                                    "unity_conformer", "--n-frames-per-step", "2"])
