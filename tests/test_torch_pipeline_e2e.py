"""DiffNorm's recipe end to end through the port's CLIs: the twin of
tests/test_pipeline_e2e.py, its eight stages on its synthetic data at its
tiny widths, on the CPU.

Each stage runs the command of its recipe script with that script's own
flags, read from scripts/{vae_train,diffusion_train,unit_gen,s2ut_train,
s2ut_eval,full_recipe}.sh with `diffnorm_tpu` swapped for
`diffnorm_tpu_torch`, then `--cpu`, the tiny widths, 2 updates and float32
appended (argparse takes the last value). Each stage hands the next the
last `step_*` directory, as full_recipe.sh does. Stage 3 runs a second time
from a fairseq-layout normalizer `.pt` through cli.convert_checkpoint.

  1. cli.train --task speech_decoder          (scripts/vae_train.sh)
  2. cli.train --task speech_diffusion_discrete (scripts/diffusion_train.sh)
  3. cli.diff_norm_synthesis --ckpt           (scripts/unit_gen.sh)
  4. cli.train --task speech_to_speech_fasttranslate (scripts/s2ut_train.sh)
  5. cli.generate, eval.unit_bleu             (scripts/s2ut_eval.sh)
  6. cli.train_vocoder                        (scripts/full_recipe.sh:36-42)
  7. cli.generate_waveform --dur-prediction   (scripts/s2ut_eval.sh)
  8. eval.asr_bleu over a tiny CTC checkpoint (scripts/s2ut_eval.sh)
"""

import importlib
import json
import re
import shlex
import wave
from pathlib import Path

import numpy as np
import torch
import yaml

import chip_smoke
from tests.test_pipeline_e2e import CODE_SIZE, FEAT_DIM, synth_data
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
VAE_WIDTHS = ["--feature-dim", str(FEAT_DIM), "--latent-dim", "3", "--chan-mults", "[4]",
              "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
              "--vae-decoder-heads", "2"]
DIFF_WIDTHS = ["--hidden-dim", "16", "--denoiser-depth", "1", "--wavenet-layers", "2",
               "--wavenet-stacks", "1", "--timesteps", "8"]
NAR_WIDTHS = ["--encoder-layers", "1", "--decoder-layers", "1", "--encoder-embed-dim", "16",
              "--encoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2",
              "--decoder-attention-heads", "2", "--decoder-embed-dim", "16",
              "--decoder-ffn-embed-dim", "32", "--conv-channels", "16",
              "--depthwise-conv-kernel-size", "7"]
TRAIN = ["--cpu", "--dtype", "float32", "--max-update", "2", "--warmup-updates", "2",
         "--log-interval", "1", "--target-code-size", str(CODE_SIZE)]
VOCODER_CFG = dict(num_embeddings=CODE_SIZE, embedding_dim=8, upsample_rates=[4, 2],
                   upsample_kernel_sizes=[8, 4], upsample_initial_channel=16,
                   resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]],
                   dur_predictor_params={"var_pred_hidden_dim": 8})


def script_commands(script: str, env: dict):
    """[(port module, argv)] of the `python -m diffnorm_tpu.*` commands of
    scripts/`script`, with $var / ${VAR:-default} taken from `env` (else
    the default)."""
    text = (REPO / "scripts" / script).read_text().replace("\\\n", " ")

    def sub(m):
        name, default = m.group(1) or m.group(3), m.group(2)
        if name in env:
            return str(env[name])
        if default is None or not default.startswith(":-"):
            raise KeyError(f"{script} needs ${name}")
        return default[2:]

    out = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("python -m diffnorm_tpu."):
            line = re.sub(r"\$\{(\w+)(:[-?][^}]*)?\}|\$(\w+)", sub, line)
            words = shlex.split(line)
            out.append((words[2].replace("diffnorm_tpu.", "diffnorm_tpu_torch.", 1), words[3:]))
    return out


def run(module: str, argv) -> None:
    assert importlib.import_module(module).main(list(argv)) == 0, (module, argv)


def last_step(save_dir: Path) -> Path:
    steps = sorted(p for p in save_dir.iterdir() if p.is_dir() and p.name.startswith("step_"))
    assert steps, list(save_dir.iterdir())
    return steps[-1]


def test_recipe_end_to_end_through_the_port_clis(tmp_path, capsys):
    root, feat_dir = synth_data(tmp_path)
    ckpt = tmp_path / "ckpt"

    # 1.-2. the VAE, then the normalizer over its last step directory
    [(module, argv)] = script_commands("vae_train.sh", dict(
        data_dir=root, feat_dir=feat_dir, latent_dim=3, out=ckpt / "vae"))
    run(module, argv + TRAIN + VAE_WIDTHS)
    [(module, argv)] = script_commands("diffusion_train.sh", dict(
        data_dir=root, feat_dir=feat_dir, latent_dim=3, vae_ckpt=last_step(ckpt / "vae"),
        out=ckpt / "diffusion"))
    run(module, argv + TRAIN + VAE_WIDTHS + DIFF_WIDTHS)
    log = capsys.readouterr().err
    assert "restored the frozen VAE" in log and "saved checkpoint at step 2" in log

    # 3. DDIM normalization, from the trained normalizer and from a
    # fairseq-layout .pt converted by cli.convert_checkpoint
    synth = ["--cpu", "--start-step", "4", "--vocab-size", str(CODE_SIZE + 4),
             *VAE_WIDTHS, *DIFF_WIDTHS]
    norm = tmp_path / "normalized"
    [(module, argv)] = script_commands("unit_gen.sh", dict(
        data_dir=root, feat_dir=feat_dir, diff_ckpt=last_step(ckpt / "diffusion"),
        LATENT_DIM=3, out_dir=norm, start_step=4))
    assert "--ckpt" in argv
    run(module, argv + synth)
    sd = chip_smoke.fairseq_diffusion_state(
        torch, 3, dim=16, latent_dim=3, feature_dim=FEAT_DIM, vocab_size=CODE_SIZE + 4,
        denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, vae_decoder_depth=1,
        vae_decoder_dim_head=8, vae_decoder_heads=2, chan_mults=[4])
    torch.save(chip_smoke.fairseq_envelope(torch, sd), tmp_path / "diff_discrete.pt")
    run("diffnorm_tpu_torch.cli.convert_checkpoint",
        ["--type", "diffusion", "--input", str(tmp_path / "diff_discrete.pt"),
         "--output", str(ckpt / "converted")])
    [(module, argv)] = script_commands("unit_gen.sh", dict(
        data_dir=root, feat_dir=feat_dir, diff_ckpt=ckpt / "converted", LATENT_DIM=3,
        out_dir=tmp_path / "normalized_converted", start_step=4))
    run(module, argv + synth)
    for out in (norm, tmp_path / "normalized_converted"):
        rows = (out / "train.tsv").read_text().splitlines()[1:]
        assert len(rows) == 6
        for row in rows:
            units = [int(u) for u in row.split("\t")[3].split()]
            assert all(-4 <= u < CODE_SIZE for u in units)
            assert all(a != b for a, b in zip(units, units[1:]))  # reduced
    (norm / "config.yaml").write_text(yaml.safe_dump({
        "input_feat_per_channel": 80, "transforms": {"*": ["utterance_cmvn"]}}))

    # 4. the NAR translator on the normalized units
    [(module, argv)] = script_commands("s2ut_train.sh", dict(data_dir=norm, out=ckpt / "nar"))
    run(module, argv + TRAIN + NAR_WIDTHS + ["--max-tokens", "200"])
    assert "saved checkpoint at step 2" in capsys.readouterr().err

    # 6. the vocoder fine-tune (full_recipe.sh stage 6)
    rng = np.random.default_rng(7)
    audio = tmp_path / "voc_audio"
    audio.mkdir()
    lines = []
    for i in range(4):
        lines.append(f"voc{i}|{' '.join(map(str, rng.integers(0, CODE_SIZE, size=8)))}")
        pcm = (rng.normal(size=8 * 320) * 3000).astype(np.int16)
        with wave.open(str(audio / f"voc{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
    (tmp_path / "train.units").write_text("\n".join(lines) + "\n")
    (tmp_path / "vocoder_cfg.json").write_text(json.dumps(VOCODER_CFG))
    recipe = script_commands("full_recipe.sh", dict(
        DATA_DIR=tmp_path, RAW_AUDIO_DIR=audio, VOCODER_CFG=tmp_path / "vocoder_cfg.json",
        CKPT_ROOT=ckpt))
    [(module, argv)] = [c for c in recipe if c[0].endswith("train_vocoder")]
    run(module, argv + ["--cpu", "--max-update", "2", "--batch-size", "2", "--crop-units", "8",
                        "--mpd-periods", "2,3", "--msd-scales", "2", "--disc-width", "0.0625",
                        "--n-fft", "64", "--hop-size", "32", "--win-size", "64",
                        "--num-mels", "20", "--log-interval", "1"])

    # 5., 7., 8. decode -> unit BLEU -> waveforms -> ASR-BLEU (s2ut_eval.sh)
    from tests.helpers import make_tiny_ctc_checkpoint

    results = tmp_path / "results"
    (tmp_path / "refs.txt").write_text("hello world\n" * 3)
    (generate, gen_argv), (bleu, bleu_argv), (wav, wav_argv), (asr, asr_argv) = \
        script_commands("s2ut_eval.sh", dict(
            data_dir=norm, ckpt=last_step(ckpt / "nar"), cond_scale=1.0, results=results,
            vocoder=last_step(ckpt / "vocoder"), vocoder_cfg=tmp_path / "vocoder_cfg.json",
            REF_TRANSCRIPTS=tmp_path / "refs.txt"))
    run(generate, gen_argv + ["--cpu", "--iter-decode-max-iter", "2", "--batch-size", "2",
                              "--max-target-positions", "64", "--target-code-size",
                              str(CODE_SIZE), *NAR_WIDTHS])
    text = (results / "generate-test.txt").read_text()
    assert text.count("H-") == 2 and text.count("T-") == 2
    run(bleu, bleu_argv)
    assert capsys.readouterr().out.startswith("unit BLEU: ")
    # one line of known units: an untrained decoder may emit only specials
    hyp = results / "hyp_plus.unit"
    hyp.write_text((results / "hyp.unit").read_text() + "0 1 2 3 4 5\n")
    run(wav, wav_argv + ["--cpu", "--reduce", "--in-code-file", str(hyp)])
    wavs = sorted((results / "wav").glob("*_pred.wav"))
    assert len(wavs) == 3
    with wave.open(str(results / "wav" / "2_pred.wav")) as w:
        assert w.getframerate() == 16000 and w.getnframes() >= 6 * 8
    ctc = make_tiny_ctc_checkpoint(tmp_path / "tiny_ctc")
    run(asr, asr_argv + ["--cpu", "--asr-model", ctc,
                         "--transcripts-path", str(tmp_path / "asr.txt")])
    score = capsys.readouterr().out
    assert score.startswith("ASR-BLEU: ")
    assert 0.0 <= float(score.split()[1]) <= 100.0
    assert len((tmp_path / "asr.txt").read_text().splitlines()) == 3
