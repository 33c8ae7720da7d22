"""The port stands alone: no module of diffnorm_tpu_torch/, not chip_smoke.py
and not time_main_path.py imports JAX, flax or the JAX package, none imports
transformers, sacrebleu or safetensors (absent on the GPU machine) at module
level, and the entry points run on the CPU only when asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diffnorm_tpu")
# not installed on the GPU machine: imported, where at all, inside a function
NOT_ON_THE_CARD = ("transformers", "sacrebleu", "safetensors")


def _port_sources():
    return sorted((REPO / "diffnorm_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "time_main_path.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


NEW_MODULES = ("models/stacked.py", "models/ar_transformer.py", "data/encoders.py",
               "data/multitask.py", "tasks/multitask_mixin.py", "data/augment.py",
               "train/metrics.py", "train/progress.py", "train/lr_schedules.py",
               "train/optimizers.py", "criterions/ddpm_loss.py", "criterions/vae_loss.py",
               "tasks/diffusion_task.py", "tasks/vae_task.py", "tasks/__init__.py",
               "models/s2t_transformer.py", "tasks/ar_s2ut_task.py", "criterions/ce_loss.py",
               "generate/beam_search.py", "models/unity.py", "generate/unity.py",
               "models/tts_transformer.py", "models/s2spect.py", "models/s2spect2.py",
               "generate/speech_ar.py", "generate/translatotron2.py",
               "criterions/tts_loss.py", "tasks/s2spect_task.py", "models/cmlm_text.py",
               "models/fastspeech2.py", "tasks/tts_task.py", "data/s2t_dataset.py",
               "tasks/s2t_task.py", "data/dictionary.py", "data/indexed_dataset.py",
               "tasks/cmlm_cg_task.py", "tasks/translation_task.py", "models/transformer_text.py",
               "models/levenshtein.py", "tasks/levenshtein_task.py",
               "criterions/levenshtein_loss.py", "cli/preprocess.py", "cli/interactive.py",
               "cli/score.py", "models/sedd.py", "criterions/sedd_loss.py",
               "data/unit_lm_dataset.py", "tasks/sedd_task.py", "models/unit_lm.py",
               "cli/eval_lm.py", "models/gaussian_diffusion.py", "models/moe.py",
               "utils/masking.py", "models/hubert.py", "models/wav2vec2.py",
               "data/hubert_dataset.py", "tasks/hubert_pretrain_task.py",
               "tasks/audio_pretrain_task.py", "criterions/hubert_loss.py",
               "criterions/wav2vec_loss.py", "criterions/ctc_loss.py", "generate/ctc.py",
               "ops/speech_norm.py", "ops/lightconv.py", "ops/alignment.py", "tasks/dummy.py",
               "criterions/aliases.py", "registry.py", "cli/speech_norm.py",
               "cli/hydra_train.py", "parallel/__init__.py", "parallel/mesh.py",
               "parallel/sharding_rules.py", "parallel/sequence.py", "parallel/pipeline.py",
               "utils/watchdog.py", "cli/dryrun_multichip.py")


def test_no_jax_imports_in_the_port():
    sources = _port_sources()
    assert len(sources) > 10
    assert all(REPO / "diffnorm_tpu_torch" / m in sources for m in NEW_MODULES)
    bad = [(p.relative_to(REPO), name) for p in sources
           for name in _imported_roots(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_no_module_level_imports_the_card_lacks():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            bad += [(path.relative_to(REPO), n) for n in names
                    if n.split(".")[0] in NOT_ON_THE_CARD]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'diffnorm_tpu', 'transformers', 'sacrebleu',\n"
            "             'safetensors'):\n"
            "    sys.modules[name] = None\n"
            "import diffnorm_tpu_torch.models.diffusion\n"
            "import diffnorm_tpu_torch.cli.diff_norm_synthesis\n"
            "import diffnorm_tpu_torch.cli.s2st\n"
            "import diffnorm_tpu_torch.cli.prepare\n"
            "import diffnorm_tpu_torch.cli.get_manifest\n"
            "import diffnorm_tpu_torch.cli.generate\n"
            "import diffnorm_tpu_torch.cli.generate_waveform\n"
            "import diffnorm_tpu_torch.cli.train_vocoder\n"
            "import diffnorm_tpu_torch.cli.convert_checkpoint\n"
            "import diffnorm_tpu_torch.cli.average_checkpoints\n"
            "import diffnorm_tpu_torch.cli.validate\n"
            "import diffnorm_tpu_torch.eval.unit_bleu\n"
            "import diffnorm_tpu_torch.eval.asr_bleu\n"
            "import diffnorm_tpu_torch.eval.mcd\n"
            "import diffnorm_tpu_torch.models.stacked\n"
            "import diffnorm_tpu_torch.models.ar_transformer\n"
            "import diffnorm_tpu_torch.data.encoders\n"
            "import diffnorm_tpu_torch.data.multitask\n"
            "import diffnorm_tpu_torch.tasks.multitask_mixin\n"
            "import diffnorm_tpu_torch.data.augment\n"
            "import diffnorm_tpu_torch.train.metrics\n"
            "import diffnorm_tpu_torch.train.progress\n"
            "import diffnorm_tpu_torch.train.lr_schedules\n"
            "import diffnorm_tpu_torch.train.optimizers\n"
            "import diffnorm_tpu_torch.criterions.ddpm_loss\n"
            "import diffnorm_tpu_torch.criterions.vae_loss\n"
            "import diffnorm_tpu_torch.tasks\n"
            "import diffnorm_tpu_torch.cli.train\n"
            "import diffnorm_tpu_torch.models.s2t_transformer\n"
            "import diffnorm_tpu_torch.tasks.ar_s2ut_task\n"
            "import diffnorm_tpu_torch.criterions.ce_loss\n"
            "import diffnorm_tpu_torch.generate.beam_search\n"
            "import diffnorm_tpu_torch.models.unity\n"
            "import diffnorm_tpu_torch.generate.unity\n"
            "import diffnorm_tpu_torch.models.tts_transformer\n"
            "import diffnorm_tpu_torch.models.s2spect\n"
            "import diffnorm_tpu_torch.models.s2spect2\n"
            "import diffnorm_tpu_torch.generate.speech_ar\n"
            "import diffnorm_tpu_torch.generate.translatotron2\n"
            "import diffnorm_tpu_torch.criterions.tts_loss\n"
            "import diffnorm_tpu_torch.tasks.s2spect_task\n"
            "import diffnorm_tpu_torch.models.cmlm_text\n"
            "import diffnorm_tpu_torch.models.fastspeech2\n"
            "import diffnorm_tpu_torch.tasks.tts_task\n"
            "import diffnorm_tpu_torch.data.s2t_dataset\n"
            "import diffnorm_tpu_torch.tasks.s2t_task\n"
            "import diffnorm_tpu_torch.data.indexed_dataset\n"
            "import diffnorm_tpu_torch.tasks.cmlm_cg_task\n"
            "import diffnorm_tpu_torch.tasks.translation_task\n"
            "import diffnorm_tpu_torch.models.transformer_text\n"
            "import diffnorm_tpu_torch.models.levenshtein\n"
            "import diffnorm_tpu_torch.tasks.levenshtein_task\n"
            "import diffnorm_tpu_torch.criterions.levenshtein_loss\n"
            "import diffnorm_tpu_torch.cli.preprocess\n"
            "import diffnorm_tpu_torch.cli.interactive\n"
            "import diffnorm_tpu_torch.cli.score\n"
            "import diffnorm_tpu_torch.models.sedd\n"
            "import diffnorm_tpu_torch.criterions.sedd_loss\n"
            "import diffnorm_tpu_torch.utils.masking\n"
            "import diffnorm_tpu_torch.models.wav2vec2\n"
            "import diffnorm_tpu_torch.data.hubert_dataset\n"
            "import diffnorm_tpu_torch.tasks.hubert_pretrain_task\n"
            "import diffnorm_tpu_torch.tasks.audio_pretrain_task\n"
            "import diffnorm_tpu_torch.criterions.hubert_loss\n"
            "import diffnorm_tpu_torch.criterions.wav2vec_loss\n"
            "import diffnorm_tpu_torch.criterions.ctc_loss\n"
            "import diffnorm_tpu_torch.generate.ctc\n"
            "import diffnorm_tpu_torch.data.unit_lm_dataset\n"
            "import diffnorm_tpu_torch.tasks.sedd_task\n"
            "import diffnorm_tpu_torch.models.unit_lm\n"
            "import diffnorm_tpu_torch.cli.eval_lm\n"
            "import diffnorm_tpu_torch.models.gaussian_diffusion\n"
            "import diffnorm_tpu_torch.models.moe\n"
            "import diffnorm_tpu_torch.ops.speech_norm\n"
            "import diffnorm_tpu_torch.ops.lightconv\n"
            "import diffnorm_tpu_torch.ops.alignment\n"
            "import diffnorm_tpu_torch.tasks.dummy\n"
            "import diffnorm_tpu_torch.criterions.aliases\n"
            "import diffnorm_tpu_torch.registry\n"
            "import diffnorm_tpu_torch.cli.speech_norm\n"
            "import diffnorm_tpu_torch.cli.hydra_train\n"
            "import diffnorm_tpu_torch.parallel.sequence\n"
            "import diffnorm_tpu_torch.parallel.pipeline\n"
            "import diffnorm_tpu_torch.utils.watchdog\n"
            "import diffnorm_tpu_torch.cli.dryrun_multichip\n"
            "from diffnorm_tpu_torch.eval.bleu import corpus_bleu, scorer_name\n"
            "assert scorer_name() == 'counters', scorer_name()\n"
            "assert corpus_bleu(['1 2 3 4 5'], ['1 2 3 4 5']) == 100.0\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    from diffnorm_tpu_torch.cli import diff_norm_synthesis
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample

    model = LatentDiffusionModule(
        dim=16, latent_dim=3, feature_dim=24, vocab_size=20, timesteps=20,
        denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1,
        vae_decoder_depth=1, vae_decoder_dim_head=8, vae_decoder_heads=2,
        chan_mults=[4])
    feature = torch.zeros(1, 8, 24)
    mask = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        ddim_sample(model, feature, mask, start_step=3)
    units, _ = ddim_sample(model, feature, mask, start_step=3, device="cpu")
    assert units.shape == (1, 8)

    with pytest.raises(RuntimeError, match="CUDA"):
        diff_norm_synthesis.main([str(tmp_path), "--params-npz", "absent.npz",
                                  "--tgt-feat-dir", str(tmp_path),
                                  "--output-dir", str(tmp_path / "out")])

    from diffnorm_tpu_torch.cli import s2st

    with pytest.raises(RuntimeError, match="CUDA"):
        s2st.main([str(tmp_path), "--params-npz", "absent.npz", "--vocoder-npz", "absent.npz",
                   "--vocoder-cfg", "absent.json", "--results-path", str(tmp_path / "wav")])

    from diffnorm_tpu_torch.cli import generate, generate_waveform
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.eval import asr_bleu

    # data and model parallelism without --cpu join NCCL on the card: no quiet
    # gloo on the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--task", "dummy_vae", "--max-update", "1", "--data-parallel", "2",
                        "--save-dir", str(tmp_path / "dp")])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--task", "dummy_vae", "--max-update", "1", "--model-parallel", "2",
                        "--save-dir", str(tmp_path / "tp")])
    from diffnorm_tpu_torch.cli import dryrun_multichip

    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip.main(["--ranks", "2"])

    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main([str(tmp_path), "--path", "absent.npz", "--results-path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):  # the AR S2UT branch
        generate.main([str(tmp_path), "--task", "speech_to_speech_ar", "--path", "absent.npz",
                       "--results-path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_waveform.main(["--in-code-file", "absent.unit", "--vocoder", "absent.npz",
                                "--vocoder-cfg", "absent.json", "--results-path",
                                str(tmp_path / "wav")])
    (tmp_path / "0_pred.wav").write_bytes(b"")
    (tmp_path / "refs.txt").write_text("hello\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        asr_bleu.main(["--audio-dir", str(tmp_path), "--reference-path",
                       str(tmp_path / "refs.txt"), "--asr-model", str(tmp_path)])

    from diffnorm_tpu_torch.cli import train, train_vocoder

    vocoder = ["--units-file", "absent.units", "--audio-dir", str(tmp_path), "--vocoder-cfg",
               "absent.json"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vocoder.main(vocoder)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--task", "unit_to_speech", *vocoder])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main([str(tmp_path), "--task", "speech_to_speech_ar", "--max-update", "1"])
    for task in ("sedd", "sedd_lm", "unit_lm", "language_modeling"):
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main([str(tmp_path), "--task", task, "--max-update", "1"])
    from diffnorm_tpu_torch.cli import eval_lm

    with pytest.raises(RuntimeError, match="CUDA"):
        eval_lm.main([str(tmp_path), "--path", "absent.npz"])
    for task in ("translation", "cmlm_cg", "translation_lev"):  # the text MT tasks
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main([str(tmp_path), "--task", task, "--max-update", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            generate.main([str(tmp_path), "--task", task, "--path", "absent.npz"])

    from diffnorm_tpu_torch.cli import interactive

    with pytest.raises(RuntimeError, match="CUDA"):
        interactive.main([str(tmp_path), "--task", "translation", "--path", "absent.npz"])

    from diffnorm_tpu_torch.cli import validate

    with pytest.raises(RuntimeError, match="CUDA"):
        validate.main([str(tmp_path), "--task", "speech_decoder", "--tgt-feat-dir",
                       str(tmp_path), "--path", "absent.npz"])

    from diffnorm_tpu_torch.cli import prepare

    for cmd in (["dump-features", "--manifest", "absent.tsv", "--out-dir", str(tmp_path)],
                ["learn-kmeans", "--feat-dir", str(tmp_path), "--out", "km.npy"],
                ["quantize", "--feat-dir", str(tmp_path), "--kmeans", "km.npy", "--out", "u"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            prepare.main(cmd)


def test_kernel_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version."""
    from diffnorm_tpu_torch.ops.norm import rms_norm_film
    from diffnorm_tpu_torch.ops.wavenet_chain import wavenet_chain

    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rms_norm_film(x, torch.zeros(1, 16, device="meta"))
    w = torch.zeros(1, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wavenet_chain(x, w, w[:, 0], w[0, 0], w[:, 0, 0], w[0, 0, 0],
                      x[:, :1], x[:, :1], dilation=1)


def test_weights_round_trip_through_npz(tmp_path):
    from diffnorm_tpu_torch.models.wavenet import Wavenet
    from diffnorm_tpu_torch.weights import (
        from_jax_params, load_npz, save_npz, to_jax_params)

    torch.manual_seed(0)
    src = Wavenet(6, 8, stacks=2, layers=2, cond_dim=4)
    params = to_jax_params(src)
    assert params["stack_1"]["block_0"]["conv"]["kernel"].shape == (3, 8, 8)
    save_npz(str(tmp_path / "w.npz"), params)
    dst = from_jax_params(Wavenet(6, 8, stacks=2, layers=2, cond_dim=4),
                          load_npz(str(tmp_path / "w.npz")))
    for (name, a), (_, b) in zip(src.named_parameters(), dst.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), name)
    x, t = torch.randn(2, 5, 6), torch.randn(2, 4)
    with torch.no_grad():
        np.testing.assert_allclose(dst(x, t).numpy(), src(x, t).numpy(), rtol=1e-6)

    del params["stack_0"]["block_1"]["res_conv"]
    with pytest.raises(KeyError, match="res_conv"):
        from_jax_params(dst, params)
