"""The code-HiFi-GAN fine-tune, recipe stage 6 (PyTorch port of
diffnorm_tpu/cli/train_vocoder.py; reference fairseq/tasks/code_hifigan.py
"unit_to_speech"): alternating MPD/MSD discriminator and generator updates
with the mel and feature-matching losses, and the duration predictor's MSE
on run-length labels where the config declares one.

  python -m diffnorm_tpu_torch.cli.train_vocoder \\
      --units-file train.units --audio-dir wavs/ --vocoder-cfg config.json \\
      --save-dir ckpt/vocoder --max-update 500000 --batch-size 32 --crop-units 28

The generator is the config's `CodeGenerator` in float32, trained from its
initialization; `name|u1 u2 ...` lines of --units-file pair with
`{name}.wav` (16 kHz) under --audio-dir. `--data-config Y` (YAML) gives the
dataset its `waveform_transforms` and `dataset_transforms` blocks
(data/augment.py: noise, music, babble and sporadic noise on each crop,
noisy overlap over each batch). `--input-type features --feat-manifest M`
trains repr_to_speech's `FeatureGenerator` (the config's `model_in_dim`,
768 by default, projected to `embedding_dim`) on the feature dumps that the
feature manifest M lists (`cli.prepare dump-features`' `{split}.manifest.tsv`),
paired with `{utt}.wav` under --audio-dir. Checkpoints are step directories
under --save-dir: `params.npz` holds {"g_params", "d_params": {"mpd",
"msd"}} in flax paths (what `cli.generate_waveform --vocoder STEP_DIR`
reads for a CodeGenerator), `trainer.pt` both optimizers' moments and
counts. A re-run with a higher --max-update continues from the last one
(`resumed from step N`). Runs on the GPU unless --cpu is given.

Batches load on a background thread, or with `--num-workers N` on N host
threads (the audio reads, crops and transforms), in order: the batch lists
do not depend on N, but crops and transforms drawn from the dataset's one
generator come in another order under N > 1, as in JAX.

Not ported, and raising NotImplementedError: the multi-speaker fine-tune
(a `multispkr` config with --input-type code: JAX's CLI builds a
single-speaker generator for it).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Optional, Sequence

import torch

from diffnorm_tpu_torch.data.code_dataset import CodeToSpeechDataset, FeatureToSpeechDataset
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.models.hifigan import CodeGenerator, FeatureGenerator
from diffnorm_tpu_torch.train.checkpoint import CheckpointManager
from diffnorm_tpu_torch.train.gan_trainer import DEFAULTS, GanTrainer
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache

logger = logging.getLogger("diffnorm_tpu_torch.train_vocoder")


def _ints(value: str):
    return tuple(int(k) for k in value.strip("()[] ").replace(",", " ").split())


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data", nargs="?",
                   help="accepted and unused, as by JAX's CLI: --units-file and --audio-dir "
                        "name the data")
    p.add_argument("--units-file", help="`name|u1 u2 ...` lines (--input-type code)")
    p.add_argument("--feat-manifest",
                   help="the feature manifest of the dumps (--input-type features)")
    p.add_argument("--audio-dir", required=True, help="{name}.wav, 16 kHz")
    p.add_argument("--vocoder-cfg", required=True, help="the code-HiFi-GAN config JSON")
    p.add_argument("--save-dir", default="ckpt/vocoder")
    p.add_argument("--crop-units", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max-update", type=int, default=10000)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--save-interval-updates", type=int, default=5000)
    p.add_argument("--keep-last-epochs", type=int, default=3)
    for name in ("lr", "adam_b1", "adam_b2", "lr_decay", "mel_weight", "fm_weight",
                 "dur_weight", "disc_width"):
        p.add_argument("--" + name.replace("_", "-"), type=float, default=DEFAULTS[name])
    for name in ("decay_steps", "n_fft", "hop_size", "win_size", "num_mels", "sampling_rate",
                 "msd_scales"):
        p.add_argument("--" + name.replace("_", "-"), type=int, default=DEFAULTS[name])
    p.add_argument("--mpd-periods", type=_ints, default=DEFAULTS["mpd_periods"])
    p.add_argument("--bf16-disc", action="store_true",
                   help="the discriminators compute in bf16 (float32 parameters)")
    p.add_argument("--dur-training", action="store_true",
                   help="run-length duration labels (on whenever the config has "
                        "dur_predictor_params)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--data-config", help="the dataset's transforms (YAML)")
    p.add_argument("--input-type", choices=("code", "features"), default="code")
    p.add_argument("--num-workers", type=int, default=0,
                   help="host threads that load the batches (0: one background thread)")
    args = p.parse_args(argv)
    needs = "feat_manifest" if args.input_type == "features" else "units_file"
    if getattr(args, needs) is None:
        p.error(f"--input-type {args.input_type} needs --{needs.replace('_', '-')}")
    return args


def build_generator(vcfg: dict, input_type: str = "code"):
    """The config's CodeGenerator, as CodeHiFiGANVocoder.from_config builds
    it, so a fine-tuned step directory loads back at synthesis; with
    `input_type` "features" repr_to_speech's FeatureGenerator."""
    common = dict(
        embedding_dim=vcfg["embedding_dim"], upsample_rates=tuple(vcfg["upsample_rates"]),
        upsample_kernel_sizes=tuple(vcfg["upsample_kernel_sizes"]),
        upsample_initial_channel=vcfg["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(vcfg["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in vcfg["resblock_dilation_sizes"]))
    if input_type == "features":
        return FeatureGenerator(feature_dim=vcfg.get("model_in_dim", 768), **common)
    if vcfg.get("multispkr"):
        # JAX's cli/train_vocoder.py:74-83 builds a single-speaker generator
        # whatever the config says: there is no multi-speaker fine-tune to port
        raise NotImplementedError("the multi-speaker vocoder's fine-tune is not ported")
    dur = vcfg.get("dur_predictor_params") or {}
    return CodeGenerator(num_embeddings=vcfg["num_embeddings"], dur_predictor=bool(dur),
                         var_pred_hidden_dim=dur.get("var_pred_hidden_dim", 256), **common)


def build_dataset(args: argparse.Namespace, vcfg: dict):
    """--input-type code: the units file's CodeToSpeechDataset with the
    --data-config transforms; features: the feature manifest's
    FeatureToSpeechDataset (no transforms, as JAX's)."""
    if args.input_type == "features":
        return FeatureToSpeechDataset.from_manifest(
            args.feat_manifest, args.audio_dir, crop_units=args.crop_units, seed=args.seed)
    data_cfg = None
    if args.data_config:
        import yaml

        with open(args.data_config) as f:
            data_cfg = yaml.safe_load(f)
    return CodeToSpeechDataset.from_files(
        args.units_file, args.audio_dir, crop_units=args.crop_units, seed=args.seed,
        dedup_dur=bool(args.dur_training or vcfg.get("dur_predictor_params")),
        data_cfg=data_cfg)


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    with open(args.vocoder_cfg) as f:
        vcfg = json.load(f)
    torch.manual_seed(args.seed)  # the models' initialization
    with torch.device(device):
        gen = build_generator(vcfg, args.input_type)
    dataset = build_dataset(args, vcfg)
    trainer = GanTrainer(gen, vars(args), device)
    logger.info("dataset: %d utterances", len(dataset))
    itr = EpochBatchIterator(dataset, max_sentences=args.batch_size, seed=args.seed,
                             num_workers=args.num_workers)
    # JAX builds its example batch from dataset[0] here, on every start
    # (train_vocoder.py:111): the batch is thrown away, but its draws
    # (the crop, the transforms, the collater's noisy overlap) advance the
    # dataset's generator as JAX's do
    dataset.collater([dataset[0]])
    ckpt = CheckpointManager(args.save_dir, keep_last=args.keep_last_epochs, keep_best=0)
    last = ckpt.latest_step()
    if last is not None:
        tree, state, _ = ckpt.load(last, device)
        trainer.load_variables(tree["params"])  # a tree without collections reads as params
        trainer.load_state_dict(state)
        logger.info("resumed from step %d", last)

    step, t0 = trainer.num_updates, time.time()
    while step < args.max_update:
        for batch in itr.next_epoch_itr():
            mets = trainer.train_step(batch)
            step = trainer.num_updates
            if step % args.log_interval == 0:
                ups = args.log_interval / max(time.time() - t0, 1e-9)
                logger.info("step %d | %s | ups %.2f", step,
                            " ".join(f"{k} {v:.4f}" for k, v in mets.items()), ups)
                t0 = time.time()
            if step % args.save_interval_updates == 0 or step >= args.max_update:
                ckpt.save(step, trainer.variables(), trainer.state_dict())
                logger.info("saved checkpoint at step %d", step)
            if step >= args.max_update:
                break
        itr.finish_epoch()
    logger.info("vocoder training done at step %d", step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
