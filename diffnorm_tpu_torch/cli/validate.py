"""Validation CLI (port of diffnorm_tpu/cli/validate.py; reference
fairseq_cli/validate.py): load a checkpoint, run the task's criterion over a
split in eval mode through the trainer's valid step, and log the aggregated
metrics under JAX's names.

  python -m diffnorm_tpu_torch.cli.validate $S2UT_DATA --config-yaml config.yaml \\
      --task speech_to_speech_fasttranslate --target-code-size 1000 \\
      --arch nar_s2ut_conformer --path ckpt/nar/step_000400000 \\
      --valid-subset dev --max-tokens 40000

It takes the tasks cli.train trains (the VAE and normalizer stages, NAR
and AR S2UT, UnitY, the spectrogram translators, text-to-speech,
speech-to-text and text translation: translation, cmlm_cg and
translation_lev on a bitext or cli.preprocess's binarized pairs, SEDD's
sedd / sedd_lm and the unit LM's unit_lm / language_modeling on the unit
manifests, wav2vec2's audio_pretraining, HuBERT's hubert_pretraining and
the CTC fine-tune's audio_finetuning, and each family's dummy task on its
synthetic batches) with cli.train's model, data and task flags, its
criterion names, --user-dir and --config; `--path` is a step directory or a .npz
(weights.save_npz), a `cli.convert_checkpoint` output included. The
batches' draws come from `np.random.default_rng(--seed)`, the criterion's
(the VAE's posterior sample, the normalizer's times and noises, SEDD's
times and masks) from a
generator seeded 0 (wav2vec2's and HuBERT's span masks and negatives from
the former, at the Gumbel temperature of update 0). Runs on the GPU (in
--dtype) unless --cpu is given.
Logs `{split} | loss ... nll_loss ...`. Under torchrun (`--data-parallel`,
default every rank) each batch's rows split over the ranks, and the
metrics are the global batch's.
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.parallel.mesh import init_distributed, make_mesh
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache
from diffnorm_tpu_torch.weights import from_jax_variables

logger = logging.getLogger("diffnorm_tpu_torch.validate")


def parse_args(argv: Optional[Sequence[str]] = None):
    pre = train_cli.preparse(argv)
    p = train_cli.build_parser(__doc__.split("\n")[0], train=False)
    p.add_argument("--path", required=True,
                   help="the checkpoint: a step directory or a weights.save_npz file")
    train_cli.apply_config(p, pre.config)
    return train_cli.check_args(p, p.parse_args(argv))


def validate(args) -> Dict[str, float]:
    """The aggregated metrics of --path's weights over --valid-subset (each
    batch's rows split over the data-parallel ranks and the model over the
    model-parallel ranks, as cli.train's)."""
    device = init_distributed(cpu=args.cpu)
    mesh = make_mesh(args.data_parallel, args.model_parallel)
    if mesh.rank:  # rank 0 alone logs
        logging.getLogger().setLevel(logging.WARNING)
    torch.manual_seed(args.seed)
    task = TASKS[args.task](args)
    with torch.device(device):
        model = task.build_model()
    from_jax_variables(model, load_variables(args.path))
    logger.info("restored %s", args.path)
    trainer = Trainer(TrainerConfig(dtype=args.dtype, seed=args.seed), model,
                      train_cli.build_criterion(task, args), frozen_keys=task.frozen_param_keys,
                      mesh=mesh)
    dataset = task.dataset(args.valid_subset)
    if hasattr(dataset, "collater"):  # not a dummy task's synthetic batches
        # JAX draws its example item before the state's init (validate.py:49-53)
        dataset[0]
    vals = train_cli.validate_split(task, trainer, args, np.random.default_rng(args.seed),
                                    device, args.valid_subset)
    return vals or {}


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    vals = validate(args)
    logger.info("%s | %s", args.valid_subset,
                " ".join(f"{k} {v:.4g}" for k, v in sorted(vals.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
