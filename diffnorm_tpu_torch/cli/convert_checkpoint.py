"""Convert fairseq PyTorch checkpoints into the port's step directories
(port of diffnorm_tpu/cli/convert_checkpoint.py), one command per family:

  python -m diffnorm_tpu_torch.cli.convert_checkpoint --type vae \\
      --input speech_vae.pt --output ckpts/vae
  python -m diffnorm_tpu_torch.cli.convert_checkpoint --type diffusion \\
      --input diff_discrete.pt --output ckpts/diffusion
  python -m diffnorm_tpu_torch.cli.convert_checkpoint --type nar \\
      --input nar_s2ut.pt --output ckpts/nar
  python -m diffnorm_tpu_torch.cli.convert_checkpoint --type hifigan \\
      --input g_00500000 --vocoder-cfg config.json --output ckpts/vocoder
  python -m diffnorm_tpu_torch.cli.convert_checkpoint --type hubert \\
      --input mhubert_base.pt --hubert-layers 12 --output ckpts/hubert
  python -m diffnorm_tpu_torch.cli.convert_checkpoint --type hubert_ctc \\
      --input hubert_base_ls960_ctc.pt --output ckpts/hubert_ctc
  python -m diffnorm_tpu_torch.cli.convert_checkpoint --type gan_discriminators \\
      --input do_00500000 --output ckpts/discriminators

The state dict is the fairseq envelope's `model` entry (the file's dict
where it has none); `generator` for hifigan; `mpd` and `msd` for
gan_discriminators. The output directory holds `params.npz`, the variables
tree JAX's converter returns in weights.save_npz's format, which
`train.checkpoint.load_variables` reads: cli.generate --path,
cli.diff_norm_synthesis --ckpt, cli.generate_waveform --vocoder,
cli.prepare --hubert-ckpt, cli.validate --path and cli.train --restore-file
--reset-optimizer take it as it is (gan_discriminators holds {"mpd":
{"params"}, "msd": {"params"}}). An existing output is not overwritten.

The key-inventory audit is on unless --no-strict: every learned element of
the state dict must land in the tree (each discriminator against its own),
the family's pretraining-only heads excepted, else a ValueError names the
suspect keys. `--type hubert_ctc` converts a fairseq CTC fine-tune
(`w2v_encoder.*`) to `models/hubert.py:HubertCTCModule`'s tree, which
cli.generate --task audio_finetuning reads; the ASR of eval/asr_bleu.py
reads Hugging Face directories (models/wav2vec2_ctc.py). `--type
diffusion` takes the prompt-conditioned denoiser too (its resampler, null
embeddings and cross-attention layers).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Optional, Sequence

import torch

from diffnorm_tpu_torch.train.checkpoint import PARAMS
from diffnorm_tpu_torch.utils import convert_weights as cw
from diffnorm_tpu_torch.weights import flatten_tree, save_npz

logger = logging.getLogger("diffnorm_tpu_torch.convert_checkpoint")

TYPES = ("vae", "diffusion", "nar", "hifigan", "hubert", "hubert_ctc", "gan_discriminators")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--type", required=True, choices=TYPES)
    p.add_argument("--input", required=True, help="torch checkpoint path")
    p.add_argument("--output", required=True, help="step directory to create")
    p.add_argument("--vocoder-cfg", help="HiFi-GAN config.json (required for --type hifigan)")
    p.add_argument("--hubert-layers", type=int, default=None,
                   help="transformer layer count for hubert and hubert_ctc (default: counted "
                        "from the keys)")
    p.add_argument("--no-strict", dest="strict", action="store_false",
                   help="skip the key-inventory audit")
    return p.parse_args(argv)


def convert(args: argparse.Namespace):
    """(variables tree, [(state dict, the tree it must balance against)])."""
    ckpt = torch.load(args.input, map_location="cpu", weights_only=False)
    if args.type == "gan_discriminators":
        variables = cw.convert_gan_discriminators(ckpt["mpd"], ckpt["msd"])
        return variables, [(ckpt["mpd"], variables["mpd"]), (ckpt["msd"], variables["msd"])]
    if args.type == "hifigan":
        if not args.vocoder_cfg:
            raise SystemExit("--vocoder-cfg is required for --type hifigan")
        with open(args.vocoder_cfg) as f:
            cfg = json.load(f)
        sd = ckpt.get("generator", ckpt.get("model", ckpt))
        variables = cw.convert_hifigan_state(sd, cfg)
    else:
        sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
        if args.type == "vae":
            variables = {"params": cw.convert_vae_state(sd)}
        elif args.type == "diffusion":
            variables = {"params": cw.convert_diffusion_state(sd)}
        elif args.type == "nar":
            variables = cw.convert_nar_state(sd)
        elif args.type == "hubert_ctc":
            variables = cw.convert_hubert_ctc_state(
                sd, layers=args.hubert_layers or cw.torch_layer_count(sd))
        else:
            variables = cw.convert_hubert_state(
                sd, layers=args.hubert_layers or cw.torch_layer_count(sd))
    return variables, [(sd, variables)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    out = os.path.abspath(args.output)
    if os.path.exists(out):
        raise SystemExit(f"refusing to overwrite existing {out}")
    t0 = time.perf_counter()
    variables, audits = convert(args)
    if args.strict:
        # released checkpoints carry key quirks (optimizer and EMA envelopes,
        # extra heads): an unconsumed weight fails loud here
        expected = cw.EXPECTED_UNCONSUMED[args.type]
        consumed = sum(cw.conversion_inventory(sd, tree, expected_unconsumed=expected)[0]
                       for sd, tree in audits)
        logger.info("key inventory balanced (%s): %d learned elements", args.type, consumed)
    os.makedirs(out)
    save_npz(os.path.join(out, PARAMS), variables)
    n = len(flatten_tree(variables))
    logger.info("wrote %d arrays -> %s in %.2f s", n, out, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
