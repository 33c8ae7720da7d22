"""DiffNorm normalization driver: rewrite unit manifests with
diffusion-normalized units (PyTorch port of diffnorm_tpu/cli/diff_norm_synthesis.py).

Joins the translation manifest with the per-utterance target feature dumps,
re-derives the reduced-frame indices, runs `ddim_sample` (partial noise at
--start-step of T=200), re-reduces the output units and writes `{split}.tsv`.
Runs on the GPU in bf16 (the kernels' configuration) unless --cpu is given,
which runs in float32. `--quant-int8` runs the denoiser's transformer in
int8 W8A8 on the route `--int8-route` names (default fused_layer; in float32
on the CPU every route is the int8 module path, as in JAX).
`--quant-int8 --quant-int8-static` is JAX's DDIM serving headline
(bench.py:38-49): the int8 module route with per-tensor weight and
activation scales, int8 WaveNet convs, and static activation scales
calibrated on the first batch (JAX cli/diff_norm_synthesis.py:203-222).
`--int8-convcat` and `--int8-quant-bf16` add JAX's DIFFNORM_INT8_CONVCAT
and DIFFNORM_INT8_QUANT_BF16 switches to the int8 module route. The next
batch's feature files load on a worker thread while the card samples the
current batch, whose units are read back after the next batch's sampling
is launched; the rows and their order do not change.

  python -m diffnorm_tpu_torch.cli.diff_norm_synthesis $DATA \\
      --params-npz diffusion.npz --tgt-feat-dir feat/ \\
      --output-dir diff_unit_vae_50 --start-step 50 --batch-size 100

`--data-parallel N` splits each batch's rows over N ranks (torchrun
--nproc-per-node N; NCCL on the card, gloo with --cpu), as JAX's
(cli/diff_norm_synthesis.py:99-114, :156-164): a batch's rows are padded to
a multiple of N (a pad row holds one valid frame), its VAE posterior eps and
start noise are drawn for its real rows as the one-process run draws them,
each rank loads the feature files of its rows alone and samples them, and
rank 0 gathers the units in order and writes: the output files are the
one-process run's. (`--quant-int8-static` calibrates on one process only.)

`--params-npz` (or `--ckpt`, the name scripts/unit_gen.sh passes) is a JAX
params tree, or a variables tree such as a `cli.train` checkpoint's
`params.npz`, in the flat format of `diffnorm_tpu_torch.weights.save_npz`,
or a step directory holding one (`cli.train`, `cli.convert_checkpoint`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffnorm_tpu_torch import registry
from diffnorm_tpu_torch.data.batching import bucket_length
from diffnorm_tpu_torch.data.manifest import (
    read_feature_manifest,
    read_translation_manifest,
    write_translation_manifest,
)
from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.models.diffusion import (
    LatentDiffusionModule,
    calibrate_act_scales,
    ddim_sample,
)
from diffnorm_tpu_torch.models.layers import INT8_ROUTES
from diffnorm_tpu_torch.ops.quant import (
    HEADLINE_KNOBS,
    Int8Knobs,
    quant_sites,
    set_static_scales,
)
from diffnorm_tpu_torch.ops.unit_reduce import reduce_units
from diffnorm_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache
from diffnorm_tpu_torch.weights import from_jax_variables

logger = logging.getLogger("diffnorm_tpu_torch.diff_norm")


def draw_noise(generator: torch.Generator, shape: Tuple[int, ...],
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The VAE posterior eps and the start noise of one batch."""
    enc = torch.randn(shape, generator=generator, device=device)
    init = torch.randn(shape, generator=generator, device=device)
    return enc, init


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data", help="directory of the {split}.tsv translation manifests")
    p.add_argument("--params-npz", "--ckpt", dest="params_npz", required=True,
                   help="diffusion weights: a weights.save_npz file (JAX params or variables "
                        "tree) or a step directory (cli.train, cli.convert_checkpoint); "
                        "--ckpt is scripts/unit_gen.sh's name for it")
    p.add_argument("--tgt-feat-dir", required=True,
                   help="directory of the {split}.manifest.tsv feature manifests")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--start-step", type=int, default=50)
    p.add_argument("--ddim-stride", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--splits", default="test,dev,train")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--cpu", action="store_true", help="run on the CPU in float32")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="split each batch's rows over this many ranks (torchrun; 0 or 1: "
                        "one process)")
    p.add_argument("--quant-int8", action="store_true",
                   help="int8 W8A8 transformer (JAX's quant_int8)")
    p.add_argument("--int8-route", choices=INT8_ROUTES, default="fused_layer",
                   help="with --quant-int8: fused_layer (DIFFNORM_FUSED_BLOCK=1), "
                        "ffpipe (DIFFNORM_FFPIPE=1), ffpipe2 (and DIFFNORM_FFPIPE_ROWS=2) "
                        "or module (the int8 module path)")
    p.add_argument("--quant-int8-static", action="store_true",
                   help="with --quant-int8: the int8 module route with per-tensor scales "
                        "and int8 WaveNet convs, activation scales calibrated on the "
                        "first batch and then static")
    p.add_argument("--int8-convcat", action="store_true",
                   help="int8 module route: a k-tap conv under a per-tensor activation "
                        "scale as one K = k * C product (DIFFNORM_INT8_CONVCAT=1)")
    p.add_argument("--int8-quant-bf16", action="store_true",
                   help="int8 module route on the card: the activation abs-max and divide "
                        "in bf16 (DIFFNORM_INT8_QUANT_BF16=1)")
    p.add_argument("--hidden-dim", type=int, default=512)
    p.add_argument("--latent-dim", type=int, default=128)
    p.add_argument("--feature-dim", type=int, default=768)
    p.add_argument("--vocab-size", type=int, default=1004)
    p.add_argument("--timesteps", type=int, default=200)
    p.add_argument("--denoiser-depth", type=int, default=12)
    p.add_argument("--wavenet-layers", type=int, default=8)
    p.add_argument("--wavenet-stacks", type=int, default=4)
    p.add_argument("--vae-decoder-depth", type=int, default=6)
    p.add_argument("--vae-decoder-dim-head", type=int, default=96)
    p.add_argument("--vae-decoder-heads", type=int, default=8)
    p.add_argument("--chan-mults", type=json.loads, default=None,
                   help='VAE channel multipliers as JSON, e.g. "[3]"')
    p.add_argument("--user-dir", help="a plugin imported first (registry.py)")
    return p.parse_args(argv)


def int8_config(args: argparse.Namespace) -> Tuple[str, Int8Knobs]:
    """The int8 route and knobs that the flags select."""
    if args.quant_int8_static and not args.quant_int8:
        raise ValueError("--quant-int8-static needs --quant-int8")
    route = "module" if args.quant_int8_static else args.int8_route
    knobs = HEADLINE_KNOBS if args.quant_int8_static else Int8Knobs()
    if (args.int8_convcat or args.int8_quant_bf16) and not (args.quant_int8 and route == "module"):
        raise ValueError("--int8-convcat and --int8-quant-bf16 apply to the int8 module "
                         "route: --quant-int8 with --quant-int8-static or --int8-route module")
    return route, dataclasses.replace(knobs, convcat=args.int8_convcat,
                                      quant_bf16=args.int8_quant_bf16)


def build_model(args: argparse.Namespace, device: torch.device) -> LatentDiffusionModule:
    route, knobs = int8_config(args)
    with torch.device(device):
        model = LatentDiffusionModule(
            dim=args.hidden_dim, latent_dim=args.latent_dim,
            feature_dim=args.feature_dim, vocab_size=args.vocab_size,
            timesteps=args.timesteps, denoiser_depth=args.denoiser_depth,
            wavenet_layers=args.wavenet_layers,
            wavenet_stacks=args.wavenet_stacks,
            vae_decoder_depth=args.vae_decoder_depth,
            vae_decoder_dim_head=args.vae_decoder_dim_head,
            vae_decoder_heads=args.vae_decoder_heads,
            chan_mults=args.chan_mults, quant_int8=args.quant_int8,
            int8_route=route, int8_knobs=knobs)
    # int8 packs from float32
    from_jax_variables(model, load_variables(args.params_npz))
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    return model.to(dtype).eval()


def normalize_split(model, args, device, generator, split: str,
                    mesh: Mesh = Mesh()) -> None:
    manifest_path = os.path.join(args.data, f"{split}.tsv")
    if not os.path.exists(manifest_path):
        logger.warning("skipping %s (no %s)", split, manifest_path)
        return
    rows = read_translation_manifest(manifest_path)
    feats = read_feature_manifest(
        os.path.join(args.tgt_feat_dir, f"{split}.manifest.tsv"))
    items = []
    for row in rows:
        if row["id"] not in feats:
            continue
        full_units = np.asarray([int(u) for u in row["tgt_audio"].split()], np.int64)
        dedup, _, keep = reduce_units(full_units)
        items.append((row, feats[row["id"]][0], dedup, keep))
    items.sort(key=lambda it: len(it[2]))  # by reduced length, then bucket

    out_rows: List[dict] = []
    n_match = n_total = 0
    t0 = time.time()

    def load(chunk) -> Tuple[np.ndarray, np.ndarray]:
        """A chunk's bucketed features and mask (host work: the .npy reads),
        its rows padded to a multiple of the data-parallel degree (a pad
        row holds one valid frame); a rank reads its own rows' files."""
        max_len = bucket_length(max(len(c[2]) for c in chunk))
        rows = len(chunk) + (-len(chunk)) % mesh.data
        feat = np.zeros((rows, max_len, args.feature_dim), np.float32)
        mask = np.zeros((rows, max_len), bool)
        mask[len(chunk):, 0] = True
        lo, hi = mesh.rows(rows)
        for j, (_, fpath, dedup, keep) in enumerate(chunk):
            if lo <= j < hi:
                feat[j, :len(dedup)] = np.load(fpath)[keep]
            mask[j, :len(dedup)] = True
        return feat, mask

    def emit(chunk, units: torch.Tensor) -> None:
        nonlocal n_match, n_total
        units = units.cpu().numpy()
        for j, (row, _, dedup, _) in enumerate(chunk):
            pred = units[j, :len(dedup)]
            n_match += int((pred == dedup).sum())
            n_total += len(dedup)
            norm_units, _, _ = reduce_units(pred)
            out_rows.append(dict(row, tgt_audio=" ".join(str(int(u)) for u in norm_units),
                                 tgt_n_frames=len(norm_units)))

    chunks = [items[s:s + args.batch_size] for s in range(0, len(items), args.batch_size)]
    # the next chunk's files load on one worker while the card samples this
    # one, and a chunk's units come back one chunk behind, after the next
    # chunk's sampling is launched (JAX cli/diff_norm_synthesis.py:185-235)
    behind = None
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(load, chunks[0]) if chunks else None
        for k, chunk in enumerate(chunks):
            feat, mask = pending.result()
            if k + 1 < len(chunks):
                pending = pool.submit(load, chunks[k + 1])
            feat_d, mask_d = torch.from_numpy(feat).to(device), torch.from_numpy(mask).to(device)
            if args.quant_int8_static and not any(
                    site.act_amax is not None for _, site in quant_sites(model)):
                n_sites = calibrate_act_scales(
                    model, feat_d, mask_d, start_step=args.start_step,
                    generator=torch.Generator(device=device).manual_seed(5))
                set_static_scales(model)
                logger.info("calibrated static int8 activation scales on the first batch "
                            "(%d sites)", n_sites)
            enc_noise, init_noise = draw_noise(
                generator, (len(chunk), feat.shape[1], args.latent_dim), device)
            pad = feat.shape[0] - len(chunk)
            if pad:  # the pad rows' noises are zeros
                enc_noise, init_noise = (torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                                         for x in (enc_noise, init_noise))
            units, _ = ddim_sample(
                model, feat_d, mask_d, start_step=args.start_step, stride=args.ddim_stride,
                enc_noise=enc_noise, init_noise=init_noise, device=device, mesh=mesh)
            if behind is not None:
                emit(*behind)
            behind = (chunk, units)
    if behind is not None:
        emit(*behind)
    logger.info("%s: normalized %d utts in %.1fs (unit acc vs orig %.3f)",
                split, len(out_rows), time.time() - t0, n_match / max(n_total, 1))
    if mesh.index == 0:  # rank 0 writes
        write_translation_manifest(os.path.join(args.output_dir, f"{split}.tsv"), out_rows)


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    registry.import_user_module(args.user_dir)
    if args.data_parallel > 1:
        if args.quant_int8_static:
            raise NotImplementedError("--quant-int8-static with --data-parallel: the static "
                                      "scales are calibrated by one process")
        device = init_distributed(cpu=args.cpu)
        mesh = make_mesh(args.data_parallel)
        if mesh.index:  # rank 0 alone logs
            logging.getLogger().setLevel(logging.WARNING)
        logger.info("data-parallel normalization over %d ranks (%s)", mesh.data, mesh.backend)
    else:
        device, mesh = resolve_device("cpu" if args.cpu else "cuda"), Mesh()
    os.makedirs(args.output_dir, exist_ok=True)
    model = build_model(args, device)
    logger.info("loaded diffusion weights from %s (%s)", args.params_npz, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for split in args.splits.split(","):
        normalize_split(model, args, device, generator, split, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
