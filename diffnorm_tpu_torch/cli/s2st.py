"""The S2ST chain as a CLI: a source manifest in, waveforms out, one process
(PyTorch port of diffnorm_tpu/cli/s2st.py).

  python -m diffnorm_tpu_torch.cli.s2st $DATA --params-npz nar.npz \\
      --vocoder-npz hifigan.npz --vocoder-cfg config.json \\
      --results-path wavs/ --gen-subset test --dur-prediction

Reads `{gen_subset}.tsv` (and `config.yaml`) under DATA, runs
`generate.s2st.s2st_generate` (NAR mask-predict -> unit reduction ->
duration expansion -> code-HiFi-GAN) over batches of descending source
length, each padded to a multiple of 64 frames as the JAX CLI pads them,
and writes `{utt_id}_pred.wav` at --sample-rate plus `s2st-{split}.unit`
(`id|u1 u2 ...` reduced unit lines keyed by the manifest ids). Runs on the
GPU (bf16 unless --dtype says otherwise) unless --cpu is given, which runs
in float32. `--params-npz` / `--vocoder-npz` are JAX variables trees
({"params", "batch_stats"}) in the format of `weights.save_npz`;
`--params-npz` may also name a `cli.train` checkpoint step directory.
`--n-frames-per-step`, `--target-speaker-embed` and `--speaker-embed-dim`
give the model's options (a data config with `target_speaker_embed`
conditions each utterance on its speaker embedding). As in JAX, the CLI
passes no vocoder speaker, so a multi-speaker vocoder (`multispkr`) raises.
`--int8-vocoder dynamic|static` runs the vocoder's narrow-stage ResBlock
convs W8A8, as JAX's DIFFNORM_INT8_VOCODER (`models/hifigan.py`).
`--data-parallel N` (under torchrun --nproc-per-node N; gloo with --cpu)
splits each batch's rows over N ranks; rank 0 gathers them in order and
writes the files the one-process run writes.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from diffnorm_tpu_torch import registry
from diffnorm_tpu_torch.cli.generate_waveform import load_vocoder, write_wav
from diffnorm_tpu_torch.models.hifigan import INT8_MODES
from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.generate.s2st import s2st_generate
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache
from diffnorm_tpu_torch.weights import from_jax_variables

logger = logging.getLogger("diffnorm_tpu_torch.s2st")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data", help="directory of the {split}.tsv manifests (and config.yaml)")
    p.add_argument("--params-npz", required=True,
                   help="NAR S2UT weights (weights.save_npz), or a cli.train step directory")
    p.add_argument("--vocoder-npz", required=True, help="code-HiFi-GAN weights")
    p.add_argument("--vocoder-cfg", required=True, help="code-HiFi-GAN config JSON")
    p.add_argument("--results-path", required=True)
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--batch-size", type=int, default=8)
    add_data_parallel_arg(p)
    p.add_argument("--iter-decode-max-iter", type=int, default=15)
    p.add_argument("--max-target-positions", type=int, default=256)
    p.add_argument("--iter-decode-with-beam", type=int, default=1)
    p.add_argument("--cond-scale", type=float, default=1.0)
    p.add_argument("--dur-prediction", action="store_true")
    p.add_argument("--max-duration", type=int, default=8)
    p.add_argument("--vocoder-chunk", type=int, default=4)
    p.add_argument("--int8-vocoder", choices=INT8_MODES, default="off",
                   help="W8A8 ResBlock convs on the vocoder's narrow stages")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--user-dir", help="a plugin imported first (registry.py)")
    add_model_args(p)
    return p.parse_args(argv)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """--dtype, --cpu, the nar_s2ut_conformer shape flags
    (nar_transformer.py's arch defaults) and its inference options, which
    `build_model` reads."""
    p.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                   help="model dtype (default bfloat16 on the GPU, float32 with --cpu)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--target-code-size", type=int, default=1000)
    p.add_argument("--input-feat-per-channel", type=int, default=80)
    p.add_argument("--encoder-embed-dim", type=int, default=512)
    p.add_argument("--encoder-ffn-embed-dim", type=int, default=2048)
    p.add_argument("--encoder-layers", type=int, default=12)
    p.add_argument("--encoder-attention-heads", type=int, default=8)
    p.add_argument("--decoder-embed-dim", type=int, default=None)
    p.add_argument("--decoder-ffn-embed-dim", type=int, default=None)
    p.add_argument("--decoder-layers", type=int, default=6)
    p.add_argument("--decoder-attention-heads", type=int, default=8)
    p.add_argument("--depthwise-conv-kernel-size", type=int, default=31)
    p.add_argument("--conv-channels", type=int, default=1024)
    p.add_argument("--conv-kernel-sizes", default="5,5")
    p.add_argument("--n-frames-per-step", type=int, default=1)
    p.add_argument("--target-speaker-embed", action="store_true",
                   help="the model conditions its encoder on a speaker embedding")
    p.add_argument("--speaker-embed-dim", type=int, default=256)


def add_data_parallel_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-parallel", type=int, default=0,
                   help="split each batch's rows over this many ranks (torchrun; 0 or 1: one "
                        "process)")


def data_parallel_mesh(args: argparse.Namespace) -> Mesh:
    """The mesh of --data-parallel (one process without it); rank 0 alone
    logs."""
    if getattr(args, "data_parallel", 0) <= 1:
        return Mesh()
    mesh = make_mesh(args.data_parallel)
    if mesh.index:
        logging.getLogger().setLevel(logging.WARNING)
    logger.info("data-parallel decode over %d ranks (%s)", mesh.data, mesh.backend)
    return mesh


def resolve_device_dtype(args: argparse.Namespace):
    """(device, dtype) of the flags: the card in bf16 unless --cpu (float32)
    or --dtype says otherwise; raises without CUDA unless --cpu. Under
    --data-parallel the rank's device of the process group it joins."""
    if getattr(args, "data_parallel", 0) > 1:
        device = init_distributed(cpu=args.cpu)
    else:
        device = resolve_device("cpu" if args.cpu else "cuda")
    dtype = DTYPES[args.dtype] if args.dtype else (
        torch.float32 if device.type == "cpu" else torch.bfloat16)
    return device, dtype


def build_model(args: argparse.Namespace, path: str, device: torch.device,
                dtype: torch.dtype, quant_int8: bool = False) -> NARS2UTModule:
    """The model of the shape flags with the weights of `path` (a
    `weights.save_npz` file or a cli.train step directory), int8 with
    `quant_int8`: the weights load in float32, which packs the int8 weights
    from the float32 masters, and the model is cast to `dtype` after. The
    training-only heads of a checkpoint (the aux heads `mt_*` and the CTC
    head `ctc_proj`, which no decode runs) are left out."""
    with torch.device(device):
        model = NARS2UTModule(
            vocab_size=args.target_code_size + 4, in_channels=args.input_feat_per_channel,
            encoder_dim=args.encoder_embed_dim, encoder_ffn_dim=args.encoder_ffn_embed_dim,
            encoder_layers=args.encoder_layers, encoder_heads=args.encoder_attention_heads,
            decoder_dim=args.decoder_embed_dim or args.encoder_embed_dim,
            decoder_ffn_dim=args.decoder_ffn_embed_dim or args.encoder_ffn_embed_dim,
            decoder_layers=args.decoder_layers, decoder_heads=args.decoder_attention_heads,
            depthwise_kernel_size=args.depthwise_conv_kernel_size,
            conv_channels=args.conv_channels,
            conv_kernel_sizes=tuple(int(k) for k in args.conv_kernel_sizes.split(",")),
            quant_int8=quant_int8, n_frames_per_step=args.n_frames_per_step,
            target_speaker_embed=args.target_speaker_embed,
            speaker_embed_dim=args.speaker_embed_dim)
    variables = load_variables(path)
    variables["params"] = {k: v for k, v in variables["params"].items()
                           if not (k.startswith("mt_") or k == "ctc_proj")}
    from_jax_variables(model, variables)
    return model.to(dtype).eval()


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    registry.import_user_module(args.user_dir)
    device, dtype = resolve_device_dtype(args)
    mesh = data_parallel_mesh(args)
    model = build_model(args, args.params_npz, device, dtype)
    vocoder = load_vocoder(args.vocoder_npz, args.vocoder_cfg, device=device, dtype=dtype,
                           int8_vocoder=args.int8_vocoder).module
    dataset = SpeechToUnitDataset.from_tsv(args.data, args.gen_subset)
    os.makedirs(args.results_path, exist_ok=True)

    order = dataset.ordered_indices()
    n_wav, audio_s, unit_lines = 0, 0.0, []
    t0 = time.time()
    for start in range(0, len(order), args.batch_size):
        batch = dataset.collater([dataset[int(i)] for i in order[start:start + args.batch_size]])
        src = batch["src_tokens"]
        pad = bucket(src.shape[1]) - src.shape[1]
        if pad:
            src = np.pad(src, ((0, 0), (0, pad), (0, 0)))
        tgt_speaker = batch.get("tgt_speaker")
        wav, wav_lengths, units, counts = s2st_generate(
            model, vocoder, torch.from_numpy(src).to(device),
            torch.from_numpy(batch["src_lengths"]).to(device),
            max_iter=args.iter_decode_max_iter, max_len=args.max_target_positions,
            cond_scale=args.cond_scale, length_beam=args.iter_decode_with_beam,
            dur_prediction=args.dur_prediction, max_duration=args.max_duration,
            vocoder_chunk=args.vocoder_chunk,
            tgt_speaker=None if tgt_speaker is None else torch.from_numpy(tgt_speaker).to(device),
            mesh=mesh)
        if mesh.index:  # rank 0 writes
            continue
        wav = wav.float().cpu().numpy()
        wav_lengths, units, counts = (t.cpu().numpy() for t in (wav_lengths, units, counts))
        for row, index in enumerate(batch["id"]):
            uid = dataset.ids[int(index)]
            n = int(wav_lengths[row])
            write_wav(os.path.join(args.results_path, f"{uid}_pred.wav"), wav[row, :n],
                      args.sample_rate)
            unit_lines.append(f"{uid}|" + " ".join(str(int(u)) for u in units[row, :counts[row]]))
            audio_s += n / args.sample_rate
            n_wav += 1
    if mesh.index == 0:
        with open(os.path.join(args.results_path, f"s2st-{args.gen_subset}.unit"), "w") as f:
            f.write("\n".join(unit_lines) + "\n")
    wall = time.time() - t0
    logger.info("synthesized %d waveforms (%.1f audio-s) in %.1f s (RTF %.1f) on %s -> %s",
                n_wav, audio_s, wall, audio_s / max(wall, 1e-9), device, args.results_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
