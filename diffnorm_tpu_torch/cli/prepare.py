"""Preprocessing CLI: mHuBERT feature dump and k-means unit quantization
(PyTorch port of diffnorm_tpu/cli/prepare.py).

  # per-utterance layer-11 features and their manifest
  python -m diffnorm_tpu_torch.cli.prepare dump-features \\
      --manifest data/train.tsv --hubert-ckpt mhubert.pt --layer 11 \\
      --out-dir feat/ --split train

  # fit K=1000 k-means on the dumped features (mini-batch Lloyd's)
  python -m diffnorm_tpu_torch.cli.prepare learn-kmeans \\
      --feat-dir feat/ --split train --num-clusters 1000 --out km.npy

  # units, one `utt|u u u` line per utterance
  python -m diffnorm_tpu_torch.cli.prepare quantize \\
      --feat-dir feat/ --split train --kmeans km.npy --out train.units

The manifest is wav2vec-style (`cli.get_manifest`). The files are JAX's:
`{utt}.feat.npy` [frames, dim] float32, `{split}.manifest.tsv`, centroids as
`.npy` (or a joblib sklearn KMeans where joblib is installed), unit lines.
`--hubert-ckpt` takes a fairseq `.pt` (through `utils.convert_weights`), a
`weights.save_npz` file or a `cli.train` step directory (where JAX takes an
orbax directory), or nothing: a random encoder from seed 0, with JAX's
warning.

Runs on the card unless --cpu is given, in float32 as JAX does: `main` turns
TF32 off for cuBLAS and cuDNN, so the card's float32 convolutions and
products run in full float32 (cuDNN would take TF32 for convolutions by
default). On the card, self-attention over 2048 or more frames (utterances
of 41 s or more) runs the flash-attention kernel.

Each utterance goes through the encoder in chunks of `CHUNK` samples, each
chunk at its own length. The JAX CLI pads each chunk with zeros to a length
bucket of 2-100 s and runs the encoder without a mask, so the padding enters
the layer-0 GroupNorm's statistics over time and every attention row, and
its features differ from the encoder's on the utterance alone (a fault of
the reference, ROADMAP Queue 3); the port gives the latter, as fairseq's
feature reader does.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffnorm_tpu_torch.data.audio import read_audio
from diffnorm_tpu_torch.data.manifest import read_feature_manifest, write_feature_manifest
from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.models.hubert import HubertEncoder, frames_for_samples
from diffnorm_tpu_torch.models.kmeans import (
    kmeans_fit,
    kmeans_predict,
    load_centroids,
    save_centroids,
)
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache
from diffnorm_tpu_torch.utils.convert_weights import convert_hubert_state, load_torch_state
from diffnorm_tpu_torch.weights import from_jax_params

logger = logging.getLogger("diffnorm_tpu_torch.prepare")

CHUNK = 1_600_000  # max samples per encoder forward (100 s at 16 kHz)
SAMPLE_RATE = 16000


def read_audio_manifest(path: str) -> List[Tuple[str, str]]:
    """wav2vec-style manifest: the root on the first line, then
    `rel_path\\tn_samples`. Returns [(utt_id, abs_path)]."""
    out = []
    with open(path) as f:
        root = f.readline().strip()
        for line in f:
            line = line.strip()
            if not line:
                continue
            rel = line.split("\t")[0]
            out.append((os.path.splitext(os.path.basename(rel))[0], os.path.join(root, rel)))
    return out


def _infer_hubert_arch(params) -> dict:
    """The transformer's shape from a HubertEncoder params tree (layers,
    width, FFN width; fairseq's 64-d heads). The conv-extractor spec is not
    stored in the weights and stays at the released default."""
    layers = sum(1 for k in params if k.startswith("layer_") and k[len("layer_"):].isdigit())
    dim = params["post_extract_proj"]["kernel"].shape[1]
    ffn_dim = params["layer_0"]["fc1"]["kernel"].shape[1]
    return dict(dim=int(dim), layers=layers, heads=max(1, int(dim) // 64), ffn_dim=int(ffn_dim))


def load_hubert(ckpt: Optional[str], device: torch.device) -> HubertEncoder:
    """The float32 encoder of `--hubert-ckpt` on `device`, in eval mode."""
    if ckpt and (os.path.isdir(ckpt) or ckpt.endswith(".npz")):
        params = load_variables(ckpt)["params"]
        logger.info("loaded HuBERT weights from %s", ckpt)
    elif ckpt:
        sd = load_torch_state(ckpt)
        n_layers = 1 + max((int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers.")),
                           default=11)
        params = convert_hubert_state(sd, layers=n_layers)["params"]
        logger.info("converted torch HuBERT weights from %s (%d layers)", ckpt, n_layers)
    else:
        logger.warning("no --hubert-ckpt: using randomly initialized encoder")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = HubertEncoder()
        return model.to(device).eval()
    with torch.device(device):
        model = HubertEncoder(**_infer_hubert_arch(params))
    return from_jax_params(model, params).eval()


def build_hubert(ckpt: Optional[str], layer: int,
                 device: torch.device) -> Callable[[np.ndarray], np.ndarray]:
    """`extract(wav)`: the layer-`layer` features [frames, dim] (float32
    numpy) of one 16 kHz waveform, chunked at CHUNK samples."""
    model = load_hubert(ckpt, device)

    @torch.no_grad()
    def extract(wav: np.ndarray) -> np.ndarray:
        feats = [np.zeros((0, model.dim), np.float32)]
        for start in range(0, len(wav), CHUNK):
            piece = np.ascontiguousarray(wav[start:start + CHUNK], dtype=np.float32)
            if frames_for_samples(len(piece)) <= 0:
                continue  # shorter than the extractor's receptive field: no frame
            x = torch.from_numpy(piece).to(device)[None]
            feats.append(model(x, output_layer=layer)[0].float().cpu().numpy())
        return np.concatenate(feats, axis=0)

    return extract


def cmd_dump_features(args, device: torch.device) -> None:
    extract = build_hubert(args.hubert_ckpt, args.layer, device)
    os.makedirs(args.out_dir, exist_ok=True)
    rows, audio_s = [], 0.0
    t0 = time.time()
    for utt, path in read_audio_manifest(args.manifest):
        wav, sr = read_audio(path)
        if sr != SAMPLE_RATE:
            raise ValueError(f"{path}: expected {SAMPLE_RATE} Hz, got {sr}")
        feat = extract(wav)
        name = f"{utt}.feat.npy"
        np.save(os.path.join(args.out_dir, name), feat)
        rows.append((name, feat.shape[0]))
        audio_s += len(wav) / SAMPLE_RATE
    write_feature_manifest(os.path.join(args.out_dir, f"{args.split}.manifest.tsv"),
                           os.path.abspath(args.out_dir), rows)
    wall = time.time() - t0
    logger.info("dumped %d utterances (%.1f audio-s) in %.2f s (RTF %.1f) on %s", len(rows),
                audio_s, wall, audio_s / max(wall, 1e-9), device)


def _iter_feats(feat_dir: str, split: str):
    manifest = read_feature_manifest(os.path.join(feat_dir, f"{split}.manifest.tsv"))
    for utt, (path, _) in manifest.items():
        yield utt, np.load(path)


def cmd_learn_kmeans(args, device: torch.device) -> None:
    all_feats = np.concatenate([f for _, f in _iter_feats(args.feat_dir, args.split)], axis=0)
    if args.max_frames and len(all_feats) > args.max_frames:
        idx = np.random.default_rng(0).choice(len(all_feats), args.max_frames, replace=False)
        all_feats = all_feats[idx]
    logger.info("fitting K=%d on %d frames", args.num_clusters, len(all_feats))
    t0 = time.time()
    centroids = kmeans_fit(all_feats, args.num_clusters, iters=args.iters, device=device)
    save_centroids(args.out, centroids)
    logger.info("saved centroids to %s (%.2f s on %s)", args.out, time.time() - t0, device)


def cmd_quantize(args, device: torch.device) -> None:
    centroids = torch.from_numpy(load_centroids(args.kmeans)).to(device)
    with open(args.out, "w") as f:
        for utt, feat in _iter_feats(args.feat_dir, args.split):
            units = kmeans_predict(torch.from_numpy(feat).to(device), centroids).cpu().numpy()
            f.write(f"{utt}|{' '.join(str(int(u)) for u in units)}\n")
    logger.info("wrote units to %s", args.out)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dump-features")
    d.add_argument("--manifest", required=True)
    d.add_argument("--hubert-ckpt", default=None,
                   help="fairseq .pt, weights.save_npz file or cli.train step directory")
    d.add_argument("--layer", type=int, default=11)
    d.add_argument("--out-dir", required=True)
    d.add_argument("--split", default="train")

    k = sub.add_parser("learn-kmeans")
    k.add_argument("--feat-dir", required=True)
    k.add_argument("--split", default="train")
    k.add_argument("--num-clusters", type=int, default=1000)
    k.add_argument("--iters", type=int, default=50)
    k.add_argument("--max-frames", type=int, default=2_000_000)
    k.add_argument("--out", required=True)

    q = sub.add_parser("quantize")
    q.add_argument("--feat-dir", required=True)
    q.add_argument("--split", default="train")
    q.add_argument("--kmeans", required=True)
    q.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    {"dump-features": cmd_dump_features,
     "learn-kmeans": cmd_learn_kmeans,
     "quantize": cmd_quantize}[args.cmd](args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
