"""Speaker-normalization CLI, TranSpeech's baseline data prep (the port of
diffnorm_tpu/cli/speech_norm.py; reference research/TranSpeech/hubertCTC/
gen_SN.py). For each split under --wav, three passes:

1. every utterance's median f0 (YIN on the device), and the split's mean
   of the medians below --max-voiced-median (250 Hz, as the reference
   filters them);
2. every utterance pitch-shifted so that its median lands on that mean;
3. every shifted utterance scaled to the split's mean |x|,

written to `{out}/{split}/result/{name}.wav`. This is the normalization
DiffNorm's diffusion normalizer (cli.diff_norm_synthesis) replaces.

  python -m diffnorm_tpu_torch.cli.speech_norm --wav WAV_ROOT --out OUT_ROOT \\
      [--splits train,test,dev] [--sr 16000] [--cpu]

The pitch tracker runs on the GPU unless --cpu is given; the shifts and the
energy scaling run on the host in numpy, as JAX's do. Each pass logs its
wall time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from diffnorm_tpu_torch.cli.generate_waveform import write_wav
from diffnorm_tpu_torch.data.audio import read_audio
from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.ops.speech_norm import (
    mean_abs_energy,
    normalize_energy,
    pitch_median,
    shift_to_median,
)
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--wav", required=True, help="root directory of {split}/*.wav")
    p.add_argument("--out", required=True)
    p.add_argument("--splits", default="train,test,dev")
    p.add_argument("--sr", type=int, default=16000,
                   help="the sample rate of a file whose header gives none")
    p.add_argument("--max-voiced-median", type=float, default=250.0,
                   help="medians above this stay out of the split's mean (gen_SN.py:27-29)")
    p.add_argument("--cpu", action="store_true", help="run the pitch tracker on the CPU")
    return p.parse_args(argv)


def normalize_split(wav_root: str, out_root: str, split: str, default_sr: int,
                    max_voiced_median: float, device) -> Optional[dict]:
    """The three passes over one split; None where it has no .wav file.
    Returns {"medians": {name: Hz}, "target_median", "target_energy",
    "seconds": per pass}."""
    paths = sorted(Path(wav_root, split).glob("*.wav"))
    if not paths:
        print(f"[{split}] no wavs under {Path(wav_root, split)}", file=sys.stderr)
        return None
    seconds = {}
    t0 = time.perf_counter()
    wavs, medians = {}, {}
    for path in paths:
        wav, sr = read_audio(str(path))
        sr = sr or default_sr
        wavs[path.stem] = (wav, sr)
        medians[path.stem] = pitch_median(wav, sr, device=device)
    voiced = [m for m in medians.values() if 0.0 < m < max_voiced_median]
    target_median = float(np.mean(voiced)) if voiced else 0.0
    seconds["medians"] = time.perf_counter() - t0
    print(f"[{split}] {len(paths)} utts, mean voiced median {target_median:.1f} Hz")

    t0 = time.perf_counter()
    shifted, energies = {}, []
    for name, (wav, sr) in wavs.items():
        out = shift_to_median(wav, sr, target_median, device=device)
        shifted[name] = (out, sr)
        energies.append(mean_abs_energy(out))
    target_energy = float(np.mean(energies)) if energies else 0.0
    seconds["shift"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    result_dir = Path(out_root, split, "result")
    os.makedirs(result_dir, exist_ok=True)
    for name, (wav, sr) in shifted.items():
        write_wav(str(result_dir / f"{name}.wav"), normalize_energy(wav, target_energy), sr)
    seconds["energy"] = time.perf_counter() - t0
    print(f"[{split}] wrote {len(shifted)} normalized wavs -> {result_dir} (medians "
          f"{seconds['medians']:.2f} s, shift {seconds['shift']:.2f} s, energy "
          f"{seconds['energy']:.2f} s)")
    return {"medians": medians, "target_median": target_median,
            "target_energy": target_energy, "seconds": seconds}


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    for split in args.splits.split(","):
        normalize_split(args.wav, args.out, split, args.sr, args.max_voiced_median, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
