#!/usr/bin/env python3
"""Wall time of the port's DDIM main path on one GPU, repeated.

  python3 time_main_path.py [--root DIR] [--reps 5] [--quant-int8 --int8-route R]

Imports `diffnorm_tpu_torch` from DIR (default: beside this file), so one
call can time two checkouts of the port on the same card, e.g. a parent
unpacked with `git archive` and the working tree, in the order parent,
change, change, parent. Runs chip_smoke.py's main path: the released
diff_discrete width from `torch.manual_seed(0)`, B64 x T128, 49 DDIM steps,
bf16 (int8 W8A8 on route R with --quant-int8), after one warm-up call. Prints
one JSON line per repetition (host wall around a run that ends in
`torch.cuda.synchronize()`) and a summary line with the median and the spread.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, T, START_STEP = 64, 128, 50
SECONDS_PER_UNIT = 0.02


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent))
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--quant-int8", action="store_true")
    p.add_argument("--int8-route", default="fused_layer")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_main_path: this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.ops import _build

    if not Path(_build.__file__).resolve().is_relative_to(root):
        print(f"time_main_path: imported {_build.__file__}, not from {root}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(_build.KERNELS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]

    torch.manual_seed(0)
    kw = dict(quant_int8=True, int8_route=args.int8_route) if args.quant_int8 else {}
    with torch.device("cuda"):
        model = LatentDiffusionModule(**kw)
    model = model.to(torch.bfloat16).eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    feature = torch.randn(B, T, 768, generator=g, device="cuda")
    mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
    enc = torch.randn(B, T, 128, generator=g, device="cuda")
    init = torch.randn(B, T, 128, generator=g, device="cuda")

    def run(start_step, stride=1):
        return ddim_sample(model, feature, mask, start_step=start_step, stride=stride,
                           enc_noise=enc, init_noise=init, device="cuda")

    run(START_STEP, stride=START_STEP)  # warm-up: one denoiser call
    what = f"int8 route {args.int8_route}" if args.quant_int8 else "bf16"
    walls = []
    for rep in range(args.reps):
        _build.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(START_STEP)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(json.dumps({"root": str(root), "path": what, "rep": rep, "wall_s": walls[-1],
                          "launches": dict(_build.launch_counts)}))
    med = statistics.median(walls)
    print(json.dumps({"root": str(root), "path": what, "median_wall_s": med,
                      "min_wall_s": min(walls), "max_wall_s": max(walls),
                      "median_rtf": B * T * SECONDS_PER_UNIT / med, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
