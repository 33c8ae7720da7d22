"""Average model parameters across checkpoints (port of
diffnorm_tpu/cli/average_checkpoints.py; reference
scripts/average_checkpoints.py, used to average the best-k before
evaluation).

  python -m diffnorm_tpu_torch.cli.average_checkpoints \\
      --inputs ckpt/nar/step_000390000 ckpt/nar/step_000400000 --output ckpt/nar/avg

`--inputs` are step directories or weights.save_npz files with the same
tree; `--output` is a step directory whose `params.npz` every CLI that takes
a step directory reads. Floating leaves are averaged in float64 and cast
back to their type; other leaves are the first input's, as in JAX. bf16
leaves, which np.load reads back as raw 2-byte voids, are averaged too and
rounded to bf16, as JAX's jnp.issubdtype check averages them
(average_checkpoints.py:19-28); the output holds them widened to float32,
as every file of the port does.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from diffnorm_tpu_torch.train.checkpoint import PARAMS, load_tree
from diffnorm_tpu_torch.weights import flatten_tree, save_npz, unflatten_tree


def _bf16_bits(a: np.ndarray) -> bool:
    """A bf16 leaf as np.load gives it back: 2-byte voids."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def _widened(a: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as float32."""
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def average_checkpoints(paths: Sequence[str]) -> Dict:
    flats = [flatten_tree(load_tree(p)) for p in paths]
    for path, flat in zip(paths[1:], flats[1:]):
        if set(flat) != set(flats[0]):
            raise ValueError(f"{path} does not hold the tree of {paths[0]}: "
                             f"{sorted(set(flat) ^ set(flats[0]))[:10]}")
    out = {}
    for key, first in flats[0].items():
        if np.issubdtype(first.dtype, np.floating):
            mean = sum(np.asarray(f[key], np.float64) for f in flats) / len(flats)
            out[key] = mean.astype(first.dtype)
        elif _bf16_bits(first):
            mean = sum(_widened(f[key]).astype(np.float64) for f in flats) / len(flats)
            out[key] = torch.from_numpy(mean).to(torch.bfloat16).float().numpy()
        else:
            out[key] = first
    return unflatten_tree(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    tree = average_checkpoints(args.inputs)
    os.makedirs(args.output, exist_ok=True)
    save_npz(os.path.join(args.output, PARAMS), tree)
    print(f"averaged {len(args.inputs)} checkpoints -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
