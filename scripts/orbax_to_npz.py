#!/usr/bin/env python3
"""Bridge a checkpoint the JAX package wrote (orbax) to the PyTorch port.

  python scripts/orbax_to_npz.py CKPT OUT

CKPT is an orbax directory: a step directory of the JAX trainer's
CheckpointManager (a saved TrainState), a bare StandardCheckpointer
variables tree, or an output of `diffnorm_tpu.cli.convert_checkpoint`. It is
restored with `diffnorm_tpu.train.checkpoint.load_checkpoint_params` and
`restored_to_variables`, so a TrainState's frozen subtrees (the normalizer's
VAE) are folded back into its params and its model-state collections
(batch_stats) kept.

A TrainState's optimizer state comes along in OUT/optax_state.npz: its
`opt_state` tree (each array under "opt_state/<path>", and under "tree" the
JSON of the tree with each array named by its key and each empty state
null), its `step`, and its `ema_params` where it keeps an EMA (under
"ema_params/<path>"). The checkpoint's JSON sidecar (CKPT.json: epoch,
iterator position, a host-driven schedule's state), where there is one, is
copied to OUT.json. `cli.train --restore-file OUT` without
--reset-optimizer then continues the run in the port; its generators are
seeded from --seed, as JAX's PRNG keys cannot become torch generators.

OUT becomes a step directory of the port: OUT/params.npz in the format of
`diffnorm_tpu_torch.weights.save_npz` ('/'-joined flax paths, every leaf
float32, bf16 widened), which `cli.generate --path`, `cli.s2st
--params-npz`, `cli.diff_norm_synthesis --ckpt`, `cli.prepare --hubert-ckpt`,
`cli.validate --path` and `cli.train --restore-file --reset-optimizer` read.
The file is written with numpy alone; the script needs JAX and orbax, not
torch, and runs where the JAX package is installed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Dict, Mapping, Tuple

import numpy as np


def flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """{'/'-joined path: float32 array} of a nested dict of arrays."""
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(flatten(value, path))
        else:
            flat["/".join(path)] = np.asarray(value).astype(np.float32)
    return flat


def optax_arrays(opt_state, step, ema_params) -> Dict[str, np.ndarray]:
    """The arrays of OUT/optax_state.npz (see the module docstring)."""
    arrays: Dict[str, np.ndarray] = {"step": np.asarray(step, np.int64)}

    def skeleton(node, path: Tuple[str, ...]):
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {str(k): skeleton(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [skeleton(v, path + (str(i),)) for i, v in enumerate(node)]
        key = "/".join(("opt_state",) + path)
        arrays[key] = np.asarray(node)
        return key

    arrays["tree"] = np.asarray(json.dumps(skeleton(opt_state, ())))
    if ema_params is not None:
        arrays.update({"ema_params/" + k: v for k, v in flatten(ema_params).items()})
    return arrays


def bridge(ckpt: str, out: str) -> int:
    """Write OUT/params.npz (and for a TrainState OUT/optax_state.npz and
    OUT.json) from the orbax checkpoint CKPT; returns the weights' leaf
    count."""
    from diffnorm_tpu.train.checkpoint import load_checkpoint_params, restored_to_variables

    restored = load_checkpoint_params(ckpt)
    variables = restored_to_variables(restored)
    if variables is None:
        raise ValueError(f"{ckpt}: neither a TrainState nor a variables tree "
                         f"(top-level keys {sorted(restored)})")
    flat = flatten(variables)
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "params.npz"), **flat)
    if "opt_state" in restored:
        np.savez(os.path.join(out, "optax_state.npz"),
                 **optax_arrays(restored["opt_state"], restored["step"],
                                restored.get("ema_params")))
        sidecar = ckpt.rstrip("/") + ".json"
        if os.path.exists(sidecar):
            shutil.copyfile(sidecar, out.rstrip("/") + ".json")
    return len(flat)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ckpt", help="orbax checkpoint directory")
    p.add_argument("out", help="step directory to write (OUT/params.npz)")
    args = p.parse_args(argv)
    if os.path.exists(os.path.join(args.out, "params.npz")):
        raise SystemExit(f"refusing to overwrite {args.out}/params.npz")
    n = bridge(args.ckpt, args.out)
    print(f"wrote {n} arrays -> {os.path.join(args.out, 'params.npz')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
