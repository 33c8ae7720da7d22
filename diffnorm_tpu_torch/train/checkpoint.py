"""The port's checkpoints: keep-best-k / keep-last-N rotation as in
diffnorm_tpu/train/checkpoint.py, in a format of the port's own.

  save_dir/
    step_000000100/params.npz   the model's variables tree in flax paths
                                (weights.save_npz of to_jax_variables:
                                "params", and "batch_stats" where the model
                                has BatchNorm statistics): the normalizer's is
                                what cli.diff_norm_synthesis --params-npz reads,
                                the NAR model's what cli.s2st --params-npz does;
                                or a tree of the caller's (the GAN fine-tune's
                                {"g_params", "d_params"}, which
                                cli.generate_waveform --vocoder reads)
    step_000000100/trainer.pt   the optimizer's state, the update count, the
                                generators and the EMA (Trainer.state_dict)
    step_000000100.json         step, metric, epoch, iterator position, and
                                a host-driven schedule's state

A step directory bridged from a JAX TrainState (`scripts/orbax_to_npz.py`)
holds `optax_state.npz` in place of trainer.pt: "step", the `opt_state`
tree's arrays under "opt_state/<path>" and the EMA's under
"ema_params/<path>", and under "tree" the JSON of the opt_state tree, each
array leaf named by its key, each empty state null (`load_optax_state`).
    manifest.json               {"checkpoints": [...], "best": ..., "last": ...}

A step directory is written under a temporary name and renamed, so a
crash never leaves the manifest naming a partial checkpoint.

The format does not depend on the world size. Under data parallelism
(`parallel/`) rank 0 alone writes, the whole state: `Trainer.gathered_master`
gathers the float32 masters a --fsdp run splits, `Trainer.state_dict` the
optimizer state and EMA that --zero-sharding os and --fsdp split; every rank
reads the whole checkpoint and `Trainer.load_state_dict` keeps its slice.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from diffnorm_tpu_torch.weights import (
    as_variables,
    load_npz,
    save_npz,
    to_jax_variables,
    unflatten_tree,
)

PARAMS, TRAINER, OPTAX_STATE = "params.npz", "trainer.pt", "optax_state.npz"


def load_tree(path: str) -> dict:
    """The tree of a checkpoint step directory's params.npz, or of a .npz
    file, as it was saved."""
    return load_npz(os.path.join(path, PARAMS) if os.path.isdir(path) else path)


def load_variables(path: str) -> dict:
    """The variables tree of a checkpoint step directory, or of a .npz file
    (one holding a params tree alone is taken as its "params")."""
    return as_variables(load_tree(path))


def load_params(path: str) -> dict:
    """The params tree of a checkpoint step directory (or of a .npz file)."""
    return load_variables(path)["params"]


def load_optax_state(path: str) -> Dict[str, Any]:
    """{"opt_state": the JAX opt_state tree (lists, dicts, None, numpy
    arrays), "step": int, "ema_params": the EMA's tree or None} of a
    bridged step directory."""
    import numpy as np

    with np.load(os.path.join(path, OPTAX_STATE)) as data:
        arrays = {k: data[k] for k in data.files}

    def build(node):
        if isinstance(node, str):
            return arrays[node]
        if isinstance(node, list):
            return [build(v) for v in node]
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return None

    ema = {tuple(k.split("/")[1:]): v for k, v in arrays.items() if k.startswith("ema_params/")}
    return {"opt_state": build(json.loads(str(arrays["tree"]))), "step": int(arrays["step"]),
            "ema_params": unflatten_tree(ema) if ema else None}


class CheckpointManager:
    def __init__(self, save_dir: str, keep_last: int = 5, keep_best: int = 5,
                 maximize: bool = False):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.keep_last, self.keep_best, self.maximize = keep_last, keep_best, maximize
        self._manifest_path = os.path.join(self.save_dir, "manifest.json")
        self.manifest = {"checkpoints": []}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)

    def path(self, step: int) -> str:
        return os.path.join(self.save_dir, f"step_{step:09d}")

    def save(self, step: int, model: Union[torch.nn.Module, Mapping], trainer_state: Dict,
             metric_value: Optional[float] = None, extra: Optional[Dict[str, Any]] = None) -> str:
        """Write step `step`: `model`'s variables tree (or `model` itself
        where it is a tree already) and `trainer_state`."""
        path = self.path(step)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        tree = to_jax_variables(model) if isinstance(model, torch.nn.Module) else model
        save_npz(os.path.join(tmp, PARAMS), tree)
        torch.save(trainer_state, os.path.join(tmp, TRAINER))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        with open(path + ".json", "w") as f:
            json.dump({"step": step, "metric": metric_value, **(extra or {})}, f)
        entries = [e for e in self.manifest["checkpoints"] if e["step"] != step]
        entries.append({"step": step, "metric": metric_value})
        self.manifest["checkpoints"] = sorted(entries, key=lambda e: e["step"])
        self._rotate()
        tmp_manifest = self._manifest_path + ".tmp"
        with open(tmp_manifest, "w") as f:
            json.dump(self.manifest, f, indent=2)
        os.replace(tmp_manifest, self._manifest_path)
        return path

    def _rotate(self) -> None:
        """Keep the last `keep_last` and the `keep_best` best by metric (the
        lowest, the highest with `maximize`; all when keep_last <= 0);
        delete the rest."""
        entries = self.manifest["checkpoints"]
        keep = {e["step"] for e in (entries[-self.keep_last:] if self.keep_last > 0 else entries)}
        scored = sorted((e for e in entries if e.get("metric") is not None),
                        key=lambda e: -e["metric"] if self.maximize else e["metric"])
        if scored and self.keep_best > 0:
            keep.update(e["step"] for e in scored[:self.keep_best])
            self.manifest["best"] = scored[0]["step"]
        if entries:
            self.manifest["last"] = entries[-1]["step"]
        for e in list(entries):
            if e["step"] not in keep:
                shutil.rmtree(self.path(e["step"]), ignore_errors=True)
                if os.path.exists(self.path(e["step"]) + ".json"):
                    os.remove(self.path(e["step"]) + ".json")
                entries.remove(e)

    def latest_step(self) -> Optional[int]:
        return self.manifest.get("last")

    def load(self, step: int, device) -> Tuple[dict, Dict, Dict[str, Any]]:
        """(variables tree, trainer state, sidecar) of checkpoint `step`."""
        path = self.path(step)
        state = torch.load(os.path.join(path, TRAINER), map_location=device)
        with open(path + ".json") as f:
            extra = json.load(f)
        return load_variables(path), state, extra
