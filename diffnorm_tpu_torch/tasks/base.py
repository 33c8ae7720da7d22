"""Task base (the port's copy of diffnorm_tpu/tasks/base.py): a task owns
the dictionary and the datasets, builds the model and the criterion from
the CLI's arguments, prepares each batch, and names the parameter subtrees
that stay frozen. `--data dir1:dir2:...` shards the training data: epoch e
trains on shard (e - 1) % n, and every other split reads the first
(fairseq's split_paths, JAX tasks/base.py:48-80)."""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np

from torch import nn


class Task:
    # top-level submodules of the model that the optimizer leaves alone
    frozen_param_keys: Tuple[str, ...] = ()
    # a dummy task: synthetic batches, no data on disk
    synthetic: bool = False

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.datasets: Dict[str, object] = {}
        self._loaded_shard: Dict[str, int] = {}
        self.tgt_dict = None

    def build_model(self) -> nn.Module:
        raise NotImplementedError

    def build_criterion(self):
        raise NotImplementedError

    def _data_shards(self) -> List[str]:
        return [p for p in str(self.args.data or "").split(":") if p]

    def has_sharded_data(self) -> bool:
        return len(self._data_shards()) > 1

    def data_path(self, epoch: int = 1) -> str:
        """The data directory of `epoch`: the shards rotate per epoch; epoch 1
        (every split but the training one) reads the first."""
        shards = self._data_shards()
        if not shards:
            return self.args.data or ""
        return shards[(epoch - 1) % len(shards)]

    def load_dataset(self, split: str, epoch: int = 1) -> None:
        raise NotImplementedError

    def dataset(self, split: str, epoch: int = 1):
        """The split's dataset; a training split of sharded data is reloaded
        when `epoch` names another shard than the one loaded."""
        if self.has_sharded_data() and split.startswith("train"):
            shard = (epoch - 1) % len(self._data_shards())
            if self._loaded_shard.get(split) != shard:
                self.datasets.pop(split, None)
                self.load_dataset(split, epoch=epoch)
                self._loaded_shard[split] = shard
        if split not in self.datasets:
            self.load_dataset(split, epoch=epoch)
        return self.datasets[split]

    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """A collated batch made ready for the criterion, drawing from `rng`
        (default: as it is)."""
        return batch

    def load_frozen_params(self, model: nn.Module) -> None:
        """Restore the frozen subtrees from an earlier stage (default: none)."""
