"""Task base (the port's copy of diffnorm_tpu/tasks/base.py): a task owns
the dictionary and the datasets, builds the model and the criterion from
the CLI's arguments, prepares each batch, and names the parameter subtrees
that stay frozen."""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np

from torch import nn


class Task:
    # top-level submodules of the model that the optimizer leaves alone
    frozen_param_keys: Tuple[str, ...] = ()

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.datasets: Dict[str, object] = {}
        self.tgt_dict = None

    def build_model(self) -> nn.Module:
        raise NotImplementedError

    def build_criterion(self):
        raise NotImplementedError

    def load_dataset(self, split: str) -> None:
        raise NotImplementedError

    def dataset(self, split: str):
        if split not in self.datasets:
            self.load_dataset(split)
        return self.datasets[split]

    def prepare_batch(self, batch: Dict, rng: np.random.Generator) -> Dict:
        """A collated batch made ready for the criterion, drawing from `rng`
        (default: as it is)."""
        return batch

    def load_frozen_params(self, model: nn.Module) -> None:
        """Restore the frozen subtrees from an earlier stage (default: none)."""
