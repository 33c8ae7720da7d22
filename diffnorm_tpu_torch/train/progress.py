"""Progress sinks (the port's copy of diffnorm_tpu/train/progress.py;
reference fairseq/logging/progress_bar.py): `--log-format json` prints one
JSON object per logged step to stdout, and `--tensorboard-logdir` /
`--wandb-project` write to TensorBoard (torch.utils.tensorboard) and W&B
where those packages are installed, with a warning where not, as JAX gates
them. The simple format is the CLI's own log line.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Dict, Optional

logger = logging.getLogger(__name__)

LOG_FORMATS = ("simple", "json")


class ProgressWriter:
    """Fans a step's metrics out to the configured sinks."""

    def __init__(self, log_format: str = "simple", tensorboard_logdir: Optional[str] = None,
                 wandb_project: Optional[str] = None, tag: str = "train"):
        if log_format not in LOG_FORMATS:
            raise ValueError(f"log_format must be one of {LOG_FORMATS}, got {log_format!r}")
        self.log_format, self.tag = log_format, tag
        self._tb = self._wandb = None
        if tensorboard_logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(tensorboard_logdir, tag))
            except Exception as e:  # tensorboard is not installed
                logger.warning("tensorboard unavailable: %s", e)
        if wandb_project:
            try:
                import wandb

                wandb.init(project=wandb_project, reinit=False)
                self._wandb = wandb
            except Exception as e:
                logger.warning("wandb unavailable: %s", e)

    def log(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        if self.log_format == "json":
            payload = {"step": step, **{f"{prefix}{k}": v for k, v in metrics.items()}}
            print(json.dumps(payload), file=sys.stdout, flush=True)
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{prefix}{k}", v, step)
        if self._wandb is not None:
            self._wandb.log({f"{prefix}{k}": v for k, v in metrics.items()}, step=step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
