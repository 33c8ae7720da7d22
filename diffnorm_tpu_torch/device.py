"""Device selection for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The torch.device to run on, with the CUDA index filled in. Raises
    rather than fall back to the CPU when CUDA is asked for and absent: the
    CPU runs only when asked for."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' (CLI: --cpu) to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
