"""Unit-to-waveform CLI (PyTorch port of diffnorm_tpu/cli/generate_waveform.py;
reference examples/speech_to_speech/generate_waveform_from_code.py).

  python -m diffnorm_tpu_torch.cli.generate_waveform \\
      --in-code-file R/hyp.unit --vocoder V --vocoder-cfg V.json \\
      --results-path R/wav --dur-prediction [--reduce] [--cpu]

Reads one utterance of units per line (`id|u1 u2 ...`, `id\\tu1 u2 ...` or
bare units; a non-numeric token becomes an invalid code, which the vocoder
drops), synthesizes each through the code-HiFi-GAN of --vocoder-cfg
(optionally reduced and duration-expanded) and writes `{i}_pred.wav` at
--sample-rate for the i-th non-empty line; a line with no valid code gives
20 ms of silence. --vocoder is a fairseq checkpoint (`.pt`, `.ckpt`,
`.bin`, through `utils/convert_weights.py`), or a `weights.save_npz` file
or a step directory holding one, whose tree is the vocoder's variables, its
params alone, or a GAN state with them under `g_params`. Runs in float32,
on the GPU unless --cpu is given. `--int8-vocoder dynamic|static` runs the
narrow stages' ResBlock convs W8A8, as JAX's DIFFNORM_INT8_VOCODER
(`models/hifigan.py`; static calibrates on JAX's seeded batch first).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import wave
from typing import Optional, Sequence

import numpy as np
import torch

from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.models.hifigan import INT8_MODES, CodeHiFiGANVocoder
from diffnorm_tpu_torch.train.checkpoint import load_tree
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache
from diffnorm_tpu_torch.weights import as_variables

logger = logging.getLogger("diffnorm_tpu_torch.generate_waveform")


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 16000) -> None:
    """16-bit PCM mono, clipped to [-1, 1]."""
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    pcm = (wav * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def parse_code_line(line: str) -> np.ndarray:
    """A unit line -> int32 codes; a non-numeric token (an <unk> from an
    undertrained model) becomes -1."""
    line = line.strip()
    if "|" in line:
        _, units = line.split("|", 1)
    elif "\t" in line:
        _, units = line.split("\t", 1)
    else:
        units = line

    def to_code(x: str) -> int:
        try:
            return int(x)
        except ValueError:
            return -1

    return np.asarray([to_code(x) for x in units.split()], np.int32)


def load_vocoder(ckpt_path: str, cfg_path: str, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 int8_vocoder: str = "off") -> CodeHiFiGANVocoder:
    """The code-HiFi-GAN of config `cfg_path` with the weights of
    `ckpt_path` (see the module docstring), on `device`: the card unless
    `device="cpu"` is asked for (raises without CUDA); `int8_vocoder` as
    `CodeHiFiGANVocoder.from_config` takes it."""
    device = resolve_device(device)
    with open(cfg_path) as f:
        cfg = json.load(f)
    if ckpt_path.endswith((".pt", ".ckpt", ".bin")):
        from diffnorm_tpu_torch.utils.convert_weights import convert_hifigan_checkpoint

        variables = convert_hifigan_checkpoint(ckpt_path, cfg)
    else:
        tree = load_tree(ckpt_path)
        # a GAN fine-tune's state: the generator subtree is the vocoder
        variables = {"params": tree["g_params"]} if "g_params" in tree else as_variables(tree)
    return CodeHiFiGANVocoder.from_config(cfg, variables, device=device, dtype=dtype,
                                          int8_vocoder=int8_vocoder)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--in-code-file", required=True)
    p.add_argument("--vocoder", required=True)
    p.add_argument("--vocoder-cfg", required=True)
    p.add_argument("--results-path", required=True)
    p.add_argument("--dur-prediction", action="store_true")
    p.add_argument("--reduce", action="store_true")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--int8-vocoder", choices=INT8_MODES, default="off",
                   help="W8A8 ResBlock convs on the narrow stages")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args = parse_args(argv)
    vocoder = load_vocoder(args.vocoder, args.vocoder_cfg, device="cpu" if args.cpu else "cuda",
                           int8_vocoder=args.int8_vocoder)
    os.makedirs(args.results_path, exist_ok=True)
    with open(args.in_code_file) as f:
        lines = [line for line in f if line.strip()]
    for i, line in enumerate(lines):
        units = parse_code_line(line)
        if (units >= 0).any():
            wav = vocoder(units, dur_prediction=args.dur_prediction, reduce=args.reduce)
        else:  # nothing synthesizable on this line
            wav = np.zeros(args.sample_rate // 50, np.float32)
        write_wav(os.path.join(args.results_path, f"{i}_pred.wav"), wav, args.sample_rate)
    logger.info("wrote %d waveforms to %s", len(lines), args.results_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
