"""Code-HiFi-GAN unit-to-waveform vocoder with its duration predictor,
inference only.

Counterpart of diffnorm_tpu/models/hifigan.py (reference hifigan.py,
codehifigan.py, fastspeech2.py:VariancePredictor):
  Generator: conv_pre (k7) -> [leaky_relu -> transposed-conv upsample ->
  mean of MRF ResBlocks] per stage -> leaky_relu(0.01) -> conv_post -> tanh
  ResBlock: dilated conv pairs with leaky-relu (slope 0.1)
  CodeGenerator: unit embedding table, optional duration predictor
  (round(exp(d) - 1), min 1); with `num_speakers` (a config's `multispkr`)
  a speaker table `spkr` whose row of each utterance's speaker is
  concatenated to every unit embedding (broadcast over time, the
  generator's input doubling to 2 x embedding_dim)
  FeatureGenerator (repr_to_speech): a `proj` Dense from continuous features
  (768-d mHuBERT by default) to embedding_dim in place of the unit table,
  in front of the same generator
This is the direct-conv math. The JAX package's default for the stages of
<= 64 channels, ops/packed_conv.py, is a TPU layout of the same convolutions
(space-to-depth packing for the 128-lane MXU) and is not ported; the
convolutions here go to cuDNN (F.conv1d / conv_transpose1d) on the card, as
JAX leaves them to XLA outside any Pallas kernel. Layout [B, T, C] at the
module edges, [B, C, T] inside.

The int8 vocoder (JAX's DIFFNORM_INT8_VOCODER, opt-in; `int8_vocoder` on
the generators, "dynamic" or "static"): every ResBlock conv of a stage of
<= 64 channels (128 % C == 0, the stages JAX packs) runs W8A8 with the
function of JAX's packed int8 conv in the direct layout: one per-tensor
weight scale amax|w| / 127 (in the weights' type), one per-tensor
activation scale per conv input (amax|x| / 127, or a calibrated amax),
the int32 sum over the k dilated taps in one `torch._int_mm` (the taps
side by side, k * C deep), then acc * (a_scale * k_scale) and the bias. JAX pads T to a multiple of its packing factor and
zeroes the tail after every conv, so its sums and scales are the direct
layout's. "static" quantizes by the amaxes `calibrating` recorded (JAX's
`quant_stats/packed_{i}_{j}`: max|lrelu(.)| before each conv of a block, two
per dilation), a block without them dynamically.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffnorm_tpu_torch.models.conformer import layer_norm
from diffnorm_tpu_torch.models.layers import Dense
from diffnorm_tpu_torch.ops import quant as quant_ops

LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _conv(c_in: int, c_out: int, k: int, dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(c_in, c_out, k, dilation=dilation, padding=(k * dilation - dilation) // 2)


INT8_MODES = ("off", "dynamic", "static")


def int8_same_conv(x: torch.Tensor, conv: nn.Conv1d,
                   act_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W8A8 SAME dilated conv of JAX's packed_same_conv (int8 branch,
    ops/packed_conv.py:145-237) in the direct layout: x [B, C, T] ->
    [B, C_out, T] in x's type."""
    w, d = conv.weight, conv.dilation[0]
    k = w.shape[-1]
    k_scale = torch.clamp(quant_ops._div(w.abs().amax(), 127.0), min=1e-12)
    wq = torch.round(quant_ops._div(w.float(), k_scale.float())).to(torch.int8)
    xt = x.transpose(1, 2)
    if act_amax is not None:
        xq, a_scale = quant_ops.quantize_act_static(xt, act_amax)
    else:
        xq, a_scale = quant_ops.quantize_act(xt, per_tensor=True)
    b, t, c = xq.shape
    pad = (k - 1) // 2 * d
    xp = F.pad(xq, (0, 0, pad, pad))
    cols = torch.cat([xp[:, j * d:j * d + t] for j in range(k)], dim=-1)  # [B, T, k*C]
    acc = quant_ops.int_mm(cols.reshape(b * t, k * c), wq.permute(0, 2, 1).reshape(w.shape[0], -1))
    scale = a_scale.reshape(()).float() * k_scale.float()
    y = (acc.float() * scale).to(x.dtype) + conv.bias.to(x.dtype)
    return y.reshape(b, t, -1).transpose(1, 2)


class ResBlock(nn.Module):
    """`int8` ("off", "dynamic", "static") runs the convs W8A8
    (`int8_same_conv`); `act_amax` [2 * len(dilations)] holds the
    calibrated input amaxes (conv1_j at 2j, conv2_j at 2j + 1), recorded
    while `calibrating`."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for j, d in enumerate(dilations):
            self.add_module(f"conv1_{j}", _conv(channels, channels, kernel_size, d))
            self.add_module(f"conv2_{j}", _conv(channels, channels, kernel_size))
        self.int8, self.calibrating = "off", False
        self.register_buffer("act_amax", None, persistent=False)

    def _apply(self, fn, recurse=True):
        amax = self._buffers.get("act_amax")
        out = super()._apply(fn, recurse)
        if amax is not None:  # calibrated amaxes stay float32
            self._buffers["act_amax"] = amax.to(self._buffers["act_amax"].device)
        return out

    def _conv(self, name: str, h: torch.Tensor, site: int, observed: List) -> torch.Tensor:
        conv = getattr(self, name)
        if self.int8 == "off":
            return conv(h)
        static = self.int8 == "static" and self.act_amax is not None
        if self.calibrating and not static:
            observed.append(h.abs().amax().float())
        return int8_same_conv(h, conv, self.act_amax[site] if static else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T]."""
        observed: List[torch.Tensor] = []
        for j in range(self.n):
            h = self._conv(f"conv1_{j}", leaky_relu(x), 2 * j, observed)
            x = x + self._conv(f"conv2_{j}", leaky_relu(h), 2 * j + 1, observed)
        if observed:  # a running max over the calibration calls
            seen = torch.stack(observed)
            self.act_amax = seen if self.act_amax is None else torch.maximum(self.act_amax, seen)
        return x


class HifiGanGenerator(nn.Module):
    """x [B, T, in_dim] -> waveform [B, T * prod(upsample_rates)]."""

    def __init__(self, in_dim: int = 128, upsample_rates: Sequence[int] = (5, 4, 4, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (11, 8, 8, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3):
        super().__init__()
        self.n_up, self.n_res = len(upsample_rates), len(resblock_kernel_sizes)
        self.conv_pre = _conv(in_dim, upsample_initial_channel, 7)
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch_out = upsample_initial_channel // (2 ** (i + 1))
            # torch's padding (k - u) // 2 trims what JAX crops after its
            # VALID transposed conv
            self.add_module(f"up_{i}", nn.ConvTranspose1d(ch, ch_out, k, stride=u,
                                                          padding=(k - u) // 2))
            ch = ch_out
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes, resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", ResBlock(ch, rk, tuple(rd)))
        self.conv_post = _conv(ch, 1, 7)

    def int8_blocks(self) -> Dict[str, ResBlock]:
        """JAX's packed_{i}_{j} name of every ResBlock the int8 vocoder runs
        (the stages of <= 64 channels that divide 128)."""
        out = {}
        for i in range(self.n_up):
            for j in range(self.n_res):
                block = getattr(self, f"resblock_{i}_{j}")
                ch = block.conv1_0.weight.shape[0]
                if ch <= 64 and 128 % ch == 0:
                    out[f"packed_{i}_{j}"] = block
        return out

    def set_int8(self, mode: str) -> None:
        if mode not in INT8_MODES:
            raise ValueError(f"int8 vocoder mode must be one of {INT8_MODES}, got {mode!r}")
        for block in self.int8_blocks().values():
            block.int8 = mode

    def int8_stats(self) -> Dict[str, np.ndarray]:
        """The calibrated amaxes as JAX's quant_stats: {packed_i_j: [2n]}."""
        return {name: b.act_amax.float().cpu().numpy()
                for name, b in self.int8_blocks().items() if b.act_amax is not None}

    def load_int8_stats(self, stats: Dict[str, np.ndarray]) -> None:
        blocks = self.int8_blocks()
        for name, amax in stats.items():
            block = blocks[name]
            block.act_amax = torch.as_tensor(np.asarray(amax, np.float32),
                                             device=block.conv1_0.weight.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(x.to(self.conv_pre.weight.dtype).transpose(1, 2))
        for i in range(self.n_up):
            x = getattr(self, f"up_{i}")(leaky_relu(x))
            acc = None
            for j in range(self.n_res):
                r = getattr(self, f"resblock_{i}_{j}")(x)
                acc = r if acc is None else acc + r
            x = acc / self.n_res
        # the reference uses F.leaky_relu's default slope (0.01) here
        # (hifigan.py:166), unlike the 0.1 everywhere else
        x = self.conv_post(leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]


class VariancePredictor(nn.Module):
    """Duration predictor (fastspeech2.py:117-151): [B, T, C] -> [B, T]."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, kernel_size: int = 3):
        super().__init__()
        self.conv1 = _conv(in_dim, hidden_dim, kernel_size)
        self.ln1 = layer_norm(hidden_dim)
        self.conv2 = nn.Conv1d(hidden_dim, hidden_dim, kernel_size, padding=1)
        self.ln2 = layer_norm(hidden_dim)
        self.proj = Dense(hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x.to(self.conv1.weight.dtype).transpose(1, 2))
        h = self.ln1(F.relu(h).transpose(1, 2))
        h = self.conv2(h.transpose(1, 2))
        h = self.ln2(F.relu(h).transpose(1, 2))
        return self.proj(h)[..., 0]


class CodeGenerator(nn.Module):
    """Unit codes [B, T] (already duration-expanded) -> waveform."""

    def __init__(self, num_embeddings: int = 1000, embedding_dim: int = 128,
                 upsample_rates: Sequence[int] = (5, 4, 4, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (11, 8, 8, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 dur_predictor: bool = False, var_pred_hidden_dim: int = 256,
                 var_pred_kernel_size: int = 3, num_speakers: int = 0,
                 int8_vocoder: str = "off"):
        super().__init__()
        self.dict = nn.Embedding(num_embeddings, embedding_dim)
        self.generator = HifiGanGenerator(
            embedding_dim * (2 if num_speakers else 1), upsample_rates, upsample_kernel_sizes,
            upsample_initial_channel, resblock_kernel_sizes, resblock_dilation_sizes)
        self.generator.set_int8(int8_vocoder)
        self.spkr = nn.Embedding(num_speakers, embedding_dim) if num_speakers else None
        self.upsample = int(np.prod(upsample_rates))
        self.dur_predictor = (VariancePredictor(embedding_dim, var_pred_hidden_dim,
                                                var_pred_kernel_size)
                              if dur_predictor else None)

    def log_durations(self, code: torch.Tensor) -> torch.Tensor:
        return self.dur_predictor(self.dict(code))

    def predict_durations(self, code: torch.Tensor) -> torch.Tensor:
        """code [B, T] -> int32 durations >= 1 (codehifigan.py:55-60);
        round half to even, as jnp.round."""
        log_dur = self.log_durations(code).float()
        return torch.clamp(torch.round(torch.exp(log_dur) - 1.0).to(torch.int32), min=1)

    def forward(self, code: torch.Tensor, spkr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """code [B, T] (duration-expanded); spkr [B] speaker ids, which a
        multi-speaker generator needs."""
        x = self.dict(code)
        if self.spkr is not None:
            if spkr is None:
                raise ValueError("the multi-speaker vocoder needs speaker ids (spkr)")
            x = torch.cat([x, self.spkr(spkr)[:, None, :].expand_as(x)], dim=-1)
        return self.generator(x)


@contextlib.contextmanager
def calibrating(generator: HifiGanGenerator) -> Iterator[None]:
    """JAX's calibrate_apply over the enclosed forwards: every int8 block
    without static amaxes records the running max of its conv inputs."""
    blocks = list(generator.int8_blocks().values())
    for block in blocks:
        block.calibrating = True
    try:
        yield
    finally:
        for block in blocks:
            block.calibrating = False


CALIBRATION_CODES = (4, 64)  # bench.py:964-966's codes: rng 2, [4, 64]


@torch.no_grad()
def calibrate_int8_vocoder(module: "CodeGenerator") -> None:
    """Record the static amaxes on JAX's calibration batch, seeded codes
    [4, 64] from np.random.default_rng(2) (bench.py:959-967; speaker 0
    for a multi-speaker vocoder)."""
    codes = np.random.default_rng(2).integers(0, module.dict.num_embeddings,
                                              size=CALIBRATION_CODES)
    device = module.dict.weight.device
    spkr = (torch.zeros(CALIBRATION_CODES[0], dtype=torch.long, device=device)
            if module.spkr is not None else None)
    with calibrating(module.generator):
        module(torch.as_tensor(codes, device=device), spkr)


class FeatureGenerator(nn.Module):
    """Continuous features [B, T, feature_dim] -> waveform [B, T *
    prod(upsample_rates)] (JAX models/hifigan.py:304-333, reference
    repr_hifigan_task.py): `proj` to embedding_dim, then the HiFi-GAN
    generator unchanged. The trainer's and the checkpoints' tree is JAX's
    (`proj`, `generator`)."""

    def __init__(self, feature_dim: int = 768, embedding_dim: int = 128,
                 upsample_rates: Sequence[int] = (5, 4, 4, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (11, 8, 8, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3):
        super().__init__()
        self.proj = Dense(feature_dim, embedding_dim)
        self.generator = HifiGanGenerator(embedding_dim, upsample_rates, upsample_kernel_sizes,
                                          upsample_initial_channel, resblock_kernel_sizes,
                                          resblock_dilation_sizes)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.generator(self.proj(features))


class CodeHiFiGANVocoder:
    """Runtime wrapper (vocoder.py:214-243): the generator of a config."""

    def __init__(self, module: CodeGenerator):
        self.module = module

    @classmethod
    def from_config(cls, cfg: Dict, variables=None, device="cuda",
                    dtype: torch.dtype = torch.float32,
                    int8_vocoder: str = "off") -> "CodeHiFiGANVocoder":
        """The vocoder of a config dict; `variables` (a JAX variables tree)
        loads its weights, else the init is torch's, from the global seed.
        Runs on the card unless `device="cpu"` is asked for; raises without
        CUDA otherwise. `int8_vocoder` "static" calibrates on JAX's batch
        (`calibrate_int8_vocoder`) after the cast to `dtype`."""
        from diffnorm_tpu_torch.device import resolve_device
        from diffnorm_tpu_torch.weights import from_jax_variables

        device = resolve_device(device)

        dur = cfg.get("dur_predictor_params") or {}
        with torch.device(device):
            module = CodeGenerator(
                num_embeddings=cfg["num_embeddings"], embedding_dim=cfg["embedding_dim"],
                upsample_rates=tuple(cfg["upsample_rates"]),
                upsample_kernel_sizes=tuple(cfg["upsample_kernel_sizes"]),
                upsample_initial_channel=cfg["upsample_initial_channel"],
                resblock_kernel_sizes=tuple(cfg["resblock_kernel_sizes"]),
                resblock_dilation_sizes=tuple(tuple(d) for d in cfg["resblock_dilation_sizes"]),
                dur_predictor=bool(dur), var_pred_hidden_dim=dur.get("var_pred_hidden_dim", 256),
                num_speakers=cfg.get("num_speakers", 0) if cfg.get("multispkr") else 0,
                int8_vocoder=int8_vocoder)
        if variables is not None:
            from_jax_variables(module, variables)
        module = module.to(dtype).eval()
        if int8_vocoder == "static":
            calibrate_int8_vocoder(module)
        return cls(module)

    @torch.no_grad()
    def __call__(self, units, dur_prediction: bool = False, reduce: bool = False) -> np.ndarray:
        """units [T] int (host) -> waveform [T_wav] float32 (host). Invalid
        (< 0) codes are dropped, as the reference wrapper does; `reduce`
        collapses repeats first, `dur_prediction` repeats each unit by its
        predicted duration."""
        from diffnorm_tpu_torch.ops.unit_reduce import reduce_units

        units = np.asarray(units)
        units = units[units >= 0]
        if reduce:
            units, _, _ = reduce_units(units)
        device = self.module.dict.weight.device
        code = torch.as_tensor(np.asarray(units, np.int64), device=device)[None, :]
        if dur_prediction:
            if self.module.dur_predictor is None:
                raise ValueError("the vocoder has no duration predictor")
            code = torch.repeat_interleave(code[0], self.module.predict_durations(code)[0])[None]
        return self.module(code)[0].float().cpu().numpy()
