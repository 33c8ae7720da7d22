"""WaveNet stacks of the speech VAE and the diffusion denoiser.

Counterpart of diffnorm_tpu/models/wavenet.py. There are `layers` parallel
chains, chain j at dilation 2**j in every stack; only the last stack has skip
convs, and the chains meet only where their skips are summed before
`final_conv`. Each block: h = conv(x) + b_conv; h = h * gamma + beta (FiLM
from `to_time_cond`, when conditioned); x = tanh(h) * sigmoid(h) + res_conv(x).

`Wavenet` runs every chain through `ops.wavenet_chain` (the CUDA kernel on a
CUDA tensor, its plain version on the CPU) with weights packed per chain
([out, in] per tap, torch's Linear layout). For inference the packs are
buffers built by `pack_weights` when weights load, not per step, and rebuilt
when a block parameter has changed in place since (an optimizer step,
`load_state_dict`). A training forward (grad mode on, a block parameter
requiring grad) packs from the parameters as it runs, so gradients reach
`conv`, `res_conv` and `skip_conv` through the chain's autograd (the plain
version's backward). The conv bias enters the chain folded into the FiLM
shift as beta' = beta + gamma * b_conv; an unconditioned WaveNet uses
gamma = 1, beta' = b_conv.

`chain_kernel=False` (JAX without DIFFNORM_PALLAS_WAVENET=1, wavenet.py:150)
runs the blocks as modules instead, in JAX's order (wavenet.py:55-68): the
conv with its bias, FiLM, gating, plus the residual conv; with `quant` the
blocks' `res_conv`, `conv` and `skip_conv` are int8 `CausalConv1d` sites
(JAX's int8 module route, the DDIM serving headline).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from diffnorm_tpu_torch.models.layers import (
    CausalConv1d,
    Dense,
    packs_from_params,
    param_versions,
    repack_after_load,
)
from diffnorm_tpu_torch.ops import wavenet_chain as chain_ops
from diffnorm_tpu_torch.ops.quant import Int8Knobs

Film = List[Tuple[torch.Tensor, torch.Tensor]]
Pack = Dict[str, torch.Tensor]


class WavenetResBlock(nn.Module):
    """The parameters of one block (flax names)."""

    def __init__(self, dim: int, dilation: int, kernel_size: int = 3,
                 skip_conv: bool = False, cond_dim: Optional[int] = None,
                 quant: bool = False, knobs: Int8Knobs = Int8Knobs()):
        super().__init__()
        self.res_conv = CausalConv1d(dim, dim, 1, quant=quant, knobs=knobs)
        self.conv = CausalConv1d(dim, dim, kernel_size, dilation, quant=quant, knobs=knobs)
        self.to_time_cond = Dense(cond_dim, 2 * dim) if cond_dim else None
        self.skip_conv = (CausalConv1d(dim, dim, 1, quant=quant, knobs=knobs)
                          if skip_conv else None)

    def film(self, t: torch.Tensor) -> torch.Tensor:
        return self.to_time_cond(t)

    def forward(self, x: torch.Tensor, tc: Optional[torch.Tensor]) -> torch.Tensor:
        """The module block (wavenet.py:55-68); tc [B, 2C] its FiLM
        projection, or None unconditioned. Returns the skip where the block
        has one, else its output."""
        res = self.res_conv(x)
        h = self.conv(x)
        if tc is not None:
            gamma, beta = tc[:, None, :].chunk(2, dim=-1)
            h = h * gamma + beta
        h = torch.tanh(h) * torch.sigmoid(h) + res
        return h if self.skip_conv is None else self.skip_conv(h)


class WavenetStack(nn.Module):
    def __init__(self, dim: int, layers: int, kernel_size: int = 3,
                 has_skip: bool = False, cond_dim: Optional[int] = None,
                 quant: bool = False, knobs: Int8Knobs = Int8Knobs()):
        super().__init__()
        for j in range(layers):
            self.add_module(f"block_{j}", WavenetResBlock(
                dim, 2 ** j, kernel_size, skip_conv=has_skip, cond_dim=cond_dim,
                quant=quant, knobs=knobs))

    def block(self, j: int) -> WavenetResBlock:
        return getattr(self, f"block_{j}")


def _pack_chain(blocks: List[WavenetResBlock]) -> Pack:
    """One chain's stacked weights as the kernel takes them, from the block
    parameters by differentiable ops."""
    packed = {
        # torch conv weight [out, in, k] -> [k, out, in] per stack
        "w_conv": torch.stack([b.conv.weight.permute(2, 0, 1) for b in blocks]),
        "w_res": torch.stack([b.res_conv.weight[:, :, 0] for b in blocks]),
        "w_skip": blocks[-1].skip_conv.weight[:, :, 0],
        "b_res": torch.stack([b.res_conv.bias for b in blocks]),
        "b_skip": blocks[-1].skip_conv.bias,
        "b_conv": torch.stack([b.conv.bias for b in blocks]),
    }
    return {name: tensor.contiguous() for name, tensor in packed.items()}


class _PackedChain(nn.Module):
    """One chain's packed weights as buffers (`.to()` moves and casts them
    with the parameters; not saved)."""

    def __init__(self, pack: Pack):
        super().__init__()
        for name, tensor in pack.items():
            self.register_buffer(name, tensor.detach(), persistent=False)

    def tensors(self) -> Pack:
        return dict(self._buffers)


class Wavenet(nn.Module):
    """init causal conv -> stacks (the last with skips) -> sum of the chain
    skips -> 1x1 causal `final_conv`. `in_dim` may differ from `dim` (the
    VAE's encoder and decoder). `chain_kernel` picks the `wavenet_chain`
    route (JAX's DIFFNORM_PALLAS_WAVENET=1) over the module blocks; `quant`
    makes the blocks' convs int8 on the module route."""

    def __init__(self, in_dim: int, dim: int, stacks: int, layers: int,
                 init_conv_kernel: int = 3, cond_dim: Optional[int] = None,
                 quant: bool = False, knobs: Int8Knobs = Int8Knobs(),
                 chain_kernel: bool = True):
        super().__init__()
        self.stacks, self.layers = stacks, layers
        self.conditioned = cond_dim is not None
        self.chain_kernel = chain_kernel
        self.init_conv = CausalConv1d(in_dim, dim, init_conv_kernel)
        for s in range(stacks):
            self.add_module(f"stack_{s}", WavenetStack(
                dim, layers, has_skip=(s == stacks - 1), cond_dim=cond_dim,
                quant=quant, knobs=knobs))
        self.final_conv = CausalConv1d(dim, dim, 1)
        self.pack_weights()
        self.register_load_state_dict_post_hook(repack_after_load)

    def stack(self, s: int) -> WavenetStack:
        return getattr(self, f"stack_{s}")

    def chain_blocks(self, j: int) -> List[WavenetResBlock]:
        return [self.stack(s).block(j) for s in range(self.stacks)]

    def _block_params(self) -> List[nn.Parameter]:
        """Every parameter the chain packs copy."""
        return [p for j in range(self.layers) for b in self.chain_blocks(j)
                for m in (b.conv, b.res_conv, b.skip_conv) if m is not None
                for p in m.parameters()]

    @torch.no_grad()
    def pack_weights(self) -> None:
        """Rebuild the per-chain packed weights from the block parameters.
        Called when weights load (weights.from_jax_params does), and by a
        forward that finds a block parameter changed since."""
        self.chains = nn.ModuleList(
            _PackedChain(_pack_chain(self.chain_blocks(j))) for j in range(self.layers))
        self._pack_params = tuple(self._block_params())
        self._packed_versions = param_versions(self._pack_params)

    def packs(self) -> List[Pack]:
        """Per chain, its packed weights: built from the parameters when a
        forward trains (`packs_from_params`), else the cached packs, rebuilt
        first if a block parameter changed in place since they were built.
        (A parameter replaced by assignment needs `pack_weights()`.)"""
        if packs_from_params(self._pack_params):
            return [_pack_chain(self.chain_blocks(j)) for j in range(self.layers)]
        if param_versions(self._pack_params) != self._packed_versions:
            self.pack_weights()
        return [chain.tensors() for chain in self.chains]

    def precompute_film(self, t: torch.Tensor,
                        packs: Optional[List[Pack]] = None) -> Film:
        """Per chain (gamma, beta'), each [N, S, C] float32, for condition t
        [N, cond_dim]: every to_time_cond projection, with the conv bias
        folded into the shift (beta' = beta + gamma * b_conv). On the module
        route, per chain the projections themselves, [N, S, 2C]."""
        if not self.chain_kernel:
            return [torch.stack([b.film(t) for b in self.chain_blocks(j)], dim=1)
                    for j in range(self.layers)]
        film = []
        for j, pack in enumerate(packs or self.packs()):
            tc = torch.stack([b.film(t) for b in self.chain_blocks(j)], dim=1)
            gamma, beta = tc.float().chunk(2, dim=-1)
            beta = beta + gamma * pack["b_conv"].float()
            film.append((gamma.contiguous(), beta.contiguous()))
        return film

    def _unconditioned_film(self, batch: int, packs: List[Pack]) -> Film:
        film = []
        for pack in packs:
            beta = pack["b_conv"].float().expand(batch, -1, -1).contiguous()
            film.append((torch.ones_like(beta), beta))
        return film

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                film: Optional[Film] = None) -> torch.Tensor:
        """x [B, T, in_dim]; t [B, cond_dim] or a precomputed `film`."""
        x = self.init_conv(x)
        if not self.chain_kernel:
            return self._forward_modules(x, t, film)
        packs = self.packs()
        if film is None:
            film = (self.precompute_film(t, packs) if self.conditioned
                    else self._unconditioned_film(x.shape[0], packs))
        skips = [
            chain_ops.wavenet_chain(
                x, p["w_conv"], p["w_res"], p["w_skip"], p["b_res"], p["b_skip"],
                gamma, beta, dilation=2 ** j)
            for j, (p, (gamma, beta)) in enumerate(zip(packs, film))
        ]
        return self.final_conv(sum(skips))

    def _forward_modules(self, x: torch.Tensor, t: Optional[torch.Tensor],
                         film: Optional[Film]) -> torch.Tensor:
        if self.conditioned and film is None:
            film = self.precompute_film(t)
        hs = [x] * self.layers
        for s in range(self.stacks):
            hs = [self.stack(s).block(j)(h, film[j][:, s] if self.conditioned else None)
                  for j, h in enumerate(hs)]
        return self.final_conv(sum(hs))
