"""Distributions as small immutable dataclasses over tensors.

Counterpart of `trafficbots_tpu/distributions.py` for what the eval rollout
uses: `DiagGaussian` (the latent posterior/prior with `diag_gaus`, and the
per-step action distribution) and `DummyLatent` (SimNet ablations). Sampling
takes an explicit `torch.Generator`; `deterministic` may be a bool or a
per-row mask, as in the JAX package (the K=0 joint future is deterministic,
the others stochastic). The generator's numbers differ from jax.random's, so
stochastic paths are compared by distribution, never sample by sample.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

Tensor = torch.Tensor
DetType = Union[bool, Tensor]

_LOG_2PI = math.log(2.0 * math.pi)


def _mix_det(det: Tensor, rnd: Tensor, deterministic: DetType) -> Tensor:
    if isinstance(deterministic, bool):
        return det if deterministic else rnd
    mask = deterministic
    while mask.ndim < det.ndim:
        mask = mask[..., None]
    return torch.where(mask, det, rnd)


@dataclasses.dataclass(frozen=True)
class DiagGaussian:
    """Independent Normal over the last dim."""

    mean: Tensor  # [..., d]
    log_std: Tensor  # broadcastable to mean
    valid: Optional[Tensor] = None  # [...]

    @property
    def stddev(self) -> Tensor:
        return torch.exp(self.log_std).expand(self.mean.shape)

    def sample(self, generator: Optional[torch.Generator] = None, deterministic: DetType = True) -> Tensor:
        if deterministic is True:
            return self.mean
        eps = torch.randn(
            self.mean.shape, dtype=self.mean.dtype, device=self.mean.device, generator=generator
        )
        return _mix_det(self.mean, self.mean + self.stddev * eps, deterministic)

    def log_prob(self, x: Tensor) -> Tensor:
        std = self.stddev
        z = (x - self.mean) / std
        lp = -0.5 * (z * z) - torch.log(std) - 0.5 * _LOG_2PI
        return torch.sum(lp, dim=-1)

    def repeat(self, n: int, axis: int = 0) -> "DiagGaussian":
        log_std = self.log_std.expand(self.mean.shape)
        return DiagGaussian(
            mean=torch.repeat_interleave(self.mean, n, dim=axis),
            log_std=torch.repeat_interleave(log_std, n, dim=axis),
            valid=None if self.valid is None else torch.repeat_interleave(self.valid, n, dim=axis),
        )


@dataclasses.dataclass(frozen=True)
class DummyLatent:
    """Zero latent for the SimNet ablation."""

    zeros: Tensor  # [..., d]
    valid: Optional[Tensor] = None

    def sample(self, generator: Optional[torch.Generator] = None, deterministic: DetType = True) -> Tensor:
        return torch.zeros_like(self.zeros)

    def log_prob(self, x: Tensor) -> Tensor:
        return torch.zeros_like(self.zeros[..., 0])

    def repeat(self, n: int, axis: int = 0) -> "DummyLatent":
        return DummyLatent(
            zeros=torch.repeat_interleave(self.zeros, n, dim=axis),
            valid=None if self.valid is None else torch.repeat_interleave(self.valid, n, dim=axis),
        )
