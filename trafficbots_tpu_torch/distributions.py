"""Distributions as small immutable dataclasses over tensors.

Counterpart of `trafficbots_tpu/distributions.py` for what the eval rollout
and the training step use: `DiagGaussian` (the latent posterior/prior with
`diag_gaus`, and the per-step action distribution), `kl_diag_gaussian`,
`DummyLatent` (SimNet ablations) and `DestCategorical` (the destination
head). Sampling takes an explicit `torch.Generator`, drawn on the
generator's device and moved to the distribution's; `deterministic` may be
a bool or a per-row mask, as in the JAX package. The generator's numbers
differ from jax.random's, so stochastic paths are compared by distribution
or with injected noise, never sample by sample.
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
        device = self.mean.device if generator is None else generator.device
        eps = torch.randn(self.mean.shape, dtype=self.mean.dtype, device=device, generator=generator)
        eps = eps.to(self.mean.device)
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


def kl_diag_gaussian(p: DiagGaussian, q: DiagGaussian) -> Tensor:
    """KL(p || q) summed over the event dim."""
    p_std, q_std = p.stddev, q.stddev
    var_ratio = (p_std / q_std) ** 2
    t1 = ((p.mean - q.mean) / q_std) ** 2
    return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), dim=-1)


@dataclasses.dataclass(frozen=True)
class DestCategorical:
    """Categorical over map polyline indices; `logits` are normalized
    log-probabilities [..., n_pl]."""

    logits: Tensor
    valid: Optional[Tensor] = None

    @classmethod
    def from_logits(cls, logits: Tensor, valid: Optional[Tensor] = None) -> "DestCategorical":
        return cls(logits=torch.log_softmax(logits, dim=-1), valid=valid)

    def log_prob(self, idx: Tensor) -> Tensor:
        return torch.gather(self.logits, -1, idx[..., None])[..., 0]


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
