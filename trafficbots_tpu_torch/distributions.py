"""Distributions as small immutable dataclasses over tensors.

Counterpart of `trafficbots_tpu/distributions.py` for what the eval rollout,
the training step and validation use: `DiagGaussian` (the latent
posterior/prior with `diag_gaus`, and the per-step action distribution),
`kl_diag_gaussian`, `DummyLatent` (SimNet ablations) and `DestCategorical`
(the destination head; `repeat` folds the K joint futures into the batch).
Sampling takes an explicit `torch.Generator`, drawn on the
generator's device and moved to the distribution's; `deterministic` may be
a bool or a per-row mask, as in the JAX package. All noise comes from
`standard_normal` and `standard_gumbel` (a categorical draw is the argmax of
the logits plus Gumbel noise, as `jax.random.categorical` draws it). The
generator's numbers differ from jax.random's, so stochastic paths are
compared by distribution or with the JAX draws injected through those two
functions, never sample by sample.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

Tensor = torch.Tensor
DetType = Union[bool, Tensor]

_LOG_2PI = math.log(2.0 * math.pi)


def _draw(fn, shape, dtype, device, generator: Optional[torch.Generator]) -> Tensor:
    """Noise drawn on the generator's device, moved to `device`."""
    gen_device = device if generator is None else generator.device
    return fn(shape, dtype=dtype, device=gen_device, generator=generator).to(device)


def standard_normal(shape, dtype, device, generator: Optional[torch.Generator] = None) -> Tensor:
    return _draw(torch.randn, shape, dtype, device, generator)


def standard_gumbel(shape, dtype, device, generator: Optional[torch.Generator] = None) -> Tensor:
    u = _draw(torch.rand, shape, dtype, device, generator).clamp(min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


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
        eps = standard_normal(self.mean.shape, self.mean.dtype, self.mean.device, generator)
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

    @classmethod
    def from_probs(cls, probs: Tensor, valid: Optional[Tensor] = None) -> "DestCategorical":
        tiny = torch.finfo(probs.dtype).tiny
        return cls(logits=torch.log(torch.clamp(probs, min=tiny)), valid=valid)

    @property
    def probs(self) -> Tensor:
        return torch.exp(self.logits)

    def sample(self, generator: Optional[torch.Generator] = None, deterministic: DetType = True) -> Tensor:
        """The argmax where `deterministic` is set (a bool or a per-row mask),
        a categorical draw from `generator` elsewhere."""
        det = torch.argmax(self.logits, dim=-1)
        if deterministic is True:
            return det
        g = standard_gumbel(self.logits.shape, self.logits.dtype, self.logits.device, generator)
        return _mix_det(det, torch.argmax(self.logits + g, dim=-1), deterministic)

    def log_prob(self, idx: Tensor) -> Tensor:
        return torch.gather(self.logits, -1, idx[..., None])[..., 0]

    def repeat(self, n: int, axis: int = 0) -> "DestCategorical":
        return DestCategorical(
            logits=torch.repeat_interleave(self.logits, n, dim=axis),
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
