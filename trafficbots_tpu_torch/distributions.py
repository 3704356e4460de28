"""Distributions as small immutable dataclasses over tensors.

Counterpart of `trafficbots_tpu/distributions.py` for what the eval rollout,
the training step and validation use: `DiagGaussian` (the latent
posterior/prior with `diag_gaus`, and the per-step action distribution),
`kl_diag_gaussian`, `Gaussian` (the full-covariance Normal, Cholesky
parametrized: in the JAX package's inventory, used by no configuration),
`DummyLatent` (SimNet ablations), `MultiCategorical`
and `kl_multi_categorical` (the categorical latent, `dist_type="cat"`) and
`DestCategorical` (the destination head; `repeat` folds the K joint futures
into the batch).
Sampling takes an explicit `torch.Generator`, drawn on the
generator's device and moved to the distribution's; `deterministic` may be
a bool or a per-row mask, as in the JAX package. All noise comes from
`standard_normal`, `standard_gumbel` (a categorical draw is the argmax of
the logits plus Gumbel noise, as `jax.random.categorical` draws it) and
`standard_uniform` (the training-input augmentations of
`data.preprocessing`: a Bernoulli draw is `uniform < p`, and a uniform on
[lo, hi) is max(lo, u * (hi - lo) + lo), both as jax.random draws them).
The generator's numbers differ from jax.random's, so stochastic paths are
compared by distribution or with the JAX draws injected through those three
functions, never sample by sample.

Under data parallelism a validation or test step runs inside
`global_batch_draws(rank, world)`: each rank draws the global batch's noise
from the replicated generator and keeps its own rows, so rank r samples
what one process would sample for rank r's scenes (JAX draws the global
batch's noise from one key under GSPMD).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

Tensor = torch.Tensor
DetType = Union[bool, Tensor]

_LOG_2PI = math.log(2.0 * math.pi)

_RANK_ROWS: Optional[Tuple[int, int]] = None  # (rank, world) inside global_batch_draws


@contextlib.contextmanager
def global_batch_draws(rank: int, world: int):
    """Inside the block a draw of shape [n, ...] draws [n * world, ...] and
    keeps rows [rank * n, (rank + 1) * n): the rank's scenes' rows of the
    global batch (batch-major rows, and the joint futures fold K
    scene-major, so a rank's rows are contiguous). With one rank, nothing
    changes."""
    global _RANK_ROWS
    saved, _RANK_ROWS = _RANK_ROWS, ((rank, world) if world > 1 else None)
    try:
        yield
    finally:
        _RANK_ROWS = saved


def _draw(fn, shape, dtype, device, generator: Optional[torch.Generator]) -> Tensor:
    """Noise drawn on the generator's device, moved to `device`."""
    gen_device = device if generator is None else generator.device
    if _RANK_ROWS is None:
        return fn(shape, dtype=dtype, device=gen_device, generator=generator).to(device)
    rank, world = _RANK_ROWS
    shape = tuple(shape)
    if not shape:
        raise ValueError("a draw under global_batch_draws needs a leading batch axis")
    n = shape[0]
    rows = fn((n * world, *shape[1:]), dtype=dtype, device=gen_device, generator=generator)
    return rows[rank * n:(rank + 1) * n].to(device)


def standard_normal(shape, dtype, device, generator: Optional[torch.Generator] = None) -> Tensor:
    return _draw(torch.randn, shape, dtype, device, generator)


def standard_uniform(shape, dtype, device, generator: Optional[torch.Generator] = None) -> Tensor:
    """Uniform on [0, 1)."""
    return _draw(torch.rand, shape, dtype, device, generator)


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


@dataclasses.dataclass(frozen=True)
class Gaussian:
    """Full-covariance Normal over the last dim, parametrized by the
    lower-triangular Cholesky factor `tril` of its covariance."""

    mean: Tensor  # [..., d]
    tril: Tensor  # [..., d, d]
    valid: Optional[Tensor] = None

    def sample(self, generator: Optional[torch.Generator] = None, deterministic: DetType = True) -> Tensor:
        if deterministic is True:
            return self.mean
        eps = standard_normal(self.mean.shape, self.mean.dtype, self.mean.device, generator)
        rnd = self.mean + torch.einsum("...ij,...j->...i", self.tril, eps)
        return _mix_det(self.mean, rnd, deterministic)

    def log_prob(self, x: Tensor) -> Tensor:
        d = self.mean.shape[-1]
        diff = x - self.mean
        z = torch.linalg.solve_triangular(self.tril, diff[..., None], upper=False)[..., 0]
        log_det = torch.log(torch.abs(torch.diagonal(self.tril, dim1=-2, dim2=-1))).sum(dim=-1)
        return -0.5 * torch.sum(z * z, dim=-1) - log_det - 0.5 * d * _LOG_2PI

    def repeat(self, n: int, axis: int = 0) -> "Gaussian":
        return Gaussian(
            mean=torch.repeat_interleave(self.mean, n, dim=axis),
            tril=torch.repeat_interleave(self.tril, n, dim=axis),
            valid=None if self.valid is None else torch.repeat_interleave(self.valid, n, dim=axis),
        )


def kl_diag_gaussian(p: DiagGaussian, q: DiagGaussian) -> Tensor:
    """KL(p || q) summed over the event dim."""
    p_std, q_std = p.stddev, q.stddev
    var_ratio = (p_std / q_std) ** 2
    t1 = ((p.mean - q.mean) / q_std) ** 2
    return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), dim=-1)


def _log_clamped(probs: Tensor) -> Tensor:
    return torch.log(torch.clamp(probs, min=torch.finfo(probs.dtype).tiny))


@dataclasses.dataclass(frozen=True)
class MultiCategorical:
    """n_cat independent categoricals over n_class classes. A sample is the
    one-hots flattened to [..., n_cat * n_class]; a random one is
    straight-through (probs + (one_hot - probs).detach()), the deterministic
    one the argmax's plain one-hot, as in the JAX package."""

    probs: Tensor  # [..., n_cat, n_class]
    valid: Optional[Tensor] = None

    @property
    def n_cat(self) -> int:
        return self.probs.shape[-2]

    @property
    def n_class(self) -> int:
        return self.probs.shape[-1]

    def _one_hot(self, idx: Tensor) -> Tensor:
        return torch.nn.functional.one_hot(idx, self.n_class).to(self.probs.dtype)

    def sample(self, generator: Optional[torch.Generator] = None, deterministic: DetType = True) -> Tensor:
        det = self._one_hot(torch.argmax(self.probs, dim=-1))
        if deterministic is True:
            out = det
        else:
            g = standard_gumbel(self.probs.shape, self.probs.dtype, self.probs.device, generator)
            one_hot = self._one_hot(torch.argmax(_log_clamped(self.probs) + g, dim=-1))
            out = _mix_det(det, self.probs + (one_hot - self.probs).detach(), deterministic)
        return out.reshape(*out.shape[:-2], self.n_cat * self.n_class)

    def log_prob(self, x: Tensor) -> Tensor:
        one_hot = x.reshape(*x.shape[:-1], self.n_cat, self.n_class)
        return torch.sum(one_hot * _log_clamped(self.probs), dim=(-2, -1))

    def repeat(self, n: int, axis: int = 0) -> "MultiCategorical":
        return MultiCategorical(
            probs=torch.repeat_interleave(self.probs, n, dim=axis),
            valid=None if self.valid is None else torch.repeat_interleave(self.valid, n, dim=axis),
        )


def kl_multi_categorical(p: MultiCategorical, q: MultiCategorical) -> Tensor:
    """KL(p || q) summed over the n_cat categoricals."""
    return torch.sum(p.probs * (_log_clamped(p.probs) - _log_clamped(q.probs)), dim=(-2, -1))


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
        return cls(logits=_log_clamped(probs), valid=valid)

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
