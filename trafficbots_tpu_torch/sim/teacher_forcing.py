"""Teacher-forcing override masks, built once per rollout.

Counterpart of `trafficbots_tpu/sim/teacher_forcing.py`. The result is a
[B, n_step, A] bool mask: agents marked at a step take the GT state after
the dynamics update.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TeacherForcingConfig:
    step_spawn_agent: int = 10
    step_warm_start: int = 10
    step_horizon: int = 0
    step_horizon_decrease_per_epoch: int = 0
    prob_forcing_agent: float = 0.0
    prob_forcing_agent_decrease_per_epoch: float = 0.0
    gt_sdc: bool = False


def teacher_forcing_mask(
    cfg: TeacherForcingConfig,
    as_valid: Tensor,  # [B, n_step, A] bool GT validity
    current_epoch: int = 0,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Step 0 always; spawn on rising validity edges up to step_spawn_agent;
    warm start up to step_warm_start; the epoch-scheduled horizon; per-agent
    Bernoulli forcing; gt_sdc forces agent 0. All masked by GT validity."""
    n_step = as_valid.shape[1]
    step_idx = torch.arange(n_step, device=as_valid.device)[None, :, None]
    mask = torch.zeros_like(as_valid)
    mask[:, 0] = as_valid[:, 0]
    if cfg.step_spawn_agent > 0:
        rising = ~as_valid[:, :-1] & as_valid[:, 1:]
        rising = rising & (step_idx[:, 1:] <= cfg.step_spawn_agent)
        mask[:, 1:] = mask[:, 1:] | rising
    if cfg.step_warm_start >= 0:
        mask = mask | (as_valid & (step_idx <= cfg.step_warm_start))
    if cfg.step_horizon > 0:
        step_horizon = cfg.step_horizon - cfg.step_horizon_decrease_per_epoch * current_epoch
        mask = mask | (as_valid & (step_idx < step_horizon))
    if cfg.prob_forcing_agent > 0:
        if generator is None:
            raise ValueError("prob_forcing_agent > 0 needs a generator")
        prob = min(max(cfg.prob_forcing_agent - cfg.prob_forcing_agent_decrease_per_epoch * current_epoch, 0.0), 1.0)
        u = torch.rand(as_valid[:, 0].shape, generator=generator, device=generator.device).to(as_valid.device)
        mask = mask | ((u < prob)[:, None, :] & as_valid)
    if cfg.gt_sdc:
        mask[:, :, 0] = mask[:, :, 0] | as_valid[:, :, 0]
    return mask
