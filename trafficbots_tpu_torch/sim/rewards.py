"""Differentiable reward: negative imitation loss plus an optional collision penalty.

Counterpart of `trafficbots_tpu/sim/rewards.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..geometry import cast_rad

Tensor = torch.Tensor


def smooth_l1(pred: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def mse(pred: Tensor, target: Tensor) -> Tensor:
    d = pred - target
    return d * d


def l1(pred: Tensor, target: Tensor) -> Tensor:
    return torch.abs(pred - target)


_CRITERIA = {"SmoothL1Loss": smooth_l1, "MSELoss": mse, "L1Loss": l1}


def angular_error(preds: Tensor, target: Tensor, angular_type: Optional[str], criterion: str = "SmoothL1Loss") -> Tensor:
    crit = _CRITERIA[criterion]
    if angular_type is None:
        return crit(preds, target)
    if angular_type == "cast":
        diff = cast_rad(preds - target)
        return crit(diff, torch.zeros_like(diff))
    if angular_type == "cosine":
        return 0.5 * (1.0 - torch.cos(preds - target))
    if angular_type == "vector":
        return crit(torch.cos(preds), torch.cos(target)) + crit(torch.sin(preds), torch.sin(target))
    raise NotImplementedError(angular_type)


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    w_collision: float = 0.0
    reduce_collision_with_max: bool = True
    use_il_loss: bool = True
    w_pos: float = 1e-1
    criterion_pos: str = "SmoothL1Loss"
    w_rot: float = 1e1
    criterion_rot: str = "SmoothL1Loss"
    angular_type_rot: str = "cosine"
    w_spd: float = 1e-1
    criterion_spd: str = "SmoothL1Loss"


def _collision_penalty(agent_valid: Tensor, agent_state: Tensor, agent_size: Tensor, reduce_with_max: bool) -> Tensor:
    """5-circle pairwise soft collision."""
    eps = torch.finfo(agent_state.dtype).eps
    n_agent = agent_valid.shape[1]
    yaw = agent_state[..., 2]
    heading = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)
    agent_w = agent_size[:, :, :2].amin(dim=-1)
    agent_l = agent_size[:, :, :2].amax(dim=-1)
    agent_d = ((agent_l - agent_w) / 4.0)[..., None]
    offsets = torch.arange(-2.0, 3.0, device=agent_state.device)[None, None, :, None]
    centroids = agent_state[..., :2][:, :, None, :] + offsets * (heading * agent_d)[:, :, None, :]
    diff = centroids[:, :, None, :, None, :] - centroids[:, None, :, None, :, :]
    dist = torch.linalg.norm(diff, dim=-1) + eps
    dist = dist.reshape(*dist.shape[:3], 25).amin(dim=-1)
    agent_r = agent_w[:, :, None] / 2.0 + eps
    r_sum = agent_r.expand(dist.shape).transpose(1, 2) + agent_r
    collision = torch.clamp(1.0 - dist / r_sum, min=0.0)
    ego = torch.eye(n_agent, dtype=torch.bool, device=agent_state.device)[None]
    invalid = ego | ~agent_valid[:, :, None] | ~agent_valid[:, None, :]
    collision = torch.where(invalid, torch.zeros_like(collision), collision)
    if reduce_with_max:
        collision = collision.amax(dim=2)
    else:
        collision = torch.clamp(collision, max=1.0)
        collision = collision.sum(dim=-1) / agent_valid.sum(dim=-1, keepdim=True)
    return torch.where(agent_valid, collision, torch.zeros_like(collision))


def differentiable_reward(
    cfg: RewardConfig,
    agent_valid: Tensor,  # [B, A] bool
    agent_state: Tensor,  # [B, A, 4]
    gt_valid: Optional[Tensor],
    gt_state: Optional[Tensor],
    agent_size: Tensor,  # [B, A, 3]
) -> Tuple[Tensor, Tensor]:
    """Per-step reward and its validity."""
    reward = torch.zeros_like(agent_state[:, :, 0])
    reward_valid = agent_valid
    if cfg.w_collision > 0:
        reward = reward - cfg.w_collision * _collision_penalty(
            agent_valid, agent_state, agent_size, cfg.reduce_collision_with_max
        )
    if cfg.use_il_loss and gt_valid is not None:
        il_valid = agent_valid & gt_valid
        inv = ~il_valid[..., None]
        gt = torch.where(inv, torch.zeros_like(gt_state), gt_state)
        pred = torch.where(inv, torch.zeros_like(agent_state), agent_state)
        error_pos = _CRITERIA[cfg.criterion_pos](gt[..., :2], pred[..., :2]).sum(dim=-1)
        error_rot = angular_error(gt[..., 2], pred[..., 2], cfg.angular_type_rot, cfg.criterion_rot)
        error_spd = _CRITERIA[cfg.criterion_spd](gt[..., 3], pred[..., 3])
        reward = reward - (cfg.w_pos * error_pos + cfg.w_rot * error_rot + cfg.w_spd * error_spd)
        reward_valid = il_valid
    return torch.where(reward_valid, reward, torch.zeros_like(reward)), reward_valid
