"""Goal/destination conditioning for the eval rollout.

Counterpart of the parameter-free half of
`trafficbots_tpu/models/goal_manager.py`: the GT goal (`get_gt_goal`) and
the per-agent goal feature (`goal_feature`: in "dest" mode the map feature
of the destination polyline, gathered along the polyline axis). The
learned `DestPredictor` and `GoalPredictor` heads belong to the validation
slice of the port; `weights.load_jax_params` skips their subtree by name.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import GoalManagerConfig, TransformerConfig
from ..geometry import pos2local, rad2rot

Tensor = torch.Tensor


def goal_out_dim(cfg: GoalManagerConfig, tf_cfg: TransformerConfig) -> int:
    if cfg.goal_attr_mode == "dest":
        return tf_cfg.d_model
    if cfg.goal_attr_mode == "goal_xy":
        return 2
    return -1


def get_gt_goal(
    cfg: GoalManagerConfig, agent_valid: Tensor, gt_goal: Tensor, gt_dest: Tensor
) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """(goal, goal_valid): the destination index in "dest" mode, the final
    xy in "goal_xy" mode, (None, None) in "dummy" mode."""
    if cfg.goal_attr_mode == "dummy":
        return None, None
    valid = agent_valid.any(dim=1)
    if cfg.goal_attr_mode == "dest":
        return gt_dest, valid
    return gt_goal[..., :2], valid


def goal_feature(cfg: GoalManagerConfig, goal: Tensor, agent_state: Tensor, map_feature: Tensor) -> Tensor:
    """[B, A, out_dim] goal feature for the policy. "dest": map_feature[b,
    goal[b, a]] (the `take_along_axis` gather); "goal_xy": the goal in the
    agent's local frame when `goal_in_local`."""
    if cfg.goal_attr_mode == "dest":
        idx = goal[..., None].expand(-1, -1, map_feature.shape[-1])
        return torch.gather(map_feature, 1, idx)
    if cfg.goal_attr_mode == "goal_xy":
        gf = goal[..., :2]
        if cfg.goal_in_local:
            gf = pos2local(gf[..., None, :], agent_state[..., :2][..., None, :], rad2rot(agent_state[..., 2]))[..., 0, :]
        return gf
    raise NotImplementedError(cfg.goal_attr_mode)
