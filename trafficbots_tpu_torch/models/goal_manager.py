"""Goal/destination conditioning: GT goals, goal features, the destination head.

Counterpart of `trafficbots_tpu/models/goal_manager.py`: the GT goal
(`get_gt_goal`), the per-agent goal feature (`goal_feature`: in "dest" mode
the map feature of the destination polyline, gathered along the polyline
axis), and `GoalManager` holding the learned `DestPredictor` ("dest" mode,
head mode "mlp", the default) that the training loss's goal NLL reads. The
"goal_xy" `GoalPredictor` and the other head modes belong to the validation
slice of the port and raise `NotImplementedError`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import GoalManagerConfig, TransformerConfig
from ..distributions import DestCategorical
from ..geometry import pos2local, rad2rot
from ..ops.dropout import DropoutSeeds
from .modules import MLP, StackedGRU, temporal_aggregate

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
        if cfg.dest_detach_map_feature:
            map_feature = map_feature.detach()
        idx = goal[..., None].expand(-1, -1, map_feature.shape[-1])
        return torch.gather(map_feature, 1, idx)
    if cfg.goal_attr_mode == "goal_xy":
        gf = goal[..., :2]
        if cfg.goal_in_local:
            st = agent_state.detach()
            gf = pos2local(gf[..., None, :], st[..., :2][..., None, :], rad2rot(st[..., 2]))[..., 0, :]
        return gf
    raise NotImplementedError(cfg.goal_attr_mode)


def dest_type_masks(agent_type: Tensor, map_type: Tensor, map_feature_valid: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-type destination masks (True = excluded): [S, P] for polylines
    that are invalid or not a lane / road edge type, and [S, A, P] by agent
    type (vehicles exclude bike lanes, pedestrians all lanes, cyclists car
    lanes)."""
    map_type_mask = ~(map_feature_valid & map_type[:, :, :5].any(dim=-1))
    m_veh = agent_type[:, :, 0:1] & map_type[:, :, 3][:, None, :]
    m_ped = agent_type[:, :, 1:2] & map_type[:, :, :4].any(dim=-1)[:, None, :]
    m_cyc = agent_type[:, :, 2:3] & map_type[:, :, :3].any(dim=-1)[:, None, :]
    return map_type_mask, m_veh | m_ped | m_cyc


class DestPredictor(nn.Module):
    """Destination (polyline index) head, mode "mlp": a StackedGRU over the
    agent features (+ residual), the last valid step, then an MLP over every
    (agent, polyline) pair, fed factored (map feature, agent feature)."""

    def __init__(
        self, hidden: int, n_layer_gru: int = 3, use_layernorm: bool = True, res_add_gru: bool = True,
        detach_features: bool = True, dropout_p: float = 0.0,
    ):
        super().__init__()
        self.res_add_gru = res_add_gru
        self.detach_features = detach_features
        self.gru_as = StackedGRU(hidden, n_layer_gru, dropout_p=dropout_p) if n_layer_gru > 0 else None
        self.mlp = MLP(2 * hidden, [hidden, hidden, 1], use_layernorm=use_layernorm, end_layer_activation=False)

    def forward(
        self,
        agent_type: Tensor,  # [S, A, 3]
        map_type: Tensor,  # [S, P, n_pl_type]
        agent_state: Tensor,  # [S, T, A, 4]
        agent_feature: Tensor,  # [S, T, A, d]
        agent_feature_valid: Tensor,  # [S, T, A]
        map_feature: Tensor,  # [S, P, d]
        map_feature_valid: Tensor,  # [S, P]
        tl_feature: Optional[Tensor] = None,
        tl_feature_valid: Optional[Tensor] = None,
        rng: Optional[DropoutSeeds] = None,
    ) -> DestCategorical:
        if self.detach_features:
            agent_feature = agent_feature.detach()
            map_feature = map_feature.detach()
        map_type_mask, attn_mask = dest_type_masks(agent_type, map_type, map_feature_valid)
        dist_valid = agent_feature_valid.any(dim=1)
        y = agent_feature
        if self.gru_as is not None:
            y, _ = self.gru_as(agent_feature, agent_feature_valid, rng=rng)
            if self.res_add_gru:
                y = y + agent_feature
        tgt, _ = temporal_aggregate(y, agent_feature_valid, "last_valid")  # [S, A, d]
        logits = self.mlp((map_feature[:, None], tgt[:, :, None]))[..., 0]  # [S, A, P]
        neg_inf = torch.full_like(logits, float("-inf"))
        logits = torch.where(map_type_mask[:, None, :], neg_inf, logits)
        logits = torch.where(attn_mask, neg_inf, logits)
        logits = torch.where(dist_valid[..., None], logits, torch.zeros_like(logits))
        all_masked = torch.isneginf(logits).all(dim=-1, keepdim=True)
        logits = torch.where(all_masked, torch.zeros_like(logits), logits)
        return DestCategorical.from_logits(logits, valid=dist_valid)


class GoalManager(nn.Module):
    """Holds the goal predictor under the flax name `predictor`."""

    def __init__(self, cfg: GoalManagerConfig, tf_cfg: TransformerConfig):
        super().__init__()
        self.mode = cfg.goal_attr_mode
        gp = cfg.goal_predictor
        if self.mode == "dest":
            if gp.mode != "mlp":
                raise NotImplementedError(f"the ported DestPredictor is the 'mlp' head, not {gp.mode!r}")
            self.predictor = DestPredictor(
                tf_cfg.d_model, n_layer_gru=gp.n_layer_gru, use_layernorm=gp.use_layernorm,
                res_add_gru=gp.res_add_gru, detach_features=gp.detach_features, dropout_p=tf_cfg.dropout_p,
            )
        else:
            self.predictor = None

    def pred_goal(self, rng: Optional[DropoutSeeds] = None, **features) -> Optional[DestCategorical]:
        if self.mode == "goal_xy":
            raise NotImplementedError("the goal_xy GoalPredictor belongs to the validation slice of the port")
        return None if self.predictor is None else self.predictor(rng=rng, **features)
