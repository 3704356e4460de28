"""Goal/destination conditioning: GT goals, goal features, the goal heads.

Counterpart of `trafficbots_tpu/models/goal_manager.py`: the GT goal
(`get_gt_goal`), the per-agent goal feature (`goal_feature`: in "dest" mode
the map feature of the destination polyline, gathered along the polyline
axis; in "goal_xy" mode the goal in the agent's frame), and `GoalManager`
holding the learned head the training loss's goal NLL reads and the joint
futures sample: `DestPredictor` in "dest" mode (head modes "mlp", the
default, "attn", "transformer" and "transformer_aggr") and `GoalPredictor`
in "goal_xy" mode (a DiagGaussian over the goal's xy).

Attention sites: the GoalPredictor's as2pl (S = agents, T = polylines) is a
kernel site as the rollout's as2pl is (K1 in eval, K3 in training); the
"transformer" heads' pl2as (queries = polylines, targets = at most 6
history steps) and the "attn" head (which needs the weights) run the plain
core, as the JAX package runs XLA there. The compute dtype (`dtype`) reaches the
heads' attention and transformer layers; their GRUs and MLPs stay fp32, as
in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..config import GoalManagerConfig, TransformerConfig
from ..distributions import DestCategorical, DiagGaussian
from ..geometry import pos2global, pos2local, rad2rot
from ..ops.dropout import DropoutSeeds
from .modules import MLP, Attention, StackedGRU, TransformerBlock, temporal_aggregate, tf_block_kwargs

Tensor = torch.Tensor
DEST_MODES = ("mlp", "attn", "transformer", "transformer_aggr")


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


class _GruLastValid(nn.Module):
    """The heads' agent summary: a StackedGRU `gru_as` over the history
    (+ the residual), then the last valid step -> ([S, A, d], [S, A])."""

    def __init__(self, hidden: int, n_layer_gru: int, res_add_gru: bool, dropout_p: float):
        super().__init__()
        self.res_add_gru = res_add_gru
        self.gru_as = StackedGRU(hidden, n_layer_gru, dropout_p=dropout_p) if n_layer_gru > 0 else None

    def summary(self, x: Tensor, valid: Tensor, rng: Optional[DropoutSeeds]) -> Tuple[Tensor, Tensor]:
        y = x
        if self.gru_as is not None:
            y, _ = self.gru_as(x, valid, rng=rng)
            if self.res_add_gru:
                y = y + x
        return temporal_aggregate(y, valid, "last_valid")


class DestPredictor(_GruLastValid):
    """Destination (polyline index) head over every (agent, polyline) pair.
    "mlp": the agent summary and the map feature into an MLP, fed factored
    (map feature, agent feature). "attn": the agent summary attends to the
    map under the type masks; the logits are the log of the head-averaged
    attention probabilities. "transformer" (every second history step) and
    "transformer_aggr" (the agent summary, one token): each agent's copy of
    the map [S*A, P, d] attends to that agent's tokens (`pl2as`), then an
    MLP. Excluded polylines get -inf, rows with none left flat logits."""

    def __init__(self, tf_cfg: TransformerConfig, mode: str = "mlp", n_layer_gru: int = 3,
                 use_layernorm: bool = True, res_add_gru: bool = True, detach_features: bool = True,
                 dtype: torch.dtype = torch.float32):
        if mode not in DEST_MODES:
            raise NotImplementedError(mode)
        hidden = tf_cfg.d_model
        super().__init__(hidden, n_layer_gru if mode != "transformer" else 0, res_add_gru, tf_cfg.dropout_p)
        self.mode = mode
        self.detach_features = detach_features
        if mode == "mlp":
            self.mlp = MLP(2 * hidden, [hidden, hidden, 1], use_layernorm=use_layernorm, end_layer_activation=False)
        elif mode == "attn":
            self.attn = Attention(hidden, tf_cfg.n_head, bias=tf_cfg.bias, dropout_p=tf_cfg.dropout_p, dtype=dtype)
        else:
            self.pl2as = TransformerBlock(n_layer=1, dtype=dtype, **tf_block_kwargs(tf_cfg))
            self.mlp = MLP(hidden, [hidden, 1], use_layernorm=use_layernorm, end_layer_activation=False)

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
        S, P, d = map_feature.shape
        A = agent_feature_valid.shape[2]
        dist_valid = agent_feature_valid.any(dim=1)
        if self.mode == "mlp":
            tgt, _ = self.summary(agent_feature, agent_feature_valid, rng)  # [S, A, d]
            logits = self.mlp((map_feature[:, None], tgt[:, :, None]))[..., 0]  # [S, A, P]
        elif self.mode == "attn":
            src, _ = self.summary(agent_feature, agent_feature_valid, rng)
            _, probs = self.attn(src, tgt=map_feature, tgt_padding_mask=map_type_mask, attn_mask=attn_mask,
                                 rng=rng, need_weights=True)
            logits = torch.log(torch.clamp(probs, min=torch.finfo(probs.dtype).tiny))
        else:
            if self.mode == "transformer_aggr":
                tgt, tgt_valid = self.summary(agent_feature, agent_feature_valid, rng)
                tgt, tgt_valid = tgt.reshape(S * A, 1, d), tgt_valid.reshape(S * A, 1)
            else:
                k_skip = 2
                tgt = agent_feature.transpose(1, 2)[:, :, ::k_skip].reshape(S * A, -1, d)
                tgt_valid = agent_feature_valid.transpose(1, 2)[:, :, ::k_skip].reshape(S * A, -1)
            map_rep = map_feature[:, None].expand(S, A, P, d).reshape(S * A, P, d)
            map_rep_valid = map_feature_valid[:, None].expand(S, A, P).reshape(S * A, P)
            map_rep = self.pl2as(map_rep, src_padding_mask=~map_rep_valid, tgt=tgt,
                                 tgt_padding_mask=~tgt_valid, rng=rng)
            logits = self.mlp(map_rep.reshape(S, A, P, d))[..., 0]
        neg_inf = torch.full_like(logits, float("-inf"))
        logits = torch.where(map_type_mask[:, None, :], neg_inf, logits)
        logits = torch.where(attn_mask, neg_inf, logits)
        logits = torch.where(dist_valid[..., None], logits, torch.zeros_like(logits))
        all_masked = torch.isneginf(logits).all(dim=-1, keepdim=True)
        logits = torch.where(all_masked, torch.zeros_like(logits), logits)
        return DestCategorical.from_logits(logits, valid=dist_valid)


class GoalPredictor(_GruLastValid):
    """The goal_xy head: the agent summary attends to the map (`as2pl`, one
    layer), an MLP gives the goal's mean, moved from the agent's frame at
    the last history step to the global one when `goal_in_local`, zeroed
    for agents without history; a learned `log_std` [2] (initialised 2.0)."""

    def __init__(self, tf_cfg: TransformerConfig, goal_in_local: bool = True, n_layer_gru: int = 3,
                 use_layernorm: bool = True, res_add_gru: bool = True, detach_features: bool = True,
                 dtype: torch.dtype = torch.float32):
        hidden = tf_cfg.d_model
        super().__init__(hidden, n_layer_gru, res_add_gru, tf_cfg.dropout_p)
        self.goal_in_local = goal_in_local
        self.detach_features = detach_features
        self.as2pl = TransformerBlock(n_layer=1, dtype=dtype, **tf_block_kwargs(tf_cfg))
        self.mlp_mean = MLP(hidden, [hidden, 2], use_layernorm=use_layernorm, end_layer_activation=False)
        self.log_std = nn.Parameter(torch.full((2,), 2.0))

    def forward(
        self,
        agent_type: Tensor,
        map_type: Tensor,
        agent_state: Tensor,  # [S, T, A, 4]
        agent_feature: Tensor,  # [S, T, A, d]
        agent_feature_valid: Tensor,  # [S, T, A]
        map_feature: Tensor,  # [S, P, d]
        map_feature_valid: Tensor,  # [S, P]
        tl_feature: Optional[Tensor] = None,
        tl_feature_valid: Optional[Tensor] = None,
        rng: Optional[DropoutSeeds] = None,
    ) -> DiagGaussian:
        if self.detach_features:
            agent_feature = agent_feature.detach()
            map_feature = map_feature.detach()
        src, src_valid = self.summary(agent_feature, agent_feature_valid, rng)
        goal_feature = self.as2pl(src, src_padding_mask=~src_valid, tgt=map_feature,
                                  tgt_padding_mask=~map_feature_valid, rng=rng)
        goal_mean = self.mlp_mean(goal_feature)
        if self.goal_in_local:
            ref_pos = agent_state[:, -1, :, :2][..., None, :]  # [S, A, 1, 2]
            ref_rot = rad2rot(agent_state[:, -1, :, 2])  # [S, A, 2, 2]
            goal_mean = pos2global(goal_mean[..., None, :], ref_pos, ref_rot)[..., 0, :]
        goal_valid = agent_feature_valid.any(dim=1)
        goal_mean = torch.where(goal_valid[..., None], goal_mean, torch.zeros_like(goal_mean))
        return DiagGaussian(mean=goal_mean, log_std=self.log_std.expand(goal_mean.shape), valid=goal_valid)


class GoalManager(nn.Module):
    """Holds the goal head under the flax name `predictor` (none in "dummy"
    mode)."""

    def __init__(self, cfg: GoalManagerConfig, tf_cfg: TransformerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mode = cfg.goal_attr_mode
        gp = cfg.goal_predictor
        kw = dict(n_layer_gru=gp.n_layer_gru, use_layernorm=gp.use_layernorm, res_add_gru=gp.res_add_gru,
                  detach_features=gp.detach_features, dtype=dtype)
        if self.mode == "dest":
            self.predictor = DestPredictor(tf_cfg, mode=gp.mode, **kw)
        elif self.mode == "goal_xy":
            self.predictor = GoalPredictor(tf_cfg, goal_in_local=cfg.goal_in_local, **kw)
        else:
            self.predictor = None

    def pred_goal(self, rng: Optional[DropoutSeeds] = None, **features) -> Optional[Union[DestCategorical, DiagGaussian]]:
        return None if self.predictor is None else self.predictor(rng=rng, **features)
