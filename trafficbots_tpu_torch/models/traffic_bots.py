"""TrafficBots policy: the encoders and one closed-loop policy step.

Counterpart of `trafficbots_tpu/models/traffic_bots.py`. Every per-rollout
quantity (GRU hidden state, latent sample, goal feature, map K/V cache) is
explicit data passed in and returned; the module only holds parameters,
under the same submodule names as the flax tree.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ActionHeadConfig, DataConfig, ModelConfig
from ..geometry import pose_pe_out_dim
from .goal_manager import goal_out_dim
from .latent_encoder import LatentEncoder
from .map_encoder import MapEncoder
from .modules import ActionHead, AddLatentGoal, InputPeEncoder, MultiAgentTF, StackedGRU, TransformerBlock, tf_block_kwargs

Tensor = torch.Tensor


class TrafficBots(nn.Module):
    def __init__(self, cfg: ModelConfig, action_head_cfg: ActionHeadConfig, data_cfg: DataConfig):
        super().__init__()
        if cfg.n_layer_final_mlp > 0:
            raise NotImplementedError("the final MLP is not part of the ported slice")
        self.cfg = cfg
        hidden = cfg.hidden_dim
        kw = tf_block_kwargs(cfg.tf_cfg)
        ipe = cfg.input_pe_encoder

        def input_pe(attr_dim: int, pose_mode: str) -> InputPeEncoder:
            return InputPeEncoder(
                attr_dim, hidden, pose_pe_out_dim(pose_mode, cfg.pe_dim), n_layer=ipe.n_layer,
                mlp_use_layernorm=ipe.mlp_use_layernorm, pe_mode=ipe.pe_mode,
            )

        self.map_encoder = MapEncoder(
            data_cfg.map_attr_dim, hidden, pose_pe_out_dim(cfg.pose_pe_map, cfg.pe_dim),
            cfg.map_encoder, ipe, cfg.tf_cfg,
        )
        self.tl_encoder = input_pe(data_cfg.tl_attr_dim, cfg.pose_pe_tl)
        self.agent_encoder = input_pe(data_cfg.agent_attr_dim, cfg.pose_pe_agent)
        self.transformer_as2pl = TransformerBlock(n_layer=cfg.n_layer_tf_as2pl, **kw)
        self.transformer_as2tl = TransformerBlock(n_layer=cfg.n_layer_tf_as2tl, **kw)
        self.latent_encoder = LatentEncoder(
            cfg.latent_encoder, cfg.tf_cfg, cfg.agent_temporal, cfg.agent_interaction,
            cfg.temporal_aggregate_mode, cfg.interaction_first,
            self.transformer_as2pl, self.transformer_as2tl,
        )
        self.agent_temporal = StackedGRU(hidden, cfg.agent_temporal.num_layers, kind=cfg.agent_temporal.kind)
        ai = cfg.agent_interaction
        self.agent_interaction_tf = MultiAgentTF(
            hidden, n_layer=ai.n_layer, mask_self_agent=ai.mask_self_agent, detach_tgt=ai.detach_tgt,
            attn_to_map_aware_feature=ai.attn_to_map_aware_feature,
            tf_kwargs=dict(
                d_feedforward=cfg.tf_cfg.d_feedforward, n_head=cfg.tf_cfg.n_head,
                activation=cfg.tf_cfg.activation, norm_first=cfg.tf_cfg.norm_first, bias=cfg.tf_cfg.bias,
            ),
        )
        self.goal_dummy = cfg.goal_manager.goal_attr_mode == "dummy"

        def add_latent_goal(c, in_dim: int, dummy: bool) -> AddLatentGoal:
            return AddLatentGoal(
                hidden, in_dim, dummy=dummy, mode=c.mode, res_cat=c.res_cat, res_add=c.res_add,
                n_layer_mlp_in=c.n_layer_mlp_in, n_layer_mlp_out=c.n_layer_mlp_out,
                mlp_in_use_layernorm=c.mlp_in_use_layernorm, mlp_out_use_layernorm=c.mlp_out_use_layernorm,
            )

        self.add_goal = add_latent_goal(
            cfg.add_goal, goal_out_dim(cfg.goal_manager, cfg.tf_cfg), self.goal_dummy
        )
        self.add_latent = add_latent_goal(
            cfg.add_latent, cfg.latent_encoder.latent_dim, self.latent_encoder.dummy
        )
        self.action_head = ActionHead(
            hidden, action_dim=2, use_layernorm=action_head_cfg.use_layernorm,
            log_std_init=action_head_cfg.log_std, branch_type=action_head_cfg.branch_type,
        )

    def encode_input_features(
        self,
        agent_valid: Tensor, agent_attr: Tensor, agent_pe: Tensor,
        map_valid: Tensor, map_attr: Tensor, map_pe: Tensor,
        tl_valid: Tensor, tl_attr: Tensor, tl_pe: Tensor,
        agent_pos: Optional[Tensor] = None, map_pos: Optional[Tensor] = None,
        tl_pos: Optional[Tensor] = None,
        map_feature: Optional[Tensor] = None, map_feature_valid: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        """One episode view's features. A precomputed `map_feature` skips the
        map encoder (the views share one map)."""
        if map_feature is None:
            map_feature, map_feature_valid = self.map_encoder(map_valid, map_attr, map_pe)
        return {
            "agent_feature": self.agent_encoder(agent_valid, agent_attr, agent_pe),
            "agent_feature_valid": agent_valid,
            "map_feature": map_feature,
            "map_feature_valid": map_feature_valid,
            "tl_feature": self.tl_encoder(tl_valid, tl_attr, tl_pe),
            "tl_feature_valid": tl_valid,
        }

    def encode_agent(self, valid: Tensor, attr: Tensor, pe: Tensor) -> Tensor:
        return self.agent_encoder(valid, attr, pe)

    def map_only(self, map_valid: Tensor, map_attr: Tensor, map_pe: Tensor) -> Tuple[Tensor, Tensor]:
        return self.map_encoder(map_valid, map_attr, map_pe)

    def latent(self, posterior: bool = False, **features):
        return self.latent_encoder(posterior=posterior, **features)

    def precompute_map_kv(self, map_feature: Tensor):
        """Per-layer (k, v) of the step-invariant map tokens for the rollout's
        as2pl, computed once per episode; stored in bf16 under
        `map_kv_bf16` (and used in fp32 after the load)."""
        kv = self.transformer_as2pl(None, tgt=map_feature, return_tgt_kv=True)
        if self.cfg.map_kv_bf16:
            kv = tuple((k.to(torch.bfloat16), v.to(torch.bfloat16)) for k, v in kv)
        return kv

    def precompute_add_feats(self, goal_feature, goal_valid, latent_sample, latent_valid):
        """The step-invariant z-side MLPs of the goal and latent injections."""
        goal_pre = None
        if goal_feature is not None and not self.add_goal.dummy:
            goal_pre = self.add_goal.precompute_z(goal_feature, goal_valid)
        latent_pre = None
        if latent_sample is not None and not self.add_latent.dummy:
            latent_pre = self.add_latent.precompute_z(latent_sample, latent_valid)
        return goal_pre, latent_pre

    def policy_step(
        self,
        agent_valid: Tensor,  # [B, A]
        agent_feature: Tensor,  # [B, A, d]
        map_valid: Tensor,  # [B, P]
        map_feature: Optional[Tensor],  # [B, P, d]
        tl_valid: Tensor,  # [B, n_tl]
        tl_feature: Tensor,  # [B, n_tl, d]
        goal_valid: Optional[Tensor],
        goal_feature: Optional[Tensor],
        latent_sample: Optional[Tensor],
        hidden: Tensor,  # [L, B, A, d]
        agent_type: Tensor,  # [B, A, 3]
        map_kv=None,
        goal_z_pre: Optional[Tensor] = None,
        latent_z_pre: Optional[Tensor] = None,
    ):
        """One step -> (action_mean, action_log_std, new_hidden, policy_feature)."""
        cfg = self.cfg
        x = self.transformer_as2pl(
            agent_feature, src_padding_mask=~agent_valid,
            tgt=None if map_kv is not None else map_feature,
            tgt_padding_mask=~map_valid, tgt_kv=map_kv,
        )
        x = self.transformer_as2tl(
            x, src_padding_mask=~agent_valid, tgt=tl_feature, tgt_padding_mask=~tl_valid,
            allow_fused=cfg.fused_attention_small_t,
        )

        def add_goal_latent(x):
            x = self.add_goal(x, agent_valid, goal_feature, goal_valid, z_pre=goal_z_pre)
            return self.add_latent(x, agent_valid, latent_sample, agent_valid, z_pre=latent_z_pre)

        if cfg.add_goal_latent_first:
            x = add_goal_latent(x)
        if cfg.interaction_first:
            x = self.agent_interaction_tf(x, agent_feature, agent_valid, allow_fused=cfg.fused_attention_small_t)
            x, hidden = self.agent_temporal(x, agent_valid, hidden)
        else:
            x, hidden = self.agent_temporal(x, agent_valid, hidden)
            x = self.agent_interaction_tf(x, agent_feature, agent_valid, allow_fused=cfg.fused_attention_small_t)
        if not cfg.add_goal_latent_first:
            x = add_goal_latent(x)
        action_mean, action_log_std = self.action_head(x, agent_valid, agent_type)
        return action_mean, action_log_std, hidden, x

    def init_hidden(self, n_batch: int, n_agent: int, device=None) -> Tensor:
        return torch.zeros(
            (self.cfg.agent_temporal.num_layers, n_batch, n_agent, self.cfg.hidden_dim), device=device
        )
