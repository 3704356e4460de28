"""CVAE personality latent encoder (posterior over the episode, prior over history).

Counterpart of `trafficbots_tpu/models/latent_encoder.py`. By default
(`shared_transformer_as`) the as2pl/as2tl cross-attention stacks are the
policy's own: they are handed in at construction and held outside this
module's parameter tree, so each shared weight has exactly one name
(`transformer_as2pl...`), as in the flax tree; otherwise the encoder holds
its own `as2pl`/`as2tl` blocks (`n_layer_tf_as2pl`/`n_layer_tf_as2tl`
layers). Under `shared_post_prior_net` the prior runs the posterior's
`temporal_post`/`interaction_post`, which then appear once in the tree.
Temporal downsampling by `temporal_down_sample_rate` keeps 19 of the
posterior's 91 steps. The distribution heads (`DistEncoder`): "dummy",
"std_gaus", "diag_gaus" with a constant or a learned (`mlp_log_std`)
log_std, and "cat" (`mlp_logits`, a softmax over n_class per category).
The compute dtype (`dtype`) reaches the cross-attention and interaction
transformers; the GRUs and the distribution heads stay fp32, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..config import AgentInteractionConfig, AgentTemporalConfig, DistEncoderConfig, LatentEncoderConfig, TransformerConfig
from ..distributions import DiagGaussian, DummyLatent, MultiCategorical
from ..ops.dropout import DropoutSeeds
from .modules import MLP, MultiAgentTF, StackedGRU, TransformerBlock, temporal_aggregate, tf_block_kwargs

Tensor = torch.Tensor
LatentDist = Union[DiagGaussian, DummyLatent, MultiCategorical]


class DistEncoder(nn.Module):
    """Aggregated feature -> latent distribution ("dummy", "std_gaus",
    "diag_gaus", "cat")."""

    def __init__(self, cfg: DistEncoderConfig, hidden_dim: int, out_dim: int):
        super().__init__()
        self.cfg = cfg
        self.out_dim = out_dim
        dt = cfg.dist_type
        if dt not in ("dummy", "std_gaus", "diag_gaus", "cat"):
            raise NotImplementedError(dt)

        def mlp() -> MLP:
            return MLP(hidden_dim, [hidden_dim, out_dim], use_layernorm=cfg.use_layernorm, end_layer_activation=False)

        if dt == "diag_gaus":
            self.mlp_mean = mlp()
            if cfg.log_std is None:
                self.mlp_log_std = mlp()
        if dt == "cat":
            assert out_dim % cfg.n_cat == 0
            self.mlp_logits = mlp()
        if dt == "std_gaus" or (dt == "diag_gaus" and cfg.log_std is not None):
            self.log_std = nn.Parameter(torch.full((out_dim,), float(cfg.log_std or 0.0)))

    @property
    def skip_forward(self) -> bool:
        return self.cfg.dist_type in ("dummy", "std_gaus")

    def forward(self, x: Tensor, valid: Tensor) -> LatentDist:
        shape = (*valid.shape, self.out_dim)
        dt = self.cfg.dist_type
        if dt == "dummy":
            return DummyLatent(zeros=x.new_zeros(shape), valid=valid)
        if dt == "std_gaus":
            return DiagGaussian(mean=x.new_zeros(shape), log_std=self.log_std.expand(shape), valid=valid)
        if dt == "cat":
            logits = self.mlp_logits(x, valid).reshape(*valid.shape, self.cfg.n_cat, -1)
            return MultiCategorical(probs=torch.softmax(logits, dim=-1), valid=valid)
        mean = self.mlp_mean(x, valid)
        if self.cfg.log_std is None:
            log_std = self.mlp_log_std(x, valid)
        else:
            log_std = self.log_std.expand(mean.shape)
        return DiagGaussian(mean=mean, log_std=log_std, valid=valid)


class LatentEncoder(nn.Module):
    def __init__(
        self,
        cfg: LatentEncoderConfig,
        tf_cfg: TransformerConfig,
        agent_temporal: AgentTemporalConfig,
        agent_interaction: AgentInteractionConfig,
        temporal_aggregate_mode: str,
        interaction_first: bool,
        transformer_as2pl: TransformerBlock,
        transformer_as2tl: TransformerBlock,
        n_layer_tf_as2pl: int = 3,
        n_layer_tf_as2tl: int = 3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.cfg = cfg
        self.temporal_aggregate_mode = temporal_aggregate_mode
        self.interaction_first = interaction_first
        if cfg.shared_transformer_as:
            # a tuple is not registered: the shared blocks' parameters belong to the policy
            self._shared = (transformer_as2pl, transformer_as2tl)
        else:
            kw = tf_block_kwargs(tf_cfg)
            self.as2pl = TransformerBlock(n_layer=n_layer_tf_as2pl, dtype=dtype, **kw)
            self.as2tl = TransformerBlock(n_layer=n_layer_tf_as2tl, dtype=dtype, **kw)
            self._shared = (self.as2pl, self.as2tl)
        hidden = tf_cfg.d_model
        self.prior_dist = DistEncoder(cfg.latent_prior, hidden, cfg.latent_dim)
        self.post_dist = DistEncoder(cfg.latent_post, hidden, cfg.latent_dim)
        if not self.post_dist.skip_forward:
            ai = agent_interaction
            tf_kwargs = dict(
                d_feedforward=tf_cfg.d_feedforward, n_head=tf_cfg.n_head, dropout_p=tf_cfg.dropout_p,
                activation=tf_cfg.activation, norm_first=tf_cfg.norm_first, bias=tf_cfg.bias,
            )

            def temporal():
                return StackedGRU(hidden, agent_temporal.num_layers, kind=agent_temporal.kind,
                                  dropout_p=agent_temporal.dropout)

            def interaction():
                return MultiAgentTF(
                    hidden, n_layer=ai.n_layer, mask_self_agent=ai.mask_self_agent,
                    detach_tgt=ai.detach_tgt, attn_to_map_aware_feature=ai.attn_to_map_aware_feature,
                    tf_kwargs=tf_kwargs, dtype=dtype,
                )

            self.temporal_post = temporal()
            self.interaction_post = interaction()
            if not self.prior_dist.skip_forward and not cfg.shared_post_prior_net:
                self.temporal_prior = temporal()
                self.interaction_prior = interaction()

    @property
    def dummy(self) -> bool:
        return self.cfg.latent_post.dist_type == "dummy"

    def forward(
        self,
        agent_feature: Tensor,  # [n_scene, n_step, n_agent, d]
        agent_feature_valid: Tensor,  # [n_scene, n_step, n_agent]
        map_feature: Tensor,  # [n_scene, n_pl, d]
        map_feature_valid: Tensor,  # [n_scene, n_pl]
        tl_feature: Optional[Tensor] = None,  # [n_scene, n_step, n_tl, d]
        tl_feature_valid: Optional[Tensor] = None,
        posterior: bool = False,
        rng: Optional[DropoutSeeds] = None,
    ) -> LatentDist:
        dist_enc = self.post_dist if posterior else self.prior_dist
        if dist_enc.skip_forward:
            return dist_enc(agent_feature[:, 0], agent_feature_valid.any(dim=1))

        r = self.cfg.temporal_down_sample_rate
        if r > 1:
            assert (agent_feature_valid.shape[1] - 1) % r == 0
            agent_feature = agent_feature[:, ::r]
            agent_feature_valid = agent_feature_valid[:, ::r]
            tl_feature = tl_feature[:, ::r]
            tl_feature_valid = tl_feature_valid[:, ::r]

        n_scene, n_step, n_agent, d = agent_feature.shape
        as2pl, as2tl = self._shared
        # cross-attention to the map over the flattened (step, agent) tokens
        x = as2pl(
            agent_feature.reshape(n_scene, n_step * n_agent, d),
            src_padding_mask=~agent_feature_valid.reshape(n_scene, n_step * n_agent),
            tgt=map_feature, tgt_padding_mask=~map_feature_valid, rng=rng,
        )
        # cross-attention to each step's traffic lights
        x = as2tl(
            x.reshape(n_scene * n_step, n_agent, d),
            src_padding_mask=~agent_feature_valid.reshape(n_scene * n_step, n_agent),
            tgt=tl_feature.reshape(n_scene * n_step, -1, d),
            tgt_padding_mask=~tl_feature_valid.reshape(n_scene * n_step, -1), rng=rng,
        ).reshape(n_scene, n_step, n_agent, d)

        own = posterior or self.cfg.shared_post_prior_net
        temporal = self.temporal_post if own else self.temporal_prior
        interaction = self.interaction_post if own else self.interaction_prior
        if self.interaction_first:
            x = interaction(x, agent_feature, agent_feature_valid, allow_fused=False, rng=rng)
            x, _ = temporal(x, agent_feature_valid, rng=rng)
        else:
            x, _ = temporal(x, agent_feature_valid, rng=rng)
            x = interaction(x, agent_feature, agent_feature_valid, allow_fused=False, rng=rng)
        x, latent_valid = temporal_aggregate(x, agent_feature_valid, self.temporal_aggregate_mode)
        return dist_enc(x, latent_valid)
