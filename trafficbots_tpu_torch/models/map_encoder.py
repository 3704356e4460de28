"""Polyline map encoder, DenseTNT path.

Counterpart of `trafficbots_tpu/models/map_encoder.py`: the input PE encoder
over every node, the per-polyline node stack and masked max-pool (kernel K2,
`ops.node_encoder.FusedNodeEncoder.encode_pooled`), invalid polylines zeroed,
then one self-attention layer over the polylines (its core is kernel K1 on
CUDA at full width: S = T = n_pl >= 64).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import InputPeEncoderConfig, MapEncoderConfig, TransformerConfig
from ..ops import kernels_enabled
from ..ops.node_encoder import FusedNodeEncoder
from .modules import InputPeEncoder, TransformerBlock, tf_block_kwargs

Tensor = torch.Tensor


class MapEncoder(nn.Module):
    def __init__(
        self, attr_dim: int, hidden_dim: int, pe_dim: int, cfg: MapEncoderConfig,
        pe_cfg: InputPeEncoderConfig, tf_cfg: TransformerConfig,
    ):
        super().__init__()
        default_stack = (
            tf_cfg.norm_first and tf_cfg.d_feedforward > 0 and tf_cfg.activation == "relu"
            and tf_cfg.bias and not tf_cfg.out_layernorm
        )
        if not (cfg.densetnt_vectornet and default_stack and cfg.pool_mode == "max"):
            raise NotImplementedError(
                "the ported map encoder is the DenseTNT node stack with the default layer recipe and max pool"
            )
        self.hidden_dim = hidden_dim
        self.input_pe = InputPeEncoder(
            attr_dim, hidden_dim, pe_dim, n_layer=pe_cfg.n_layer,
            mlp_use_layernorm=pe_cfg.mlp_use_layernorm, pe_mode=pe_cfg.pe_mode,
        )
        self.densetnt = FusedNodeEncoder(
            d_model=hidden_dim, n_head=tf_cfg.n_head, n_layer=cfg.n_layer,
            d_feedforward=tf_cfg.d_feedforward,
        )
        self.self_attn = TransformerBlock(n_layer=1, **tf_block_kwargs(tf_cfg))

    def forward(self, map_valid: Tensor, map_attr: Tensor, map_pe: Tensor) -> Tuple[Tensor, Tensor]:
        """[B, P, N] bool, [B, P, N, attr], [B, P, N, pe] -> ([B, P, d], [B, P])."""
        n_scene, n_pl, n_node = map_valid.shape
        pl_feature = self.input_pe(map_valid, map_attr, map_pe)
        pool = self.densetnt.encode_pooled if kernels_enabled() else self.densetnt.pooled_plain
        pooled = pool(
            pl_feature.reshape(n_scene * n_pl, n_node, self.hidden_dim).contiguous(),
            map_valid.reshape(n_scene * n_pl, n_node).contiguous(),
        ).reshape(n_scene, n_pl, self.hidden_dim)
        pl_valid = map_valid.any(dim=-1)
        pl_feature = torch.where(pl_valid[..., None], pooled, torch.zeros_like(pooled))
        pl_feature = self.self_attn(
            pl_feature, src_padding_mask=~pl_valid, tgt=pl_feature, tgt_padding_mask=~pl_valid,
        )
        return pl_feature, pl_valid
