"""Polyline map encoder, DenseTNT path.

Counterpart of `trafficbots_tpu/models/map_encoder.py`: the input PE encoder
over every node, the per-polyline node stack and masked max-pool, invalid
polylines zeroed, then one self-attention layer over the polylines. In eval
the pool is kernel K2 (`ops.node_encoder.FusedNodeEncoder.encode_pooled`)
under `node_encoder_impl="fused"` (the default) or the hybrid layout with
the attention core K6 (`encode_pooled_hybrid`) under "hybrid", and the
self-attention core K1; in training (`rng` given, dropout live) the pool is
kernel K4 (`ops.node_encoder_train.node_encoder_train`, the JAX
`fused_train_ok` branch) whatever `node_encoder_impl` says, as in the JAX
package, unless `fused_train_kernel` is off: then the node stack's plain
version under autograd, as the JAX package then runs its XLA stack; and
the self-attention core K3 (S = T = n_pl >= 256). Off the card, or inside
`ops.plain_versions()`, their plain versions. `kernel_matmul_bf16` takes
K2's or K6's bf16-operand variant (and its plain version) in eval; training
ignores it, as the JAX package's training kernels do. The compute dtype
(`dtype`, bf16 under `precision="bf16"`) reaches the input PE encoder and
the polyline self-attention; the node stack stays fp32, as JAX's
`FusedNodeEncoder` takes none.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import InputPeEncoderConfig, MapEncoderConfig, TransformerConfig
from ..ops import kernels_enabled
from ..ops.dropout import DropoutSeeds
from ..ops.node_encoder import FusedNodeEncoder
from ..ops.node_encoder_train import node_encoder_train, node_encoder_train_plain
from .modules import InputPeEncoder, TransformerBlock, draw_seed, tf_block_kwargs

Tensor = torch.Tensor


class MapEncoder(nn.Module):
    def __init__(
        self, attr_dim: int, hidden_dim: int, pe_dim: int, cfg: MapEncoderConfig,
        pe_cfg: InputPeEncoderConfig, tf_cfg: TransformerConfig, dtype: torch.dtype = torch.float32,
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
            mlp_dropout_p=pe_cfg.mlp_dropout_p, dtype=dtype,
        )
        if cfg.node_encoder_impl not in ("fused", "hybrid"):
            raise ValueError(f"node_encoder_impl={cfg.node_encoder_impl!r}: 'fused' or 'hybrid'")
        self.node_encoder_impl = cfg.node_encoder_impl
        self.kernel_matmul_bf16 = cfg.kernel_matmul_bf16
        self.fused_train_kernel = cfg.fused_train_kernel
        self.dropout_p = tf_cfg.dropout_p
        self.densetnt = FusedNodeEncoder(
            d_model=hidden_dim, n_head=tf_cfg.n_head, n_layer=cfg.n_layer,
            d_feedforward=tf_cfg.d_feedforward,
        )
        self.self_attn = TransformerBlock(n_layer=1, dtype=dtype, **tf_block_kwargs(tf_cfg))

    def forward(
        self, map_valid: Tensor, map_attr: Tensor, map_pe: Tensor, rng: Optional[DropoutSeeds] = None,
    ) -> Tuple[Tensor, Tensor]:
        """[B, P, N] bool, [B, P, N, attr], [B, P, N, pe] -> ([B, P, d], [B, P])."""
        n_scene, n_pl, n_node = map_valid.shape
        pl_feature = self.input_pe(map_valid, map_attr, map_pe, rng=rng)
        flat = pl_feature.reshape(n_scene * n_pl, n_node, self.hidden_dim).contiguous()
        flat_valid = map_valid.reshape(n_scene * n_pl, n_node).contiguous()
        if rng is None:
            bf16 = self.kernel_matmul_bf16
            if self.node_encoder_impl == "hybrid":
                pooled = self.densetnt.encode_pooled_hybrid(flat, flat_valid, plain=not kernels_enabled(), bf16=bf16)
            else:
                pool = self.densetnt.encode_pooled if kernels_enabled() else self.densetnt.pooled_plain
                pooled = pool(flat, flat_valid, bf16=bf16)
        else:
            seed = draw_seed(rng, self.dropout_p)
            p, seed = (self.dropout_p, seed) if seed is not None else (0.0, 0)
            fused = kernels_enabled() and self.fused_train_kernel
            pool = node_encoder_train if fused else node_encoder_train_plain
            pooled = pool(self.densetnt, flat, flat_valid, p, seed)
        pooled = pooled.reshape(n_scene, n_pl, self.hidden_dim)
        pl_valid = map_valid.any(dim=-1)
        pl_feature = torch.where(pl_valid[..., None], pooled, torch.zeros_like(pooled))
        pl_feature = self.self_attn(
            pl_feature, src_padding_mask=~pl_valid, tgt=pl_feature, tgt_padding_mask=~pl_valid, rng=rng,
        )
        return pl_feature, pl_valid
