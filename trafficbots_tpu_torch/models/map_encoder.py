"""Polyline map encoder.

Counterpart of `trafficbots_tpu/models/map_encoder.py`: the input PE encoder
over every node, a per-polyline node encoder and a pool over the nodes,
invalid polylines zeroed, then one self-attention layer over the polylines.

The node encoder (`densetnt_vectornet`) is the DenseTNT stack, three ways,
as the JAX package chooses them:
  - the default layer recipe (pre-norm, a ReLU feed-forward, biases, no
    out-LayerNorm) under the max pool: in eval kernel K2
    (`ops.node_encoder.FusedNodeEncoder.encode_pooled`) under
    `node_encoder_impl="fused"` (the default) or the hybrid layout with
    the attention core K6 (`encode_pooled_hybrid`) under "hybrid"; in
    training (`rng` given, dropout live) kernel K4
    (`ops.node_encoder_train.node_encoder_train`, the JAX `fused_train_ok`
    branch) whatever `node_encoder_impl` says, unless `fused_train_kernel`
    is off: then the node stack's plain version under autograd, as the JAX
    package then runs its XLA stack. On the card a width the kernel does
    not take raises (its wrapper's `kernel_refusal`), where the JAX
    package runs its Pallas kernel;
  - the default recipe under the "mean" or "first" pool: the un-pooled
    stack (`FusedNodeEncoder.forward`, with the training kernel's dropout
    sites), then the pool;
  - any other recipe (another activation, `bias=False`, `out_layernorm`,
    post-norm, no feed-forward): the generic `TransformerBlock` stack
    (`densetnt`), its node self-attention below every kernel's site.
Otherwise VectorNet: `n_layer` MLPs `vn_mlp{i}` to hidden / 2, each
output concatenated with its max over the polyline's nodes (invalid nodes
filled with -inf before the pool), the last one's end activation only
under post-norm.

Off the card, or inside `ops.plain_versions()`, every kernel's plain
version. The polyline self-attention is a K1 site in eval and a K3 site in
training (S = T = n_pl >= 256). `kernel_matmul_bf16` takes K2's or K6's
bf16-operand variant (and its plain version) in eval; training ignores
it, as the JAX package's training kernels do. The compute dtype (`dtype`,
bf16 under `precision="bf16"`) reaches the input PE encoder, the generic
node stack and the polyline self-attention; the fused node stack and the
VectorNet MLPs stay fp32, as JAX's `FusedNodeEncoder` and its `vn_mlp`
take none.
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
from .modules import MLP, InputPeEncoder, TransformerBlock, draw_seed, tf_block_kwargs

Tensor = torch.Tensor


class MapEncoder(nn.Module):
    def __init__(
        self, attr_dim: int, hidden_dim: int, pe_dim: int, cfg: MapEncoderConfig,
        pe_cfg: InputPeEncoderConfig, tf_cfg: TransformerConfig, dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if cfg.pool_mode not in ("max", "mean", "first"):
            raise NotImplementedError(cfg.pool_mode)
        if cfg.node_encoder_impl not in ("fused", "hybrid"):
            raise ValueError(f"node_encoder_impl={cfg.node_encoder_impl!r}: 'fused' or 'hybrid'")
        self.hidden_dim = hidden_dim
        self.pool_mode = cfg.pool_mode
        self.input_pe = InputPeEncoder(
            attr_dim, hidden_dim, pe_dim, n_layer=pe_cfg.n_layer,
            mlp_use_layernorm=pe_cfg.mlp_use_layernorm, pe_mode=pe_cfg.pe_mode,
            mlp_dropout_p=pe_cfg.mlp_dropout_p, dtype=dtype,
        )
        self.node_encoder_impl = cfg.node_encoder_impl
        self.kernel_matmul_bf16 = cfg.kernel_matmul_bf16
        self.fused_train_kernel = cfg.fused_train_kernel
        self.dropout_p = tf_cfg.dropout_p
        self.vectornet = not cfg.densetnt_vectornet
        # the layer recipe FusedNodeEncoder implements; any other takes the generic stack
        self.fused_stack = cfg.densetnt_vectornet and (
            tf_cfg.norm_first and tf_cfg.d_feedforward > 0 and tf_cfg.activation == "relu"
            and tf_cfg.bias and not tf_cfg.out_layernorm
        )
        if self.fused_stack:
            self.densetnt = FusedNodeEncoder(
                d_model=hidden_dim, n_head=tf_cfg.n_head, n_layer=cfg.n_layer,
                d_feedforward=tf_cfg.d_feedforward,
            )
        elif cfg.densetnt_vectornet:
            self.densetnt = TransformerBlock(n_layer=cfg.n_layer, dtype=dtype, **tf_block_kwargs(tf_cfg))
        else:
            d = hidden_dim
            for i in range(cfg.n_layer):
                end_act = not tf_cfg.norm_first if i == cfg.n_layer - 1 else True
                self.add_module(f"vn_mlp{i}", MLP(
                    d, [hidden_dim // 2], use_layernorm=cfg.mlp_use_layernorm, end_layer_activation=end_act,
                    dropout_p=cfg.mlp_dropout_p,
                ))
                d = hidden_dim // 2 * 2
            self.n_vn_layer = cfg.n_layer
        self.self_attn = TransformerBlock(n_layer=1, dtype=dtype, **tf_block_kwargs(tf_cfg))

    def pooled_stack(self, flat: Tensor, flat_valid: Tensor, rng: Optional[DropoutSeeds]) -> Tensor:
        """The fused-recipe node stack and max pool -> [BP, d]: K2 or K6 in
        eval, K4 in training unless `fused_train_kernel` is off."""
        enc = self.densetnt
        if rng is None:
            bf16 = self.kernel_matmul_bf16
            if self.node_encoder_impl == "hybrid":
                return enc.encode_pooled_hybrid(flat, flat_valid, plain=not kernels_enabled(), bf16=bf16)
            pool = enc.encode_pooled if kernels_enabled() else enc.pooled_plain
            return pool(flat, flat_valid, bf16=bf16)
        seed = draw_seed(rng, self.dropout_p)
        p, seed = (self.dropout_p, seed) if seed is not None else (0.0, 0)
        fused = kernels_enabled() and self.fused_train_kernel
        return (node_encoder_train if fused else node_encoder_train_plain)(enc, flat, flat_valid, p, seed)

    def node_features(self, pl_feature: Tensor, map_valid: Tensor, rng: Optional[DropoutSeeds]) -> Tensor:
        """The un-pooled node encoder -> [B, P, N, d']: the fused recipe's
        stack, the generic stack, or VectorNet's MLPs."""
        n_scene, n_pl, n_node = map_valid.shape
        if self.vectornet:
            for i in range(self.n_vn_layer):
                enc = getattr(self, f"vn_mlp{i}")(pl_feature, map_valid, fill_invalid=float("-inf"), rng=rng)
                pl_feature = torch.cat([enc, enc.amax(dim=2, keepdim=True).expand_as(enc)], dim=-1)
            return pl_feature
        flat = pl_feature.reshape(n_scene * n_pl, n_node, self.hidden_dim)
        flat_valid = map_valid.reshape(n_scene * n_pl, n_node)
        if self.fused_stack:
            seed = draw_seed(rng, self.dropout_p)
            p, seed = (self.dropout_p, seed) if seed is not None else (0.0, 0)
            flat = self.densetnt(flat, flat_valid, p, seed)
        else:
            flat = self.densetnt(flat, src_padding_mask=~flat_valid, tgt=flat, tgt_padding_mask=~flat_valid, rng=rng)
        return flat.reshape(n_scene, n_pl, n_node, self.hidden_dim)

    def forward(
        self, map_valid: Tensor, map_attr: Tensor, map_pe: Tensor, rng: Optional[DropoutSeeds] = None,
    ) -> Tuple[Tensor, Tensor]:
        """[B, P, N] bool, [B, P, N, attr], [B, P, N, pe] -> ([B, P, d], [B, P])."""
        n_scene, n_pl, n_node = map_valid.shape
        pl_feature = self.input_pe(map_valid, map_attr, map_pe, rng=rng)
        if self.fused_stack and self.pool_mode == "max":
            flat = pl_feature.reshape(n_scene * n_pl, n_node, self.hidden_dim).contiguous()
            flat_valid = map_valid.reshape(n_scene * n_pl, n_node).contiguous()
            pooled = self.pooled_stack(flat, flat_valid, rng).reshape(n_scene, n_pl, self.hidden_dim)
        else:
            nodes = self.node_features(pl_feature, map_valid, rng)
            if self.pool_mode == "max":
                pooled = torch.where(map_valid[..., None], nodes, torch.full_like(nodes, float("-inf"))).amax(dim=2)
            elif self.pool_mode == "first":
                pooled = nodes[:, :, 0]
            else:
                nodes = torch.where(map_valid[..., None], nodes, torch.zeros_like(nodes))
                denom = map_valid.sum(dim=-1, keepdim=True).to(nodes.dtype) + torch.finfo(nodes.dtype).eps
                pooled = nodes.sum(dim=2) / denom
        pl_valid = map_valid.any(dim=-1)
        pl_feature = torch.where(pl_valid[..., None], pooled, torch.zeros_like(pooled))
        pl_feature = self.self_attn(
            pl_feature, src_padding_mask=~pl_valid, tgt=pl_feature, tgt_padding_mask=~pl_valid, rng=rng,
        )
        return pl_feature, pl_valid
