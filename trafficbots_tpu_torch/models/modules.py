"""Core building blocks as `nn.Module`s, masked for padded entities.

Counterpart of `trafficbots_tpu/models/modules.py`, eval side. Submodule and
parameter names follow the flax tree one for one (`fc0`, `ln0`, `q_proj`,
`norm_tgt`, `layer0`, `gru0`, ...), so `weights.load_jax_params` can walk
both trees by name; a flax `Dense` becomes an `nn.Linear` and a flax
`LayerNorm` an `nn.LayerNorm(eps=1e-5)`. Parameters the JAX package keeps as
raw arrays (the fused GRU cell, the stacked action-head branches) keep the
JAX layout and are used as `x @ w`.

Dropout is only live in training, which belongs to a later slice of the
port: these modules compute the eval forward pass.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels_enabled
from ..ops.fused_attention import attention_core_plain, fused_attention_core

Tensor = torch.Tensor


def activation(name: str):
    return {
        "relu": F.relu,
        # flax's nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "elu": F.elu,
        "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    }[name]


def layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-5)


class MLP(nn.Module):
    """Linear stack; the valid mask is applied to the last layer's
    pre-activation output, then the end activation runs on the masked
    tensor, so invalid rows hold act(fill_invalid), not 0."""

    def __init__(
        self,
        in_dim: int,
        fc_dims: Sequence[int],
        use_layernorm: bool = False,
        act: str = "relu",
        end_layer_activation: bool = True,
    ):
        super().__init__()
        self.n = len(fc_dims)
        self.use_layernorm = use_layernorm
        self.act = activation(act)
        self.end_layer_activation = end_layer_activation
        d = in_dim
        for i, dim in enumerate(fc_dims):
            self.add_module(f"fc{i}", nn.Linear(d, dim))
            if use_layernorm and (i < self.n - 1 or end_layer_activation):
                self.add_module(f"ln{i}", layer_norm(dim))
            d = dim

    def forward(self, x: Tensor, valid: Optional[Tensor] = None, fill_invalid: float = 0.0) -> Tensor:
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            is_last = i == self.n - 1
            if self.use_layernorm and (not is_last or self.end_layer_activation):
                x = getattr(self, f"ln{i}")(x)
            if not is_last:
                x = self.act(x)
        if valid is not None:
            x = torch.where(valid[..., None], x, torch.full_like(x, fill_invalid))
        if self.end_layer_activation:
            x = self.act(x)
        return x


def attention_invalid(
    B: int, S: int, T: int,
    tgt_padding_mask: Optional[Tensor],
    attn_mask: Optional[Tensor],
) -> Optional[Tensor]:
    """[B, S, T] True = disallowed target. A padding mask alone comes back
    as a stride-0 expand of [B, 1, T] and is never materialized."""
    invalid = None
    if tgt_padding_mask is not None:
        invalid = tgt_padding_mask[:, None, :].expand(B, S, T)
    if attn_mask is not None:
        am = attn_mask.expand(B, S, T)
        invalid = am if invalid is None else (invalid | am)
    return invalid


class Attention(nn.Module):
    """Multi-head attention with padded-target masking and the all-masked
    row guard: such rows run with the mask lifted and come out 0.

    The core `softmax(q kᵀ/√d_h) v` goes to the hand-written kernel
    (`ops.fused_attention.fused_attention_core`) at exactly the call sites
    where the JAX package routes to its Pallas kernel on a TPU: `allow_fused`,
    no weights requested, eval, S >= 32 and T >= 64 (and not inside
    `ops.plain_versions()`). On a CPU tensor that wrapper computes the plain
    version, so the two routes agree there.
    """

    def __init__(self, d_model: int, n_head: int, bias: bool = True):
        super().__init__()
        assert d_model % n_head == 0
        self.d_model = d_model
        self.n_head = n_head
        self.q_proj = nn.Linear(d_model, d_model, bias=bias)
        self.k_proj = nn.Linear(d_model, d_model, bias=bias)
        self.v_proj = nn.Linear(d_model, d_model, bias=bias)
        self.out_proj = nn.Linear(d_model, d_model, bias=bias)

    def forward(
        self,
        src: Tensor,  # [B, S, d]
        tgt: Optional[Tensor] = None,  # [B, T, d]; None = self-attention
        tgt_padding_mask: Optional[Tensor] = None,  # [B, T] True = invalid
        attn_mask: Optional[Tensor] = None,  # [B, S, T] True = disabled
        tgt_kv: Optional[Tuple[Tensor, Tensor]] = None,
        return_kv: bool = False,
        allow_fused: bool = True,
    ):
        if return_kv:
            kv_in = src if tgt is None else tgt
            return self.k_proj(kv_in), self.v_proj(kv_in)
        q = self.q_proj(src)
        if tgt_kv is not None:
            k, v = tgt_kv
        else:
            kv_in = src if tgt is None else tgt
            k, v = self.k_proj(kv_in), self.v_proj(kv_in)
        if k.ndim != 3:
            raise NotImplementedError("per-query (KNN) targets are not part of the ported slice")

        B, S = src.shape[:2]
        T = k.shape[1]
        invalid = attention_invalid(B, S, T, tgt_padding_mask, attn_mask)
        if invalid is None:
            invalid = torch.zeros((1, 1, T), dtype=torch.bool, device=q.device).expand(B, S, T)
        use_kernel = allow_fused and S >= 32 and T >= 64 and kernels_enabled()
        core = fused_attention_core if use_kernel else attention_core_plain
        out = self.out_proj(core(q, k, v, invalid, self.n_head))
        no_valid_tgt = invalid.all(dim=-1)
        return torch.where(no_valid_tgt[..., None], torch.zeros_like(out), out)


class TransformerCrossAttention(nn.Module):
    """One pre-norm cross-attention layer with a ReLU feed-forward."""

    def __init__(self, d_model: int, n_head: int, d_feedforward: int, act: str = "relu", bias: bool = True):
        super().__init__()
        self.act = activation(act)
        self.attn = Attention(d_model, n_head, bias=bias)
        self.norm1 = layer_norm(d_model)
        self.norm_tgt = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, d_feedforward)
        self.linear2 = nn.Linear(d_feedforward, d_model)

    def forward(
        self,
        src: Optional[Tensor],
        src_padding_mask: Optional[Tensor] = None,
        tgt: Optional[Tensor] = None,
        tgt_padding_mask: Optional[Tensor] = None,
        attn_mask: Optional[Tensor] = None,
        tgt_kv: Optional[Tuple[Tensor, Tensor]] = None,
        return_tgt_kv: bool = False,
        allow_fused: bool = True,
    ):
        if return_tgt_kv:
            return self.attn(self.norm_tgt(tgt), return_kv=True)
        if tgt is None and tgt_kv is None:
            tgt_padding_mask = src_padding_mask
        src2 = self.norm1(src)
        tgt_n = self.norm_tgt(tgt) if tgt is not None else None
        src2 = self.attn(
            src2, tgt=tgt_n, tgt_padding_mask=tgt_padding_mask, attn_mask=attn_mask,
            tgt_kv=tgt_kv, allow_fused=allow_fused,
        )
        src = src + src2
        src2 = self.linear2(self.act(self.linear1(self.norm2(src))))
        src = src + src2
        if src_padding_mask is not None:
            src = torch.where(src_padding_mask[..., None], torch.zeros_like(src), src)
        return src


class TransformerBlock(nn.Module):
    """Stack of `TransformerCrossAttention` layers `layer0..`. Every layer
    attends to the ORIGINAL `tgt` (k/v are not taken from the evolving src)."""

    def __init__(
        self,
        d_model: int,
        n_head: int,
        d_feedforward: int,
        n_layer: int = 1,
        activation: str = "relu",
        norm_first: bool = True,
        bias: bool = True,
        out_layernorm: bool = False,
        dropout_p: float = 0.0,
    ):
        super().__init__()
        if not norm_first or d_feedforward <= 0:
            raise NotImplementedError("only the pre-norm feed-forward layer is part of the ported slice")
        self.n_layer = n_layer
        for i in range(n_layer):
            self.add_module(
                f"layer{i}",
                TransformerCrossAttention(d_model, n_head, d_feedforward, activation, bias),
            )
        self.out_ln = layer_norm(d_model) if out_layernorm else None

    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.n_layer)]

    def forward(
        self,
        src: Optional[Tensor],
        src_padding_mask: Optional[Tensor] = None,
        tgt: Optional[Tensor] = None,
        tgt_padding_mask: Optional[Tensor] = None,
        attn_mask: Optional[Tensor] = None,
        tgt_kv=None,
        return_tgt_kv: bool = False,
        allow_fused: bool = True,
    ):
        if return_tgt_kv:
            return tuple(l(None, tgt=tgt, return_tgt_kv=True) for l in self.layers())
        for i, layer in enumerate(self.layers()):
            src = layer(
                src, src_padding_mask=src_padding_mask, tgt=tgt,
                tgt_padding_mask=tgt_padding_mask, attn_mask=attn_mask,
                tgt_kv=None if tgt_kv is None else tgt_kv[i], allow_fused=allow_fused,
            )
        if self.out_ln is not None:
            src = self.out_ln(src)
        return src


def tf_block_kwargs(tf_cfg) -> dict:
    return dict(
        d_model=tf_cfg.d_model, n_head=tf_cfg.n_head, d_feedforward=tf_cfg.d_feedforward,
        activation=tf_cfg.activation, norm_first=tf_cfg.norm_first, bias=tf_cfg.bias,
        out_layernorm=tf_cfg.out_layernorm,
    )


class InputPeEncoder(nn.Module):
    """Attribute MLP combined with the pose PE ("input", "cat" or "add")."""

    def __init__(
        self, attr_dim: int, hidden_dim: int, pe_dim: int, n_layer: int = 2,
        mlp_use_layernorm: bool = False, pe_mode: str = "cat",
    ):
        super().__init__()
        self.pe_mode = pe_mode
        if pe_mode == "input":
            in_dim, out_dim = attr_dim + pe_dim, hidden_dim
        elif pe_mode == "cat":
            in_dim, out_dim = attr_dim, hidden_dim - pe_dim
            assert out_dim >= 32
        elif pe_mode == "add":
            assert pe_dim == hidden_dim
            in_dim, out_dim = attr_dim, hidden_dim
        else:
            raise NotImplementedError(pe_mode)
        self.mlp = MLP(
            in_dim, [out_dim] * n_layer, use_layernorm=mlp_use_layernorm, end_layer_activation=False
        )

    def forward(self, valid: Tensor, attr: Tensor, pe: Tensor) -> Tensor:
        if self.pe_mode == "input":
            x = self.mlp(torch.cat([attr, pe], dim=-1))
        elif self.pe_mode == "cat":
            x = torch.cat([self.mlp(attr), pe], dim=-1)
        else:
            x = self.mlp(attr) + pe
        return torch.where(valid[..., None], x, torch.zeros_like(x))


def temporal_aggregate(x: Tensor, valid: Tensor, mode: str) -> Tuple[Tensor, Tensor]:
    """Aggregate [B, T, A, D] over T -> ([B, A, D], [B, A])."""
    if mode == "max":
        agg = x.amax(dim=1)
    elif mode == "last":
        agg = x[:, -1]
    elif mode == "max_valid":
        agg = torch.where(valid[..., None], x, torch.full_like(x, -1e3)).amax(dim=1)
    elif mode == "last_valid":
        n_step = valid.shape[1]
        # argmax over a bool/int tensor takes the first maximum, like jnp.argmax
        idx = n_step - 1 - torch.argmax(valid.flip(1).to(torch.int32), dim=1)  # [B, A]
        agg = torch.gather(x, 1, idx[:, None, :, None].expand(-1, 1, -1, x.shape[-1]))[:, 0]
    elif mode == "mean_valid":
        denom = valid.sum(dim=1).to(x.dtype) + torch.finfo(x.dtype).eps
        agg = x.sum(dim=1) / denom[..., None]
    else:
        raise NotImplementedError(mode)
    valid_agg = valid.any(dim=1)
    return torch.where(valid_agg[..., None], agg, torch.zeros_like(agg)), valid_agg


class FusedGRUCell(nn.Module):
    """GRU cell with gate-fused weights in the JAX layout: gi = x @ w_i + b_i,
    gh = h @ w_h, gates (r, z, n); the hidden bias `b_hn` sits inside the
    r * (...) product, as in torch.nn.GRUCell."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        self.w_i = nn.Parameter(torch.empty(in_dim, 3 * H))
        self.w_h = nn.Parameter(torch.empty(H, 3 * H))
        self.b_i = nn.Parameter(torch.zeros(3 * H))
        self.b_hn = nn.Parameter(torch.zeros(H))

    def forward(self, h: Tensor, x: Tensor) -> Tensor:
        H = self.hidden_dim
        gi = x @ self.w_i + self.b_i
        gh = h @ self.w_h
        r = torch.sigmoid(gi[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi[..., H : 2 * H] + gh[..., H : 2 * H])
        n = torch.tanh(gi[..., 2 * H :] + r * (gh[..., 2 * H :] + self.b_hn))
        return (1.0 - z) * n + z * h


class StackedGRU(nn.Module):
    """`num_layers` GRU cells over (batch, agent) rows; the hidden state and
    the output are zeroed for invalid agents after every step ("gru_loop").
    Single-step: x [B, A, D], valid [B, A], h [L, B, A, H]. Sequence: x
    [B, T, A, D], valid [B, T, A], looped over T."""

    def __init__(self, hidden_dim: int, num_layers: int = 3, kind: str = "gru_loop", in_dim: Optional[int] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.kind = kind
        if kind == "dummy":
            return
        for i in range(num_layers):
            d_in = (in_dim or hidden_dim) if i == 0 else hidden_dim
            self.add_module(f"gru{i}", FusedGRUCell(d_in, hidden_dim))

    def init_hidden(self, batch_shape, device=None) -> Tensor:
        return torch.zeros((self.num_layers, *batch_shape, self.hidden_dim), device=device)

    def step(self, x: Tensor, valid: Tensor, h: Tensor) -> Tuple[Tensor, Tensor]:
        if self.kind == "dummy":
            return torch.where(valid[..., None], x, torch.zeros_like(x)), h
        hs = []
        inp = x
        for i in range(self.num_layers):
            inp = getattr(self, f"gru{i}")(h[i], inp)
            hs.append(inp)
        h_new = torch.stack(hs, dim=0)
        if self.kind == "gru_unmasked":
            return inp, h_new
        invalid = ~valid[..., None]
        h_new = torch.where(invalid[None], torch.zeros_like(h_new), h_new)
        y = torch.where(invalid, torch.zeros_like(inp), inp)
        return y, h_new

    def forward(self, x: Tensor, valid: Tensor, h: Optional[Tensor] = None):
        if valid.ndim == 2:
            if h is None:
                h = self.init_hidden(valid.shape, x.device)
            return self.step(x, valid, h)
        B, T, A = valid.shape
        if h is None:
            h = self.init_hidden((B, A), x.device)
        ys = []
        for t in range(T):
            y, h = self.step(x[:, t], valid[:, t], h)
            ys.append(y)
        return torch.stack(ys, dim=1), None


class MultiAgentTF(nn.Module):
    """Self-attention among agents at one step (or per step of a sequence).
    Rows with exactly one valid agent keep the raw input when the self-agent
    mask is on."""

    def __init__(
        self, hidden_dim: int, n_layer: int = 3, mask_self_agent: bool = True,
        detach_tgt: bool = False, attn_to_map_aware_feature: bool = True, tf_kwargs: dict = None,
    ):
        super().__init__()
        self.mask_self_agent = mask_self_agent
        self.attn_to_map_aware_feature = attn_to_map_aware_feature
        self.tf = TransformerBlock(d_model=hidden_dim, n_layer=n_layer, **(tf_kwargs or {}))

    def forward(self, feature_map_aware: Tensor, feature: Tensor, valid: Tensor, allow_fused: bool = True):
        seq = valid.ndim == 3
        if seq:
            B, T, A = valid.shape
            fma = feature_map_aware.reshape(B * T, A, -1)
            f = feature.reshape(B * T, A, -1)
            v = valid.reshape(B * T, A)
        else:
            fma, f, v = feature_map_aware, feature, valid
            A = v.shape[-1]
        x = fma
        tgt = fma if self.attn_to_map_aware_feature else f
        attn_mask = torch.eye(A, dtype=torch.bool, device=x.device)[None] if self.mask_self_agent else None
        out = self.tf(
            x, src_padding_mask=~v, tgt=tgt, tgt_padding_mask=~v, attn_mask=attn_mask,
            allow_fused=allow_fused,
        )
        if self.mask_self_agent:
            single = v.sum(dim=-1) == 1
            out = torch.where(single[:, None, None], x, out)
        if seq:
            out = out.reshape(B, T, A, -1)
        return out


class AddLatentGoal(nn.Module):
    """Inject a latent/goal feature z into the policy feature x."""

    def __init__(
        self, hidden_dim: int, in_dim: int, dummy: bool = False, mode: str = "cat",
        res_cat: bool = False, res_add: bool = True, n_layer_mlp_in: int = 2,
        n_layer_mlp_out: int = 2, mlp_in_use_layernorm: bool = False,
        mlp_out_use_layernorm: bool = False,
    ):
        super().__init__()
        self.dummy = dummy
        self.mode = mode
        self.res_cat = res_cat
        self.res_add = res_add
        if dummy:
            return
        self.mlp_in = MLP(in_dim, [hidden_dim] * n_layer_mlp_in, use_layernorm=mlp_in_use_layernorm)
        out_in = 2 * hidden_dim if mode == "cat" else hidden_dim
        self.mlp_out = MLP(out_in, [hidden_dim] * n_layer_mlp_out, use_layernorm=mlp_out_use_layernorm)
        if res_cat:
            self.mlp_res_cat = MLP(
                3 * hidden_dim, [hidden_dim] * n_layer_mlp_out, use_layernorm=mlp_out_use_layernorm
            )

    def precompute_z(self, z: Tensor, z_valid: Tensor) -> Tensor:
        """The z-side input MLP; z is constant over a rollout, so the eval
        rollout runs it once per episode."""
        return self.mlp_in(z, z_valid)

    def forward(self, x, x_valid, z, z_valid, z_pre: Optional[Tensor] = None) -> Tensor:
        if self.dummy:
            return torch.where(x_valid[..., None], x, torch.zeros_like(x))
        z = z_pre if z_pre is not None else self.precompute_z(z, z_valid)
        if self.mode == "add":
            h = x + z
        elif self.mode == "mul":
            h = x * z
        else:
            h = torch.cat([x, z], dim=-1)
        h = self.mlp_out(h)
        if self.res_cat:
            h = self.mlp_res_cat(torch.cat([x, h, z], dim=-1))
        zv = z_valid[..., None]
        h = torch.where(zv, h, torch.zeros_like(h))
        if self.res_add:
            h = h + x
        else:
            h = h + torch.where(zv, torch.zeros_like(x), x)
        return torch.where(x_valid[..., None], h, torch.zeros_like(h))


class ActionHead(nn.Module):
    """DiagGaussian action head: three per-type 2-layer branches stacked on
    a leading axis of 3 and summed under the agent-type one-hot, with a
    per-type learned log_std."""

    def __init__(
        self, hidden_dim: int, action_dim: int = 2, use_layernorm: bool = False,
        log_std_init: Optional[float] = -2.0, branch_type: bool = True,
    ):
        super().__init__()
        if not branch_type or use_layernorm or log_std_init is None:
            raise NotImplementedError(
                "the ported action head is the default stacked-branch head with a fixed-init log_std"
            )
        D, H = hidden_dim, hidden_dim
        self.mlp_mean_w0 = nn.Parameter(torch.empty(3, D, H))
        self.mlp_mean_b0 = nn.Parameter(torch.zeros(3, H))
        self.mlp_mean_w1 = nn.Parameter(torch.empty(3, H, action_dim))
        self.mlp_mean_b1 = nn.Parameter(torch.zeros(3, action_dim))
        self.log_std = nn.Parameter(torch.full((3, action_dim), float(log_std_init)))

    def forward(self, x: Tensor, valid: Tensor, agent_type: Tensor) -> Tuple[Tensor, Tensor]:
        mask_type = (agent_type & valid[..., None]).to(x.dtype)  # [B, A, 3]
        h = F.relu(torch.einsum("...d,tdh->...th", x, self.mlp_mean_w0) + self.mlp_mean_b0)
        out = torch.einsum("...th,the->...te", h, self.mlp_mean_w1) + self.mlp_mean_b1
        mean = torch.einsum("...te,...t->...e", out, mask_type)
        log_std = torch.einsum("bat,td->bad", mask_type, self.log_std)
        return mean, log_std
