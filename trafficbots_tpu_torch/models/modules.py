"""Core building blocks as `nn.Module`s, masked for padded entities.

Counterpart of `trafficbots_tpu/models/modules.py`, eval side. Submodule and
parameter names follow the flax tree one for one (`fc0`, `ln0`, `q_proj`,
`norm_tgt`, `layer0`, `gru0`, ...), so `weights.load_jax_params` can walk
both trees by name; a flax `Dense` becomes an `nn.Linear` and a flax
`LayerNorm` an `nn.LayerNorm(eps=1e-5)`. Parameters the JAX package keeps as
raw arrays (the fused GRU cell, the stacked action-head branches) keep the
JAX layout and are used as `x @ w`.

Dropout is live when a forward gets `rng` (an `ops.dropout.DropoutSeeds`):
that is training. Each module call draws one seed from it and numbers its
dropout sites, so every mask comes from the port's Philox (`ops.dropout`),
at the sites where the JAX modules apply flax `nn.Dropout`. `rng=None` is
the eval forward pass (deterministic).

Compute dtype (`dtype`, bf16 under `precision="bf16"`): the modules that
take one in the JAX package (`MLP`, `Attention`, the transformer layers,
`InputPeEncoder`, `MultiAgentTF`) compute their products as a flax
`nn.Dense(dtype=bf16)` and a bf16 einsum do there, as XLA runs them on the
CPU: the operands of every product rounded to bf16, fp32 accumulation, the
product rounded to bf16 (`lowp_matmul`); the elementwise work around it
(bias adds, activations, masks, LayerNorm, softmax) in fp32, the values
carried in fp32 tensors. XLA computes a chain of bf16 elementwise ops in
fp32 and rounds only where a bf16 value feeds a product or is stored
(excess precision), so the port rounds exactly there. The parameters stay
fp32; the rest of the model (`FusedGRUCell`, `StackedGRU`, `AddLatentGoal`,
`ActionHead`) is fp32 whatever the compute dtype, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels_enabled, round_to
from ..ops.attention_train import attention_train, attention_train_plain
from ..ops.dropout import DropoutSeeds, dropout, dropout_add, dropout_plain, relu_dropout
from ..ops.fused_attention import attention_core_plain, fused_attention_core

Tensor = torch.Tensor
F32 = torch.float32


def lowp_matmul(a: Tensor, b: Tensor, dtype: torch.dtype) -> Tensor:
    """a @ b as XLA computes a `dtype` (bf16) dot, held in fp32: operands
    rounded to bf16, fp32 accumulation, the product rounded to bf16. On the
    card cuBLAS's bf16 GEMM (its reduction kept in fp32 by
    `orchestration.resolve_device`); on the CPU the fp32 product of the
    rounded operands, rounded once (torch's CPU bf16 matmul rounds some sums
    differently from XLA's)."""
    if a.is_cuda:
        return (a.to(dtype) @ b.to(dtype)).to(F32)
    return (round_to(a, dtype) @ round_to(b, dtype)).to(dtype).to(F32)


def xla_cpu_sum(x: Tensor, n_lead: int, window: int = 32) -> Tensor:
    """The sum of x (bf16 values held in fp32) over its `n_lead` leading
    dims as XLA's CPU backend sums a bf16 tensor: where a reduced dim is
    longer than `window`, a reduce-window of min(dim, window) a dim first
    (the padding split low = total // 2, high = the rest), then the
    windows' results summed the same way; each window's elements summed in
    row-major order with every partial sum rounded to bf16."""
    shape, rest = tuple(x.shape[:n_lead]), tuple(x.shape[n_lead:])
    ws = [min(n, window) for n in shape]
    outs = [-(-n // w) for n, w in zip(shape, ws)]
    if all(o == 1 for o in outs):
        acc = torch.zeros(rest, dtype=x.dtype, device=x.device)
        for row in x.reshape(-1, *rest):
            acc = round_to(acc + row, torch.bfloat16)
        return acc
    pad = []
    for n, w, o in reversed(list(zip(shape, ws, outs))):
        t = o * w - n
        pad += [t // 2, t - t // 2]
    x = F.pad(x.reshape(*shape, -1).movedim(-1, 0), pad).movedim(0, -1)  # pads the leading dims
    x = x.reshape([d for o, w in zip(outs, ws) for d in (o, w)] + [-1])
    x = x.permute(*[2 * i + 1 for i in range(n_lead)], *[2 * i for i in range(n_lead)], 2 * n_lead)
    acc = torch.zeros(x.shape[n_lead:], dtype=x.dtype, device=x.device)
    for blk in x.reshape(-1, *x.shape[n_lead:]):
        acc = round_to(acc + blk, torch.bfloat16)
    return xla_cpu_sum(acc.reshape(*outs, *rest), n_lead, window)


class _LowpBias(torch.autograd.Function):
    """y + b for a bf16 Dense's bias b (bf16 values held in fp32). The
    gradient of b sums the bf16 cotangent over the leading dims: on the CPU
    as XLA's CPU backend does (`xla_cpu_sum`: the JAX package's tests run
    there), on the card in one fp32 sum (as XLA on a TPU accumulates bf16
    reductions), rounded to bf16 either way."""

    @staticmethod
    def forward(ctx, y: Tensor, b: Tensor) -> Tensor:
        return y + b

    @staticmethod
    def backward(ctx, g: Tensor):
        g16 = round_to(g, torch.bfloat16)
        n_lead = g.ndim - 1
        db = g16.reshape(-1, g.shape[-1]).sum(0) if g.is_cuda else xla_cpu_sum(g16, n_lead)
        return g, round_to(db, torch.bfloat16)


def add_lowp_bias(y: Tensor, b: Tensor, dtype: torch.dtype) -> Tensor:
    """y + b rounded to `dtype`, the sum kept in fp32 (see `_LowpBias`)."""
    return _LowpBias.apply(y, round_to(b, dtype))


def linear(x: Tensor, lin: nn.Linear, dtype: torch.dtype = F32) -> Tensor:
    """A flax `nn.Dense(dtype=dtype)` through an `nn.Linear`'s parameters:
    `lin(x)` in fp32; in bf16 the product on bf16 operands rounded to bf16
    plus the bias rounded to bf16, the sum kept in fp32 (see the module
    docstring)."""
    if dtype == F32:
        return lin(x)
    y = lowp_matmul(x, lin.weight.t(), dtype)
    return y if lin.bias is None else add_lowp_bias(y, lin.bias, dtype)


def draw_seed(rng: Optional[DropoutSeeds], p: float) -> Optional[int]:
    """One seed for a module call's dropout sites, None when none is live."""
    return rng.next() if rng is not None and p > 0 else None


def maybe_dropout(x: Tensor, p: float, seed: Optional[int], site: int) -> Tensor:
    """Dropout at a module's site: the K5 wrapper, or inside
    `ops.plain_versions()` its plain version."""
    if seed is None:
        return x
    return (dropout if kernels_enabled() else dropout_plain)(x, p, seed, site)


def lowp_dropout(x: Tensor, p: float, seed: Optional[int], site: int, dtype: torch.dtype) -> Tensor:
    """flax `nn.Dropout` on a bf16-typed input: the same keep mask as
    `maybe_dropout` at the site, kept elements divided by 1 - p rounded to
    bf16 (JAX's `inputs / keep_prob` takes the Python float as a bf16
    scalar), in fp32."""
    if seed is None or dtype == F32:
        return maybe_dropout(x, p, seed, site)
    keep = maybe_dropout(torch.ones_like(x), p, seed, site) != 0
    return torch.where(keep, x / round_to(torch.tensor(1.0 - p), dtype).item(), torch.zeros_like(x))


def add_dropout(res: Tensor, x: Tensor, p: float, seed: Optional[int], site: int) -> Tensor:
    """res + dropout(x) at a module's site: the fused K5 entry (one launch),
    or inside `ops.plain_versions()` the plain composition."""
    if seed is not None and kernels_enabled():
        return dropout_add(res, x, p, seed, site)
    return res + maybe_dropout(x, p, seed, site)


def dropout_relu(x: Tensor, p: float, seed: Optional[int], site: int, relu_first: bool) -> Tensor:
    """ReLU and dropout at a module's site, in the JAX module's order (the
    two orders agree value for value: the scale is positive): the fused K5
    entry (one launch), or inside `ops.plain_versions()` the plain
    composition in that order."""
    if seed is not None and kernels_enabled():
        return relu_dropout(x, p, seed, site)
    if relu_first:
        return maybe_dropout(F.relu(x), p, seed, site)
    return F.relu(maybe_dropout(x, p, seed, site))


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
    tensor, so invalid rows hold act(fill_invalid), not 0. Dropout (site i)
    follows layer i's LayerNorm wherever the JAX MLP has one; where a ReLU
    follows it at once (every layer but the last) the two are one K5 launch.

    `x` may be a pair (src, tgt) of broadcast-compatible tensors standing
    for concat([broadcast(src), broadcast(tgt)], -1): the first layer then
    runs factored, src @ W_src + tgt @ W_tgt + b, as the JAX `_PairDense`
    does, and the concat never materializes.

    In bf16 (`dtype`) each layer is `linear`'s; a dropout site that no
    LayerNorm precedes sees a bf16-typed value (`lowp_dropout`)."""

    def __init__(
        self,
        in_dim: int,
        fc_dims: Sequence[int],
        use_layernorm: bool = False,
        act: str = "relu",
        end_layer_activation: bool = True,
        dropout_p: float = 0.0,
        dtype: torch.dtype = F32,
    ):
        super().__init__()
        self.n = len(fc_dims)
        self.dtype = dtype
        self.use_layernorm = use_layernorm
        self.act = activation(act)
        self.relu = act == "relu"
        self.end_layer_activation = end_layer_activation
        self.dropout_p = dropout_p
        d = in_dim
        for i, dim in enumerate(fc_dims):
            self.add_module(f"fc{i}", nn.Linear(d, dim))
            if use_layernorm and (i < self.n - 1 or end_layer_activation):
                self.add_module(f"ln{i}", layer_norm(dim))
            d = dim

    def forward(
        self, x, valid: Optional[Tensor] = None, fill_invalid: float = 0.0,
        rng: Optional[DropoutSeeds] = None,
    ) -> Tensor:
        seed = draw_seed(rng, self.dropout_p)
        dt = self.dtype
        for i in range(self.n):
            fc = getattr(self, f"fc{i}")
            if i == 0 and isinstance(x, tuple):
                src, tgt = x
                d_src = src.shape[-1]
                if dt == F32:
                    x = F.linear(src, fc.weight[:, :d_src]) + F.linear(tgt, fc.weight[:, d_src:]) + fc.bias
                else:
                    x = add_lowp_bias(lowp_matmul(src, fc.weight[:, :d_src].t(), dt)
                                      + lowp_matmul(tgt, fc.weight[:, d_src:].t(), dt), fc.bias, dt)
            else:
                x = linear(x, fc, dt)
            is_last = i == self.n - 1
            if self.use_layernorm and (not is_last or self.end_layer_activation):
                x = getattr(self, f"ln{i}")(x)
            if dt != F32 and not self.use_layernorm and (not is_last or self.end_layer_activation):
                x = lowp_dropout(x, self.dropout_p, seed, i, dt)
                if not is_last:
                    x = self.act(x)
            elif not is_last and self.relu:
                x = dropout_relu(x, self.dropout_p, seed, i, relu_first=False)
            elif not is_last:
                x = self.act(maybe_dropout(x, self.dropout_p, seed, i))
            elif self.end_layer_activation:
                x = maybe_dropout(x, self.dropout_p, seed, i)
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

    The core `softmax(q kᵀ/√d_h) v` goes to a hand-written kernel at exactly
    the call sites where the JAX package routes to a Pallas kernel on a TPU
    (and not inside `ops.plain_versions()`): in eval (`rng` None) to
    `ops.fused_attention.fused_attention_core` when `allow_fused`, S >= 32
    and T >= 64; in training to `ops.attention_train.attention_train`, with
    the weights' dropout, when `allow_fused`, S >= 32 and T >= 256. On CPU
    tensors those wrappers compute their plain versions, so the routes
    agree there. Training attention elsewhere is the plain version, its
    weights' dropout drawn by the K5 entry (`ops.dropout.dropout`).

    `need_weights` returns (out, weights): the attention probabilities
    averaged over the heads [B, S, T] (after their dropout in training),
    zeroed on rows with no valid target. It takes the plain core, as the
    JAX package leaves its kernels when the weights are asked for.

    In bf16 (`dtype`) the projections are `linear`'s, and the core computes
    what the JAX package computes at the site, chosen by the shape alone
    (the kernel and its plain version compute one function): at an eval
    kernel site K1's bf16 variant on bf16 q/k/v (fp32 logits and softmax,
    the weights rounded to bf16, a bf16 output: the Pallas `_attn_kernel`);
    at a training kernel site K3 on q/k/v widened to fp32, as the JAX
    package widens them; elsewhere its XLA einsums on bf16 operands
    (`attention_train_plain(lowp=...)`).
    """

    def __init__(self, d_model: int, n_head: int, bias: bool = True, dropout_p: float = 0.0, dtype: torch.dtype = F32):
        super().__init__()
        assert d_model % n_head == 0
        self.d_model = d_model
        self.n_head = n_head
        self.dropout_p = dropout_p
        self.dtype = dtype
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
        rng: Optional[DropoutSeeds] = None,
        need_weights: bool = False,
    ):
        dt = self.dtype
        lowp = None if dt == F32 else dt
        if return_kv:
            kv_in = src if tgt is None else tgt
            return linear(kv_in, self.k_proj, dt), linear(kv_in, self.v_proj, dt)
        q = linear(src, self.q_proj, dt)
        if tgt_kv is not None:
            k, v = tgt_kv
        else:
            kv_in = src if tgt is None else tgt
            k, v = linear(kv_in, self.k_proj, dt), linear(kv_in, self.v_proj, dt)
        if k.ndim != 3:
            raise NotImplementedError("per-query (KNN) targets are not part of the ported slice")

        B, S = src.shape[:2]
        T = k.shape[1]
        invalid = attention_invalid(B, S, T, tgt_padding_mask, attn_mask)
        if invalid is None:
            invalid = torch.zeros((1, 1, T), dtype=torch.bool, device=q.device).expand(B, S, T)
        no_valid_tgt = invalid.all(dim=-1)
        if need_weights:
            seed = draw_seed(rng, self.dropout_p)
            p, seed = (self.dropout_p, seed) if seed is not None else (0.0, 0)
            drop = dropout if kernels_enabled() else dropout_plain
            core, w = attention_train_plain(q, k.to(q.dtype), v.to(q.dtype), invalid, self.n_head, p, seed, 0,
                                            dropout=drop, need_weights=True, lowp=lowp)
            out = linear(core, self.out_proj, dt)
            zero = no_valid_tgt[..., None]
            return torch.where(zero, torch.zeros_like(out), out), torch.where(zero, 0.0, w.mean(dim=1))
        if rng is None:
            kernel_site = allow_fused and S >= 32 and T >= 64
            if lowp is None or kernel_site:
                core = fused_attention_core if kernel_site and kernels_enabled() else attention_core_plain
                if lowp is not None:
                    q, k, v = q.to(lowp), k.to(lowp), v.to(lowp)
                core = core(q, k, v, invalid, self.n_head)
            else:
                core = attention_train_plain(q, k, v, invalid, self.n_head, 0.0, 0, 0, lowp=lowp)
            out = linear(core, self.out_proj, dt)
        else:
            seed = draw_seed(rng, self.dropout_p)
            p, seed = (self.dropout_p, seed) if seed is not None else (0.0, 0)
            kernel_site = allow_fused and S >= 32 and T >= 256
            if kernel_site:  # the JAX package widens bf16 q/k/v for its training kernel
                q, k, v, lowp = q.to(F32), k.to(F32), v.to(F32), None
            if kernel_site and kernels_enabled():
                core = attention_train(q, k, v, invalid, self.n_head, p, seed, 0, saved=rng.saved_cores)
            else:
                drop = dropout if kernels_enabled() else dropout_plain
                core = attention_train_plain(q, k, v, invalid, self.n_head, p, seed, 0, dropout=drop, lowp=lowp)
            out = linear(core, self.out_proj, dt)
        return torch.where(no_valid_tgt[..., None], torch.zeros_like(out), out)


class TransformerCrossAttention(nn.Module):
    """One pre-norm cross-attention layer with a ReLU feed-forward; dropout
    on the attention weights (inside `attn`), after the attention block
    (site 0), after the feed-forward activation (1) and after its output (2).
    Each site is one K5 launch with its neighbour: the residual add (0, 2),
    the ReLU (1). `need_weights` returns (src, the attention's head-averaged
    weights, zeroed on padded source rows)."""

    def __init__(
        self, d_model: int, n_head: int, d_feedforward: int, act: str = "relu", bias: bool = True,
        dropout_p: float = 0.0, dtype: torch.dtype = F32,
    ):
        super().__init__()
        self.act = activation(act)
        self.relu = act == "relu"
        self.dropout_p = dropout_p
        self.dtype = dtype
        self.attn = Attention(d_model, n_head, bias=bias, dropout_p=dropout_p, dtype=dtype)
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
        rng: Optional[DropoutSeeds] = None,
        need_weights: bool = False,
    ):
        if return_tgt_kv:
            return self.attn(self.norm_tgt(tgt), return_kv=True)
        if tgt is None and tgt_kv is None:
            tgt_padding_mask = src_padding_mask
        src2 = self.norm1(src)
        tgt_n = self.norm_tgt(tgt) if tgt is not None else None
        src2 = self.attn(
            src2, tgt=tgt_n, tgt_padding_mask=tgt_padding_mask, attn_mask=attn_mask,
            tgt_kv=tgt_kv, allow_fused=allow_fused, rng=rng, need_weights=need_weights,
        )
        if need_weights:
            src2, weights = src2
        seed, p, dt = draw_seed(rng, self.dropout_p), self.dropout_p, self.dtype
        src = add_dropout(src, src2, p, seed, 0)
        src2 = linear(self.norm2(src), self.linear1, dt)
        if dt != F32:  # the feed-forward's hidden is bf16-typed
            src2 = lowp_dropout(self.act(src2), p, seed, 1, dt)
        elif self.relu:
            src2 = dropout_relu(src2, p, seed, 1, relu_first=True)
        else:
            src2 = maybe_dropout(self.act(src2), p, seed, 1)
        src = add_dropout(src, linear(src2, self.linear2, dt), p, seed, 2)
        if src_padding_mask is not None:
            src = torch.where(src_padding_mask[..., None], torch.zeros_like(src), src)
        if not need_weights:
            return src
        if src_padding_mask is not None:
            weights = torch.where(src_padding_mask[..., None], 0.0, weights)
        return src, weights


class TransformerBlock(nn.Module):
    """Stack of `TransformerCrossAttention` layers `layer0..`. Every layer
    attends to the ORIGINAL `tgt` (k/v are not taken from the evolving src).
    `need_weights` returns (src, the last layer's attention weights)."""

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
        dtype: torch.dtype = F32,
    ):
        super().__init__()
        if not norm_first or d_feedforward <= 0:
            raise NotImplementedError("only the pre-norm feed-forward layer is part of the ported slice")
        self.n_layer = n_layer
        for i in range(n_layer):
            self.add_module(
                f"layer{i}",
                TransformerCrossAttention(d_model, n_head, d_feedforward, activation, bias, dropout_p, dtype),
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
        rng: Optional[DropoutSeeds] = None,
        need_weights: bool = False,
    ):
        if return_tgt_kv:
            return tuple(l(None, tgt=tgt, return_tgt_kv=True) for l in self.layers())
        weights = None
        for i, layer in enumerate(self.layers()):
            src = layer(
                src, src_padding_mask=src_padding_mask, tgt=tgt,
                tgt_padding_mask=tgt_padding_mask, attn_mask=attn_mask,
                tgt_kv=None if tgt_kv is None else tgt_kv[i], allow_fused=allow_fused, rng=rng,
                need_weights=need_weights,
            )
            if need_weights:
                src, weights = src
        if self.out_ln is not None:
            src = self.out_ln(src)
        return (src, weights) if need_weights else src


def tf_block_kwargs(tf_cfg) -> dict:
    return dict(
        d_model=tf_cfg.d_model, n_head=tf_cfg.n_head, d_feedforward=tf_cfg.d_feedforward,
        activation=tf_cfg.activation, norm_first=tf_cfg.norm_first, bias=tf_cfg.bias,
        out_layernorm=tf_cfg.out_layernorm, dropout_p=tf_cfg.dropout_p,
    )


class InputPeEncoder(nn.Module):
    """Attribute MLP combined with the pose PE ("input", "cat" or "add")."""

    def __init__(
        self, attr_dim: int, hidden_dim: int, pe_dim: int, n_layer: int = 2,
        mlp_use_layernorm: bool = False, pe_mode: str = "cat", mlp_dropout_p: float = 0.0,
        dtype: torch.dtype = F32,
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
            in_dim, [out_dim] * n_layer, use_layernorm=mlp_use_layernorm, end_layer_activation=False,
            dropout_p=mlp_dropout_p, dtype=dtype,
        )

    def forward(self, valid: Tensor, attr: Tensor, pe: Tensor, rng: Optional[DropoutSeeds] = None) -> Tensor:
        if self.pe_mode == "input":
            x = self.mlp(torch.cat([attr, pe], dim=-1), rng=rng)
        elif self.pe_mode == "cat":
            x = torch.cat([self.mlp(attr, rng=rng), pe], dim=-1)
        else:
            x = self.mlp(attr, rng=rng) + pe
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
    [B, T, A, D], valid [B, T, A], looped over T. Dropout between layers
    (site i after layer i), a seed per step."""

    def __init__(
        self, hidden_dim: int, num_layers: int = 3, kind: str = "gru_loop", in_dim: Optional[int] = None,
        dropout_p: float = 0.0,
    ):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.kind = kind
        self.dropout_p = dropout_p
        if kind == "dummy":
            return
        for i in range(num_layers):
            d_in = (in_dim or hidden_dim) if i == 0 else hidden_dim
            self.add_module(f"gru{i}", FusedGRUCell(d_in, hidden_dim))

    def init_hidden(self, batch_shape, device=None) -> Tensor:
        return torch.zeros((self.num_layers, *batch_shape, self.hidden_dim), device=device)

    def step(self, x: Tensor, valid: Tensor, h: Tensor, rng: Optional[DropoutSeeds] = None) -> Tuple[Tensor, Tensor]:
        if self.kind == "dummy":
            return torch.where(valid[..., None], x, torch.zeros_like(x)), h
        seed = draw_seed(rng, self.dropout_p)
        hs = []
        inp = x
        for i in range(self.num_layers):
            h_i = getattr(self, f"gru{i}")(h[i], inp)
            hs.append(h_i)
            inp = h_i if i + 1 == self.num_layers else maybe_dropout(h_i, self.dropout_p, seed, i)
        h_new = torch.stack(hs, dim=0)
        if self.kind == "gru_unmasked":
            return inp, h_new
        invalid = ~valid[..., None]
        h_new = torch.where(invalid[None], torch.zeros_like(h_new), h_new)
        y = torch.where(invalid, torch.zeros_like(inp), inp)
        return y, h_new

    def forward(self, x: Tensor, valid: Tensor, h: Optional[Tensor] = None, rng: Optional[DropoutSeeds] = None):
        if valid.ndim == 2:
            if h is None:
                h = self.init_hidden(valid.shape, x.device)
            return self.step(x, valid, h, rng)
        B, T, A = valid.shape
        if h is None:
            h = self.init_hidden((B, A), x.device)
        ys = []
        for t in range(T):
            y, h = self.step(x[:, t], valid[:, t], h, rng)
            ys.append(y)
        return torch.stack(ys, dim=1), None


class MultiAgentTF(nn.Module):
    """Self-attention among agents at one step (or per step of a sequence).
    Rows with exactly one valid agent keep the raw input when the self-agent
    mask is on. `need_weights` returns (out, the last layer's attention
    weights [..., A, A], 0 on those rows)."""

    def __init__(
        self, hidden_dim: int, n_layer: int = 3, mask_self_agent: bool = True,
        detach_tgt: bool = False, attn_to_map_aware_feature: bool = True, tf_kwargs: dict = None,
        dtype: torch.dtype = F32,
    ):
        super().__init__()
        self.mask_self_agent = mask_self_agent
        self.attn_to_map_aware_feature = attn_to_map_aware_feature
        self.tf = TransformerBlock(d_model=hidden_dim, n_layer=n_layer, dtype=dtype, **(tf_kwargs or {}))

    def forward(
        self, feature_map_aware: Tensor, feature: Tensor, valid: Tensor, allow_fused: bool = True,
        rng: Optional[DropoutSeeds] = None, need_weights: bool = False,
    ):
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
            allow_fused=allow_fused, rng=rng, need_weights=need_weights,
        )
        if need_weights:
            out, w = out
        if self.mask_self_agent:
            single = v.sum(dim=-1) == 1
            out = torch.where(single[:, None, None], x, out)
            if need_weights:
                w = torch.where(single[:, None, None], 0.0, w)
        if seq:
            out = out.reshape(B, T, A, -1)
            if need_weights:
                w = w.reshape(B, T, A, A)
        return (out, w) if need_weights else out


class AddLatentGoal(nn.Module):
    """Inject a latent/goal feature z into the policy feature x."""

    def __init__(
        self, hidden_dim: int, in_dim: int, dummy: bool = False, mode: str = "cat",
        res_cat: bool = False, res_add: bool = True, n_layer_mlp_in: int = 2,
        n_layer_mlp_out: int = 2, mlp_in_use_layernorm: bool = False,
        mlp_out_use_layernorm: bool = False, mlp_dropout_p: float = 0.0,
    ):
        super().__init__()
        self.dummy = dummy
        self.mode = mode
        self.res_cat = res_cat
        self.res_add = res_add
        if dummy:
            return
        kw = dict(dropout_p=mlp_dropout_p)
        self.mlp_in = MLP(in_dim, [hidden_dim] * n_layer_mlp_in, use_layernorm=mlp_in_use_layernorm, **kw)
        out_in = 2 * hidden_dim if mode == "cat" else hidden_dim
        self.mlp_out = MLP(out_in, [hidden_dim] * n_layer_mlp_out, use_layernorm=mlp_out_use_layernorm, **kw)
        if res_cat:
            self.mlp_res_cat = MLP(
                3 * hidden_dim, [hidden_dim] * n_layer_mlp_out, use_layernorm=mlp_out_use_layernorm, **kw
            )

    def precompute_z(self, z: Tensor, z_valid: Tensor, rng: Optional[DropoutSeeds] = None) -> Tensor:
        """The z-side input MLP; z is constant over a rollout, so the eval
        rollout runs it once per episode (training runs it every step, for
        its dropout)."""
        return self.mlp_in(z, z_valid, rng=rng)

    def forward(self, x, x_valid, z, z_valid, z_pre: Optional[Tensor] = None, rng: Optional[DropoutSeeds] = None) -> Tensor:
        if self.dummy:
            return torch.where(x_valid[..., None], x, torch.zeros_like(x))
        z = z_pre if z_pre is not None else self.precompute_z(z, z_valid, rng)
        if self.mode == "add":
            h = x + z
        elif self.mode == "mul":
            h = x * z
        else:
            h = torch.cat([x, z], dim=-1)
        h = self.mlp_out(h, rng=rng)
        if self.res_cat:
            h = self.mlp_res_cat(torch.cat([x, h, z], dim=-1), rng=rng)
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
