"""DenseTNT polyline-node encoder and max-pool: a CUDA kernel and its plain version.

Replaces the Pallas kernel `trafficbots_tpu/ops/node_encoder.py`
(`FusedNodeEncoder.encode_pooled` -> `_node_kernel` / `_node_kernel_body`).
Per polyline of N nodes, `n_layer` pre-norm self-attention layers:

    q from LN1(x); k, v from LN_tgt(x0), x0 = the LAYER-0 input, every layer;
    attention within the polyline, padded nodes masked (the mask is lifted
    for a polyline with no valid node, whose attention output is zeroed);
    x += out-proj; x += W2 relu(W1 LN2(x)); invalid nodes zeroed every layer;

then a masked max over the valid nodes. A polyline without a valid node
pools to -1e30, which the map encoder zeroes.

`bf16` (`map_encoder.kernel_matmul_bf16`) is the TPU kernel's `bf16=True`
function: the operands of every product (the q/k/v/out projections, both
FFN layers, q kᵀ and the weights times v) rounded to bf16, the sums,
LayerNorms, softmax, residuals and the pool in fp32 (K2's bf16 variant,
`tb_node_encoder_bf16`, whose dense products run on the tensor cores as
bf16 MMAs with fp32 accumulation; `LAUNCHES_BF16` counts it).

`encode_pooled_hybrid` is the same function in the JAX package's "hybrid"
layout (`map_encoder.node_encoder_impl="hybrid"`): the LayerNorms, the
q/k/v/out projections and the FFN as matmuls over all polylines, and only
the per-polyline attention core in a kernel (K6, `ops.block_attn`).

`kernel_refusal` is K2's shape predicate (K2-bf16 takes the same shapes):
None where the kernel takes a shape, else the reason it does not;
`_check_inputs` raises with that reason, so a CUDA tensor the kernel
refuses raises. The kernels take d_model and d_feedforward in
`KERNEL_WIDTHS` (each a multiple of 32 from 32 to 256), each
independently, and any n_head whose d_head =
d_model / n_head is a multiple of 4 from 4 to 128; the widths are constants
of a build (`build_defines`), one library a width pair, built at its
first use.

The module owns the stacked [L, ...] parameters under the JAX names
(`ln1_s` ... `b2`, matrices in the JAX [in, out] layout, used as x @ w), so
the flax arrays load as they are. `forward` is the plain per-node path;
`encode_pooled` sends a CUDA tensor to `csrc/node_encoder.cu` (its layer
code in `csrc/node_layer.cuh`) and a CPU tensor to `pooled_plain`, never
one in place of the other. `LAUNCHES`
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_build, round_to
from .block_attn import block_attn_core, block_attn_core_plain
from .dropout import dropout_mask_plain

Tensor = torch.Tensor

LAUNCHES = 0
LAUNCHES_BF16 = 0

NEG = -1e30
LN_EPS = 1e-5
_KERNEL = "node_encoder"
KERNEL_D = 128  # the default build's d_model and d_feedforward (TB_NODE_D, TB_NODE_F in csrc/node_layer.cuh)
KERNEL_WIDTHS = tuple(range(32, 257, 32))  # the d_model and d_feedforward a build may take, each independently
KERNEL_MAX_NODES = 32  # MAXN in csrc/node_layer.cuh: a thread's attention scores in registers
KERNEL_MAX_D_HEAD = 128  # heads_ok in csrc/node_layer.cuh: d_head a multiple of 4 up to 128
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt in to on sm_90
BLOCK_BYTES = 2072  # sizeof(Block) in csrc/node_layer.cuh: a block's row map
_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 + (ctypes.c_void_p, ctypes.c_void_p)
W_NAMES = (
    "ln1_s", "ln1_b", "lnt_s", "lnt_b", "ln2_s", "ln2_b",
    "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "w1", "b1", "w2", "b2",
)


def build_defines(d_model: int, d_ff: int) -> Tuple[str, ...]:
    """nvcc's -D flags of the build of the node kernels (K2, K4) at these
    widths: none for the default 128 x 128, else TB_NODE_D and TB_NODE_F
    (csrc/node_layer.cuh)."""
    if (d_model, d_ff) == (KERNEL_D, KERNEL_D):
        return ()
    return (f"-DTB_NODE_D={d_model}", f"-DTB_NODE_F={d_ff}")


def kernel_rows(d_model: int = KERNEL_D, d_ff: int = KERNEL_D) -> int:
    """ROWS in csrc/node_encoder.cu: the valid nodes a block holds, the
    most (a multiple of 4, at most 64) whose five [rows, max(D, F) + 4]
    fp32 buffers fit beside the larger of the weight ring (three 32 x 128
    k-tiles) and K2-bf16's bf16 rows and weight (node_layer.cuh MMA_BYTES),
    and the block's row map: 64 at a width of 128 or less, 32 at 256."""
    lds = max(d_model, d_ff) + 4
    fixed = max(4 * 3 * 32 * 128, 2 * (64 + 128) * 136) + BLOCK_BYTES
    return min(64, (SMEM_LIMIT - fixed) // (4 * 5 * lds) // 4 * 4)


def smem_bytes(d_model: int = KERNEL_D, d_ff: int = KERNEL_D) -> int:
    """Dynamic shared memory of one K2 block (mirrors
    csrc/node_encoder.cu): five [kernel_rows, max(D, F) + 4] fp32 row
    buffers and a ring of three 32 x 128 weight k-tiles, whatever the node
    count (K2-bf16 takes its tensor-core products' bf16 rows and weight,
    3 KB more, in the ring's place)."""
    return 4 * (5 * kernel_rows(d_model, d_ff) * (max(d_model, d_ff) + 4) + 3 * 32 * 128)


@functools.lru_cache(maxsize=None)
def kernel_refusal(n_node: int, d_model: int, d_feedforward: int, n_head: int) -> Optional[str]:
    """None when K2 and K2-bf16 take polylines of n_node nodes at these
    widths, else the reason they do not: the widths a build takes
    (csrc/node_layer.cuh, `KERNEL_WIDTHS`), MAXN and `heads_ok`."""
    if d_model not in KERNEL_WIDTHS or d_feedforward not in KERNEL_WIDTHS:
        return "the kernel takes d_model and d_feedforward each a multiple of 32 from 32 to 256"
    if not 1 <= n_node <= KERNEL_MAX_NODES:
        return f"the kernel takes 1..{KERNEL_MAX_NODES} nodes (a thread's scores in registers)"
    if n_head < 1 or d_model % n_head or (d_model // n_head) % 4 or d_model // n_head > KERNEL_MAX_D_HEAD:
        return f"the kernel takes d_head = d_model / n_head a multiple of 4 from 4 to {KERNEL_MAX_D_HEAD}"
    return None


def _ln(x: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """LayerNorm written out as the JAX kernel does (two-pass variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + LN_EPS) * scale + bias


class FusedNodeEncoder(nn.Module):
    """Stack of pre-norm self-attention layers over polyline nodes + pool."""

    def __init__(self, d_model: int, n_head: int, n_layer: int, d_feedforward: int):
        super().__init__()
        L, D, Fd = n_layer, d_model, d_feedforward
        self.d_model, self.n_head, self.n_layer, self.d_feedforward = D, n_head, L, Fd
        shapes = {
            "ln1_s": (L, D), "ln1_b": (L, D), "lnt_s": (L, D), "lnt_b": (L, D),
            "ln2_s": (L, D), "ln2_b": (L, D),
            "wq": (L, D, D), "bq": (L, D), "wk": (L, D, D), "bk": (L, D),
            "wv": (L, D, D), "bv": (L, D), "wo": (L, D, D), "bo": (L, D),
            "w1": (L, D, Fd), "b1": (L, Fd), "w2": (L, Fd, D), "b2": (L, D),
        }
        for name in W_NAMES:
            init = torch.ones if name.endswith("_s") else torch.zeros
            self.register_parameter(name, nn.Parameter(init(shapes[name])))

    def forward(self, x: Tensor, valid: Tensor, p: float = 0.0, seed: int = 0, bf16: bool = False) -> Tensor:
        """Plain path: [BP, N, D], [BP, N] -> per-node features [BP, N, D].
        With p > 0, inverted dropout at the training kernel's four sites a
        layer (ops.dropout masks at (seed, 4 l + k), see
        ops.node_encoder_train). `bf16` rounds every product's operands
        to bf16 (the eval kernel's `bf16` variant)."""
        BP, N, D = x.shape
        H = self.n_head
        dh = D // H
        pad = ~valid
        no_valid = pad.all(dim=-1)  # [BP]
        use_mask = pad[:, None, :] & ~no_valid[:, None, None]  # [BP, 1, N] over targets

        def drop(t: Tensor, site: int) -> Tensor:
            return t * dropout_mask_plain(tuple(t.shape), seed, site, p, device=t.device) if p > 0 else t

        rnd = round_to if bf16 else (lambda t: t)

        def mm(a: Tensor, w: Tensor) -> Tensor:
            return rnd(a) @ rnd(w)

        x0 = x
        for l in range(self.n_layer):
            src2 = _ln(x, self.ln1_s[l], self.ln1_b[l])
            tgtn = _ln(x0, self.lnt_s[l], self.lnt_b[l])
            q = (mm(src2, self.wq[l]) + self.bq[l]).reshape(BP, N, H, dh)
            k = (mm(tgtn, self.wk[l]) + self.bk[l]).reshape(BP, N, H, dh)
            v = (mm(tgtn, self.wv[l]) + self.bv[l]).reshape(BP, N, H, dh)
            logits = torch.einsum("bshd,bthd->bhst", rnd(q), rnd(k))
            logits = logits.masked_fill(use_mask[:, None], float("-inf"))
            attn = drop(torch.softmax(logits / math.sqrt(dh), dim=-1), 4 * l)
            a = torch.einsum("bhst,bthd->bshd", rnd(attn), rnd(v)).reshape(BP, N, D)
            a = mm(a, self.wo[l]) + self.bo[l]
            a = torch.where(no_valid[:, None, None], torch.zeros_like(a), a)
            x = x + drop(a, 4 * l + 1)
            src2 = _ln(x, self.ln2_s[l], self.ln2_b[l])
            f = drop(F.relu(mm(src2, self.w1[l]) + self.b1[l]), 4 * l + 2)
            x = x + drop(mm(f, self.w2[l]) + self.b2[l], 4 * l + 3)
            x = torch.where(pad[..., None], torch.zeros_like(x), x)
        return x

    def pooled_plain(self, x: Tensor, valid: Tensor, bf16: bool = False) -> Tensor:
        """The plain version of the kernel: `forward` + masked max -> [BP, D]."""
        nodes = self.forward(x, valid, bf16=bf16)
        return torch.where(valid[..., None], nodes, torch.full_like(nodes, NEG)).amax(dim=1)

    def encode_pooled_hybrid(self, x: Tensor, valid: Tensor, plain: bool = False, bf16: bool = False) -> Tensor:
        """[BP, N, D] fp32, [BP, N] bool -> pooled [BP, D] fp32: the layers'
        matmuls over all polylines, the attention core through K6
        (`block_attn_core`; its plain version with `plain`; its bf16
        variant with `bf16`, the matmuls staying fp32 as in the JAX
        package). Zeroing order as in the JAX package: no-valid polylines
        after the out-projection, padded nodes after each layer, then the
        -1e30 pool identity."""
        core = block_attn_core_plain if plain else block_attn_core
        pad = ~valid
        no_valid = pad.all(dim=-1)  # [BP]
        x0 = x
        for l in range(self.n_layer):
            src2 = _ln(x, self.ln1_s[l], self.ln1_b[l])
            tgtn = _ln(x0, self.lnt_s[l], self.lnt_b[l])
            q = src2 @ self.wq[l] + self.bq[l]
            k = tgtn @ self.wk[l] + self.bk[l]
            v = tgtn @ self.wv[l] + self.bv[l]
            a = core(q, k, v, valid, self.n_head, bf16=bf16) @ self.wo[l] + self.bo[l]
            x = x + torch.where(no_valid[:, None, None], torch.zeros_like(a), a)
            src2 = _ln(x, self.ln2_s[l], self.ln2_b[l])
            x = x + (F.relu(src2 @ self.w1[l] + self.b1[l]) @ self.w2[l] + self.b2[l])
            x = torch.where(pad[..., None], torch.zeros_like(x), x)
        return torch.where(pad[..., None], torch.full_like(x, NEG), x).amax(dim=1)

    def encode_pooled(self, x: Tensor, valid: Tensor, bf16: bool = False) -> Tensor:
        """[BP, N, D] fp32, [BP, N] bool -> pooled [BP, D] fp32."""
        global LAUNCHES, LAUNCHES_BF16
        if x.device.type == "cpu":
            return self.pooled_plain(x, valid, bf16=bf16)
        self._check_inputs(x, valid)
        BP, N, D = x.shape
        out = torch.empty((BP, D), dtype=torch.float32, device=x.device)
        if BP == 0:
            return out
        weights = [getattr(self, n) for n in W_NAMES]
        ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
        rc = cuda_build.entry(_KERNEL, "tb_node_encoder_bf16" if bf16 else "tb_node_encoder", _ARGS,
                              build_defines(D, self.d_feedforward))(
            x.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, N, self.n_layer, self.n_head, D,
            self.d_feedforward, ctypes.cast(ptrs, ctypes.c_void_p), cuda_build.stream(x),
        )
        cuda_build.check(rc, "FusedNodeEncoder.encode_pooled")
        if bf16:
            LAUNCHES_BF16 += 1
        else:
            LAUNCHES += 1
        return out

    def _check_inputs(self, x: Tensor, valid: Tensor) -> None:
        if x.dtype != torch.float32 or valid.dtype != torch.bool:
            raise TypeError(f"x must be float32 and valid bool, got {x.dtype}/{valid.dtype}")
        if x.ndim != 3 or tuple(valid.shape) != tuple(x.shape[:2]) or x.shape[2] != self.d_model:
            raise ValueError(f"bad shapes x {tuple(x.shape)} valid {tuple(valid.shape)}")
        reason = kernel_refusal(x.shape[1], self.d_model, self.d_feedforward, self.n_head)
        if reason is not None:
            raise ValueError(reason)
        if not (x.is_contiguous() and valid.is_contiguous()):
            raise ValueError("x and valid must be contiguous")
        if not (x.is_cuda and valid.device == x.device):
            raise ValueError("encode_pooled: x and valid must lie on one CUDA device")
        for name in W_NAMES:
            w = getattr(self, name)
            if w.device != x.device or w.dtype != torch.float32 or not w.is_contiguous():
                raise ValueError(f"parameter {name} must be contiguous float32 on {x.device}")
