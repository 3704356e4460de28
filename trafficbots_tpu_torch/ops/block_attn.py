"""Per-polyline attention core of the hybrid node encoder: a CUDA kernel and its plain version.

Replaces the Pallas kernel `trafficbots_tpu/ops/node_encoder.py`
(`FusedNodeEncoder.encode_pooled_hybrid` -> `_block_attn_kernel`). For each
polyline of N nodes and each head,

    softmax(q_h k_hᵀ / sqrt(d_head) - 1e30 * mask) v_h   -> [BP, N, D]

with `mask` = the padded target nodes, concatenated over the heads, before
the out-projection. The LayerNorms, the q/k/v/out projections and the FFN
around it are plain matmuls (`FusedNodeEncoder.encode_pooled_hybrid`).

A polyline with no valid node has its mask lifted over its own nodes (the
XLA reference `FusedNodeEncoder.__call__` does the same), so its rows come
out finite; the caller zeroes them after the out-projection. The TPU kernel
lifts the mask over a whole block of 8 polylines instead: those rows are
discarded either way, so only the rows of polylines with a valid node are
held against it.

`bf16` (`map_encoder.kernel_matmul_bf16`) is the TPU kernel's `bf16=True`
function: q kᵀ and the weights times v on operands rounded to bf16, fp32
accumulation, an fp32 output (K6's bf16 variant, `tb_block_attn_bf16`).

`kernel_refusal` is K6's shape predicate (K6-bf16 takes the same shapes):
None where the kernel takes a shape, else the reason it does not;
`_check_inputs` raises with that reason, so a CUDA tensor the kernel
refuses raises.

`block_attn_core` sends a CUDA tensor to `csrc/block_attn.cu` and a CPU
tensor to `block_attn_core_plain`, never one in place of the other.
`LAUNCHES` counts the fp32 kernel's launches, `LAUNCHES_BF16` the bf16
variant's.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import cuda_build, round_to

Tensor = torch.Tensor

LAUNCHES = 0
LAUNCHES_BF16 = 0

NEG = -1e30
_KERNEL = "block_attn"
KERNEL_MAX_NODES = 32  # MAXN in csrc/block_attn.cu
KERNEL_MAX_D = 256  # MAXD in csrc/block_attn.cu
KERNEL_ROW_THREADS = 128  # NT_MMA in csrc/block_attn.cu: a row's copies in one pass of a block
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt in to on sm_90
_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p)


def smem_bytes(n_node: int, d_model: int, n_head: int) -> int:
    """Shared memory of one block (mirrors the kernel's layout): two stages
    of q, k, v, each N rounded up to 4 rows of a head-padded row stride."""
    d4 = (d_model // n_head + 3) // 4 * 4
    head = d4 + 4 if d4 % 32 == 0 else d4
    row = n_head * head
    row += 0 if (row // 4) % 2 else 4
    return 4 * 2 * 3 * ((n_node + 3) // 4 * 4) * row


def block_attn_core_plain(q: Tensor, k: Tensor, v: Tensor, valid: Tensor, n_head: int, bf16: bool = False) -> Tensor:
    """q, k, v [BP, N, D] fp32, valid [BP, N] bool -> [BP, N, D] fp32, in the
    TPU kernel's order: logits * scale + mask * (-1e30), then the softmax;
    with `bf16` both products on operands rounded to bf16."""
    BP, N, D = q.shape
    dh = D // n_head
    rnd = round_to if bf16 else (lambda t: t)
    qh, kh, vh = (rnd(t).reshape(BP, N, n_head, dh) for t in (q, k, v))
    logits = torch.einsum("bshd,bthd->bhst", qh, kh)
    use_mask = (~valid & valid.any(dim=-1, keepdim=True)).to(q.dtype)  # [BP, N] over targets
    logits = logits * (1.0 / math.sqrt(dh)) + use_mask[:, None, None, :] * NEG
    attn = rnd(torch.softmax(logits, dim=-1))
    return torch.einsum("bhst,bthd->bshd", attn, vh).reshape(BP, N, D)


@functools.lru_cache(maxsize=None)
def kernel_refusal(n_node: int, d_model: int, n_head: int) -> Optional[str]:
    """None when K6 and K6-bf16 take polylines of n_node nodes at d_model /
    n_head heads, else the reason they do not: `takes` in
    csrc/block_attn.cu (MAXN, MAXD, a row's copies in one pass of a
    block's threads, two stages of q, k, v in one block's shared memory)."""
    if not 1 <= n_node <= KERNEL_MAX_NODES or not 1 <= d_model <= KERNEL_MAX_D or n_head < 1 or d_model % n_head:
        return (f"the kernel takes 1..{KERNEL_MAX_NODES} nodes, d_model 1..{KERNEL_MAX_D} "
                f"and d_model % n_head == 0")
    if (d_model // n_head) % 4 and d_model > KERNEL_ROW_THREADS:
        return f"d_model > {KERNEL_ROW_THREADS} takes d_head a multiple of 4 (a row's copies by float4)"
    if smem_bytes(n_node, d_model, n_head) > SMEM_LIMIT:
        return f"N={n_node}, d_model={d_model}, {n_head} heads do not fit one block's shared memory"
    return None


def _check_inputs(q: Tensor, k: Tensor, v: Tensor, valid: Tensor, n_head: int) -> None:
    if q.dtype != torch.float32 or k.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"q, k, v must be float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape or tuple(valid.shape) != tuple(q.shape[:2]):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"valid {tuple(valid.shape)}")
    reason = kernel_refusal(q.shape[1], q.shape[2], n_head)
    if reason is not None:
        raise ValueError(reason)
    if not all(t.is_contiguous() for t in (q, k, v, valid)):
        raise ValueError("q, k, v and valid must be contiguous")
    if not (q.is_cuda and k.device == q.device and v.device == q.device and valid.device == q.device):
        raise ValueError("block_attn_core: q, k, v and valid must lie on one CUDA device")


def block_attn_core(q: Tensor, k: Tensor, v: Tensor, valid: Tensor, n_head: int, bf16: bool = False) -> Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    global LAUNCHES, LAUNCHES_BF16
    if q.device.type == "cpu":
        return block_attn_core_plain(q, k, v, valid, n_head, bf16=bf16)
    _check_inputs(q, k, v, valid, n_head)
    BP, N, D = q.shape
    out = torch.empty_like(q)
    if BP == 0:
        return out
    rc = cuda_build.entry(_KERNEL, "tb_block_attn_bf16" if bf16 else "tb_block_attn", _ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, N, D, n_head,
        1.0 / math.sqrt(D // n_head), cuda_build.stream(q),
    )
    cuda_build.check(rc, "block_attn_core")
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out
