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

`block_attn_core` sends a CUDA tensor to `csrc/block_attn.cu` and a CPU
tensor to `block_attn_core_plain`, never one in place of the other.
`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

Tensor = torch.Tensor

LAUNCHES = 0

NEG = -1e30
_KERNEL = "block_attn"
KERNEL_MAX_NODES = 32  # MAXN in csrc/block_attn.cu
KERNEL_MAX_D = 128  # MAXD in csrc/block_attn.cu
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt in to on sm_90


def smem_bytes(n_node: int, d_model: int, n_head: int) -> int:
    """Shared memory of one block (mirrors the kernel's layout): q, k, v rows
    of d_model + 1 floats, the [n_head, N, N] weights, the static node mask
    and flag."""
    return 4 * (3 * n_node * (d_model + 1) + n_head * n_node * n_node + KERNEL_MAX_NODES + 1)


def block_attn_core_plain(q: Tensor, k: Tensor, v: Tensor, valid: Tensor, n_head: int) -> Tensor:
    """q, k, v [BP, N, D] fp32, valid [BP, N] bool -> [BP, N, D] fp32, in the
    TPU kernel's order: logits * scale + mask * (-1e30), then the softmax."""
    BP, N, D = q.shape
    dh = D // n_head
    qh, kh, vh = (t.reshape(BP, N, n_head, dh) for t in (q, k, v))
    logits = torch.einsum("bshd,bthd->bhst", qh, kh)
    use_mask = (~valid & valid.any(dim=-1, keepdim=True)).to(q.dtype)  # [BP, N] over targets
    logits = logits * (1.0 / math.sqrt(dh)) + use_mask[:, None, None, :] * NEG
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", attn, vh).reshape(BP, N, D)


def _check_inputs(q: Tensor, k: Tensor, v: Tensor, valid: Tensor, n_head: int) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device and valid.device == q.device):
        raise ValueError("block_attn_core: q, k, v and valid must lie on one CUDA device")
    if q.dtype != torch.float32 or k.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"q, k, v must be float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape or tuple(valid.shape) != tuple(q.shape[:2]):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"valid {tuple(valid.shape)}")
    N, D = q.shape[1], q.shape[2]
    if not 1 <= N <= KERNEL_MAX_NODES or not 1 <= D <= KERNEL_MAX_D or D % n_head:
        raise ValueError(f"the kernel takes 1..{KERNEL_MAX_NODES} nodes, d_model 1..{KERNEL_MAX_D} "
                         f"and d_model % n_head == 0")
    if smem_bytes(N, D, n_head) > SMEM_LIMIT:
        raise ValueError(f"N={N}, d_model={D}, {n_head} heads do not fit one block's shared memory")
    if not all(t.is_contiguous() for t in (q, k, v, valid)):
        raise ValueError("q, k, v and valid must be contiguous")


def block_attn_core(q: Tensor, k: Tensor, v: Tensor, valid: Tensor, n_head: int) -> Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    global LAUNCHES
    if q.device.type == "cpu":
        return block_attn_core_plain(q, k, v, valid, n_head)
    _check_inputs(q, k, v, valid, n_head)
    BP, N, D = q.shape
    out = torch.empty_like(q)
    if BP == 0:
        return out
    fn = cuda_build.load(_KERNEL).tb_block_attn
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, N, D, n_head,
        1.0 / math.sqrt(D // n_head), torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(rc, "block_attn_core")
    LAUNCHES += 1
    return out
