"""Masked multi-head attention core: a CUDA kernel and its plain version.

Replaces the Pallas kernel `trafficbots_tpu/ops/fused_attention.py`
(`fused_attention_core` -> `_attn_kernel`). Both functions compute, per head,

    softmax(q_h k_hᵀ / sqrt(d_head), masked) v_h   -> [B, S, D]

with `invalid` [B, S, T] True = disallowed target. Rows whose targets are
ALL disallowed come out exactly 0, never NaN.

Precision: a bf16 K/V cache (the eval map cache) is stored in bf16 and used
in fp32 from the load onward, in the kernel and in the plain version alike.
This is the JAX package's XLA path (the one its CPU tests run), not its TPU
kernel path, which also rounds q and the attention weights to bf16.

`fused_attention_core` sends a CUDA tensor to the kernel
(`csrc/fused_attention.cu`) and a CPU tensor to `attention_core_plain`; it
never falls back from one to the other. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build

Tensor = torch.Tensor

LAUNCHES = 0

_KERNEL = "fused_attention"
_HEAD_DIMS = (16, 32, 64)
ROWS_PER_BLOCK = 16  # must match ROWS in csrc/fused_attention.cu
_SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on sm_90


def attention_core_plain(q: Tensor, k: Tensor, v: Tensor, invalid: Tensor, n_head: int) -> Tensor:
    """The plain PyTorch version: q [B,S,D] fp32, k/v [B,T,D] fp32 or bf16,
    invalid [B,S,T] bool -> [B,S,D] fp32."""
    B, S, D = q.shape
    T = k.shape[1]
    dh = D // n_head
    qh = q.reshape(B, S, n_head, dh)
    kh = k.to(q.dtype).reshape(B, T, n_head, dh)
    vh = v.to(q.dtype).reshape(B, T, n_head, dh)
    logits = torch.einsum("bshd,bthd->bhst", qh, kh)
    no_valid = invalid.all(dim=-1)  # [B, S]
    use_mask = invalid & ~no_valid[..., None]
    logits = logits.masked_fill(use_mask[:, None], float("-inf"))
    attn = torch.softmax(logits / math.sqrt(dh), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", attn, vh).reshape(B, S, D)
    return torch.where(no_valid[..., None], torch.zeros_like(out), out)


def smem_bytes(T: int, d_head: int) -> int:
    """Dynamic shared memory of one block (mirrors the kernel's layout)."""
    t_pad = (T + 3) // 4 * 4
    return 4 * (ROWS_PER_BLOCK * t_pad + ROWS_PER_BLOCK * d_head + 64 * (d_head + 1))


def _check_inputs(q, k, v, invalid, n_head):
    if not (q.is_cuda and k.device == q.device and v.device == q.device and invalid.device == q.device):
        raise ValueError("fused_attention_core: q, k, v and invalid must lie on one CUDA device")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"k/v must both be float32 or bfloat16, got {k.dtype}/{v.dtype}")
    if invalid.dtype != torch.bool:
        raise TypeError(f"invalid must be bool, got {invalid.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, S, D = q.shape
    T = k.shape[1]
    if k.shape[0] != B or k.shape[2] != D or tuple(invalid.shape) != (B, S, T):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} invalid {tuple(invalid.shape)}")
    if D % n_head or D // n_head not in _HEAD_DIMS:
        raise ValueError(f"d_head = {D}/{n_head} must be one of {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if invalid.stride(2) != 1:
        raise ValueError("invalid must be contiguous along the target axis")
    if smem_bytes(T, D // n_head) > _SMEM_LIMIT:
        raise ValueError(f"T={T} does not fit one block's shared memory")


def fused_attention_core(q: Tensor, k: Tensor, v: Tensor, invalid: Tensor, n_head: int) -> Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors. `invalid` may be
    a stride-0 expand over S (a padding mask): the kernel reads it through
    its strides and never needs it materialized."""
    global LAUNCHES
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v, invalid, n_head)
    _check_inputs(q, k, v, invalid, n_head)
    B, S, D = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    lib = cuda_build.load(_KERNEL)
    fn = lib.tb_fused_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), out.data_ptr(),
        B, S, T, D, n_head, int(k.dtype == torch.bfloat16),
        invalid.stride(0), invalid.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(rc, "fused_attention_core")
    LAUNCHES += 1
    return out
