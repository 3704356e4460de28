"""Masked multi-head attention core: a CUDA kernel and its plain version.

Replaces the Pallas kernel `trafficbots_tpu/ops/fused_attention.py`
(`fused_attention_core` -> `_attn_kernel`). Both functions compute, per head,

    softmax(q_h k_hᵀ / sqrt(d_head), masked) v_h   -> [B, S, D]

with `invalid` [B, S, T] True = disallowed target. Rows whose targets are
ALL disallowed come out exactly 0, never NaN.

The dead-query-row skip (the JAX function at `row_block >= 0`, its
`_skip`): `src_invalid` [B, S] True marks dead query rows (padding agents
or polylines). A row is live when `row_live` says so: not marked there and
with an allowed target. Every dead row comes out exactly 0, in the kernel
and in the plain version; a live row is computed as without `src_invalid`,
to the bit. The TPU kernel zeroes whole dead blocks of its grid and
computes the dead rows of a partly live block, which its callers zero
before any consumer: the two agree wherever a value is read.
`src_invalid=None` (the JAX default, `row_block = -1`) is today's function
and launch. `LAUNCHES_SKIP` counts the launches that carry `src_invalid`
(fp32 or bf16, also counted in `LAUNCHES` / `LAUNCHES_BF16`).

Precision: with fp32 q, a bf16 K/V cache (the eval map cache) is stored in
bf16 and used in fp32 from the load onward, in the kernel and in the plain
version alike. This is the JAX package's XLA path (the one its CPU tests
run), not its TPU kernel path, which also rounds q and the attention
weights to bf16. With bf16 q (the model under `precision="bf16"`), q, k
and v are all bf16 and both compute that TPU kernel's function: the
logits of the bf16 operands times the fp32 scale 1/sqrt(d_head) and the
softmax in fp32, the weights rounded to bf16, the weighted sum in fp32,
the output rounded to bf16 (K1's bf16 variant, `tb_fused_attention_bf16`,
whose products run on the tensor cores as bf16 MMAs with fp32
accumulation; `LAUNCHES_BF16` counts it).

`fused_attention_core` sends a CUDA tensor to the kernel
(`csrc/fused_attention.cu`, the forward of `csrc/attn_fwd.cuh` shared with
K3f: a thread-block cluster over T where S <= 64 and the grid is small,
32-row blocks otherwise; a block or cluster whose rows are all dead writes
its zeros and stages nothing) and a CPU tensor to `attention_core_plain`;
it never falls back from one to the other. `LAUNCHES` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_build, round_to

Tensor = torch.Tensor

LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_SKIP = 0

_KERNEL = "fused_attention"
_HEAD_DIMS = (16, 32, 64)
ROWS_PER_BLOCK = 32  # ROWS_L in csrc/attn_fwd.cuh: query rows of a large-site (path L) block
KEY_TILE = 128  # TK: keys of a path-L tile and of a path-S cluster rank's slice
_SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on sm_90
BF16_MAX_KEYS = 8 * KEY_TILE  # K1-bf16's path L holds a row's logits in registers, a key tile a warp (NKW)
_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 2 + (ctypes.c_void_p,)
_ARGS_BF16 = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_longlong,) * 2 + (ctypes.c_void_p,)


def row_live(invalid: Tensor, src_invalid: Optional[Tensor]) -> Tensor:
    """[B, S] True = a live query row: not padding (`src_invalid`) and with
    at least one allowed target. The port's copy of the JAX package's one
    definition (`ops/kernel_common.py` `row_live`, without its `TB_PAD_SKIP`
    switch), which K1's and K3's skips share."""
    live = ~invalid.all(dim=-1)
    return live if src_invalid is None else live & ~src_invalid


def attention_core_plain(q: Tensor, k: Tensor, v: Tensor, invalid: Tensor, n_head: int,
                         src_invalid: Optional[Tensor] = None) -> Tensor:
    """The plain PyTorch version: q [B,S,D] fp32, k/v [B,T,D] fp32 or bf16,
    invalid [B,S,T] bool -> [B,S,D] fp32; or q, k, v all bf16 -> [B,S,D]
    bf16, the weights rounded to bf16 before the weighted sum. Rows that
    are not `row_live` come out 0."""
    B, S, D = q.shape
    T = k.shape[1]
    dh = D // n_head
    lowp = q.dtype == torch.bfloat16
    qh = q.float().reshape(B, S, n_head, dh)
    kh = k.float().reshape(B, T, n_head, dh)
    vh = v.float().reshape(B, T, n_head, dh)
    logits = torch.einsum("bshd,bthd->bhst", qh, kh)
    no_valid = invalid.all(dim=-1)  # [B, S]
    use_mask = invalid & ~no_valid[..., None]
    logits = logits.masked_fill(use_mask[:, None], float("-inf"))
    if lowp:  # the TPU kernel's order: the logits times the fp32 scale
        attn = round_to(torch.softmax(logits * (1.0 / math.sqrt(dh)), dim=-1))
    else:
        attn = torch.softmax(logits / math.sqrt(dh), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", attn, vh).reshape(B, S, D)
    dead = no_valid if src_invalid is None else ~row_live(invalid, src_invalid)
    return torch.where(dead[..., None], torch.zeros_like(out), out).to(q.dtype)


def smem_bytes(T: int, d_head: int, kv_bytes: int = 4) -> int:
    """Dynamic shared memory of the larger of the kernel's two blocks
    (mirrors rows_smem and cluster_smem in csrc/attn_fwd.cuh): path L's
    [32, T] logits, q, two K/V tiles (or the groups' partial sums) and the
    mask bits; path S's slice logits (then partial sums), q, K and V slices
    and row statistics; the warp columns' row maxima. Path L's logits bound
    T. K1-bf16's block (rows_mma_smem) fits at every T it takes
    (BF16_MAX_KEYS), with V in K's place where both do not fit."""
    nt = -(-T // KEY_TILE)
    tiles = 2 * KEY_TILE * (d_head + 16 // kv_bytes) * kv_bytes // 4
    rows = (ROWS_PER_BLOCK * (nt * KEY_TILE + 8) + ROWS_PER_BLOCK * (d_head + 4) + max(tiles, 512 * 16)
            + ROWS_PER_BLOCK * nt * KEY_TILE // 32 + (8 + 2) * ROWS_PER_BLOCK + 2 * nt)
    cluster = 64 * (KEY_TILE + 8) + 64 * (d_head + 4) + tiles + (2 + 4) * 64 + 64 * KEY_TILE // 32
    return 4 * max(rows, cluster)


def check_src_invalid(src_invalid: Optional[Tensor], q: Tensor) -> int:
    """The pointer a kernel takes for `src_invalid` ([B, S] bool on q's
    device, contiguous), or 0 (NULL) for None."""
    if src_invalid is None:
        return 0
    if src_invalid.device != q.device or src_invalid.dtype != torch.bool:
        raise TypeError(f"src_invalid must be bool on {q.device}, got {src_invalid.dtype} on {src_invalid.device}")
    if tuple(src_invalid.shape) != tuple(q.shape[:2]) or not src_invalid.is_contiguous():
        raise ValueError(f"src_invalid must be a contiguous [B, S] = {tuple(q.shape[:2])}, got "
                         f"{tuple(src_invalid.shape)}")
    return src_invalid.data_ptr()


def _check_inputs(q, k, v, invalid, n_head):
    if not (q.is_cuda and k.device == q.device and v.device == q.device and invalid.device == q.device):
        raise ValueError("fused_attention_core: q, k, v and invalid must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"k/v must both be float32 or bfloat16, got {k.dtype}/{v.dtype}")
    if q.dtype == torch.bfloat16 and k.dtype != torch.bfloat16:
        raise TypeError("bfloat16 q takes bfloat16 k/v")
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
    if smem_bytes(T, D // n_head, k.element_size()) > _SMEM_LIMIT:
        raise ValueError(f"T={T} does not fit one block's shared memory")
    if q.dtype == torch.bfloat16 and T > BF16_MAX_KEYS:
        raise ValueError(f"T={T}: K1-bf16 takes at most {BF16_MAX_KEYS} keys (a key tile a warp)")


def fused_attention_core(q: Tensor, k: Tensor, v: Tensor, invalid: Tensor, n_head: int,
                         src_invalid: Optional[Tensor] = None) -> Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors. `invalid` may be
    a stride-0 expand over S (a padding mask): the kernel reads it through
    its strides and never needs it materialized. `src_invalid` [B, S]
    (dead query rows) turns the dead-query-row skip on."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_SKIP
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v, invalid, n_head, src_invalid)
    _check_inputs(q, k, v, invalid, n_head)
    if src_invalid is not None:
        src_invalid = src_invalid.contiguous()
    src_ptr = check_src_invalid(src_invalid, q)
    B, S, D = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    if q.dtype == torch.bfloat16:
        rc = cuda_build.entry(_KERNEL, "tb_fused_attention_bf16", _ARGS_BF16)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), src_ptr, out.data_ptr(),
            B, S, T, D, n_head, invalid.stride(0), invalid.stride(1), cuda_build.stream(q),
        )
        cuda_build.check(rc, "fused_attention_core (bf16)")
        LAUNCHES_BF16 += 1
    else:
        rc = cuda_build.entry(_KERNEL, "tb_fused_attention", _ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), src_ptr, out.data_ptr(),
            B, S, T, D, n_head, int(k.dtype == torch.bfloat16),
            invalid.stride(0), invalid.stride(1), cuda_build.stream(q),
        )
        cuda_build.check(rc, "fused_attention_core")
        LAUNCHES += 1
    if src_invalid is not None:
        LAUNCHES_SKIP += 1
    return out
