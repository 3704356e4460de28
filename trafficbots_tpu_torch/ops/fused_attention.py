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

`kernel_refusal` is K1's shape predicate (K1-bf16's with `bf16`): None
where the kernel takes a shape, else the reason it does not;
`_check_inputs` raises with that reason, so a CUDA tensor the kernel
refuses raises. `jax_kernel_fits` is the JAX package's own choice between
its Pallas kernel and XLA, which the call site (`models.modules.Attention`)
follows.

`fused_attention_core` sends a CUDA tensor to the kernel
(`csrc/fused_attention.cu`, the forward of `csrc/attn_fwd.cuh` shared with
K3f: a thread-block cluster over T where S <= 64 and the grid is small,
32-row blocks otherwise, and past the T whose [32, T] logits fit a block's
shared memory the same blocks with the logits in a global workspace
(path G, `workspace`); K1-bf16 past 1,024 keys in rounds of key tiles; a
block or cluster whose rows are all dead writes its zeros and stages
nothing) and a CPU tensor to `attention_core_plain`; it never falls back
from one to the other. `LAUNCHES` counts kernel launches.
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
LAUNCHES_SKIP = 0

_KERNEL = "fused_attention"
_HEAD_DIMS = (4, 8, 16, 32, 64, 128)
ROWS_PER_BLOCK = 32  # ROWS_L in csrc/attn_fwd.cuh: query rows of a large-site (path L) block
KEY_TILE = 128  # TK: keys of a path-L tile and of a path-S cluster rank's slice
KV_BUF_BYTES = 2 * KEY_TILE * 68 * 4  # KV_BUF_BYTES: path L double-buffers its K/V tiles up to this size
SLAB = 64  # CS: columns of a K/V slab of K1-bf16's path L past d_head 64
LONG_SLAB = 32  # long_cols: columns of a K/V slab of K1-bf16's path L past NKW key tiles (at most)
BF16_WARP_TILES = 8  # NKW: key tiles of K1-bf16's path L, one a warp column; past them the rounds of tiles
WS_BLOCKS_PER_SM = 1  # path G's blocks an SM, each with a slot of the logits workspace
_SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on sm_90
_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_longlong,) * 2
         + (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p))
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


def rows_ldl(T: int) -> int:
    """Floats of a row of path L's (and G's) logits (rows_ldl in csrc/attn_fwd.cuh)."""
    return -(-T // KEY_TILE) * KEY_TILE + 8


def smem_bytes(T: int, d_head: int, kv_bytes: int = 4) -> int:
    """Dynamic shared memory of the larger of the kernel's path-L and
    path-S blocks (mirrors rows_smem and cluster_smem in
    csrc/attn_fwd.cuh): path L's [32, T] logits, q, its K/V tiles (two, or
    one where two would pass KV_BUF_BYTES: fp32 K/V at d_head 128; then the
    groups' partial sums) and the mask bits; path S's slice logits (then
    partial sums), q, K and V slices and row statistics; the warp columns'
    row maxima. Where path L's logits do not fit, path G takes the T
    (`ws_smem_bytes`)."""
    nt = -(-T // KEY_TILE)
    tile = KEY_TILE * (d_head + 16 // kv_bytes) * kv_bytes // 4
    bufs = 2 if 2 * 4 * tile <= KV_BUF_BYTES else 1
    rows = (ROWS_PER_BLOCK * rows_ldl(T) + ROWS_PER_BLOCK * (d_head + 4) + max(bufs * tile, 512 * 16)
            + ROWS_PER_BLOCK * nt * KEY_TILE // 32 + (8 + 2) * ROWS_PER_BLOCK + 2 * nt)
    cluster = 64 * (KEY_TILE + 8) + 64 * (d_head + 4) + 2 * tile + (2 + 4) * 64 + 64 * KEY_TILE // 32
    return 4 * max(rows, cluster)


def ws_smem_bytes(T: int, d_head: int, kv_bytes: int = 4) -> int:
    """Dynamic shared memory of a path-G block (rows_ws_smem): path L's
    block without its logits, which lie in the workspace. Its mask bits
    bound T."""
    return smem_bytes(T, d_head, kv_bytes) - 4 * ROWS_PER_BLOCK * rows_ldl(T)


def takes_workspace(T: int, d_head: int, kv_bytes: int = 4) -> bool:
    """Whether the fp32 forward (K1, K3f) runs path G at T keys: path L's
    logits pass a block's shared memory."""
    return smem_bytes(T, d_head, kv_bytes) > _SMEM_LIMIT


def forward_smem_bytes(T: int, d_head: int, kv_bytes: int = 4) -> int:
    """Dynamic shared memory of the fp32 forward's block at T keys: path
    L's or S's (`smem_bytes`), or path G's where path L's logits do not
    fit (`ws_smem_bytes`)."""
    return (ws_smem_bytes if takes_workspace(T, d_head, kv_bytes) else smem_bytes)(T, d_head, kv_bytes)


def workspace_floats(B: int, S: int, T: int, d_head: int, n_head: int, kv_bytes: int, n_sm: int) -> int:
    """fp32 elements of path G's logits workspace (ws_slots x [32][rows_ldl(T)]
    in csrc/attn_fwd.cuh: one slot for each of the grid's blocks,
    WS_BLOCKS_PER_SM an SM of the card's n_sm, at most one a work item),
    or 0 where the forward takes path L or S."""
    if not takes_workspace(T, d_head, kv_bytes):
        return 0
    work = -(-S // ROWS_PER_BLOCK) * n_head * B
    return min(work, WS_BLOCKS_PER_SM * n_sm) * ROWS_PER_BLOCK * rows_ldl(T)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def workspace(q: Tensor, T: int, n_head: int, kv_bytes: int) -> Tensor:
    """Path G's logits workspace for a forward launch on q's card (empty
    where it takes path L or S)."""
    B, S, D = q.shape
    n = workspace_floats(B, S, T, D // n_head, n_head, kv_bytes, _sm_count(q.device.index or 0))
    return torch.empty(n, dtype=torch.float32, device=q.device)


def smem_bytes_bf16(T: int, d_head: int) -> int:
    """Dynamic shared memory of the larger of K1-bf16's two blocks (mirrors
    rows_mma_smem, rows_mma_slab_smem, rows_mma_long_smem and
    cluster_mma_smem in csrc/attn_fwd.cuh): path L's bf16 q and K tiles (V
    beside K where both fit with the tiles' partial sums, else in K's
    place; past d_head 64 one SLAB-column slab of every tile at a time),
    the partial sums, mask bits and row statistics; past BF16_WARP_TILES
    key tiles, q, one LONG_SLAB-column slab of a round's tiles (then the
    warp columns' partial sums), the mask bits and each tile's row max and
    sum; path S's partial sums, q, K and V slices."""
    nt = -(-T // KEY_TILE)
    if nt > BF16_WARP_TILES:
        lw = min(d_head, LONG_SLAB)
        return (2 * ROWS_PER_BLOCK * (d_head + 8) + 2 * BF16_WARP_TILES * KEY_TILE * (lw + 8)
                + 4 * (ROWS_PER_BLOCK * nt * KEY_TILE // 32 + 2 * nt * ROWS_PER_BLOCK + 2 * ROWS_PER_BLOCK + nt))
    stats = ROWS_PER_BLOCK * nt * KEY_TILE // 32 + (2 * 8 + 2) * ROWS_PER_BLOCK + nt
    if d_head > SLAB:
        rows = (2 * (ROWS_PER_BLOCK * (d_head + 8) + nt * KEY_TILE * (SLAB + 8))
                + 4 * (nt * ROWS_PER_BLOCK * SLAB + stats))
    else:
        def rows_mma(both):
            return (2 * (ROWS_PER_BLOCK + (2 if both else 1) * nt * KEY_TILE) * (d_head + 8)
                    + 4 * ((nt * ROWS_PER_BLOCK * d_head if both else 0) + stats))

        rows = rows_mma(True) if rows_mma(True) <= _SMEM_LIMIT else rows_mma(False)
    cluster = 4 * (2 * 64 * d_head + (64 + 2 * KEY_TILE) * (d_head + 8) // 2 + 8 * 64 + 64 * KEY_TILE // 32)
    return max(rows, cluster)


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


@functools.lru_cache(maxsize=None)
def kernel_refusal(T: int, d_model: int, n_head: int, kv_bytes: int = 4, bf16: bool = False) -> Optional[str]:
    """None when K1 takes T keys at d_model / n_head heads with K/V of
    `kv_bytes` bytes (K1-bf16 with `bf16`), else the reason it does not:
    the head widths its forward is instantiated for, one block's shared
    memory: path G's mask bits and K/V tiles (K1-bf16's mask bits and each
    key tile's row statistics), which bound T only past 23,000 keys, beyond
    every T at which `jax_kernel_fits`."""
    if n_head < 1 or d_model % n_head or d_model // n_head not in _HEAD_DIMS:
        return f"d_head = {d_model}/{n_head} must be one of {_HEAD_DIMS}"
    dh = d_model // n_head
    if (smem_bytes_bf16(T, dh) if bf16 else forward_smem_bytes(T, dh, kv_bytes)) > _SMEM_LIMIT:
        return f"T={T}: the mask bits of {T} keys do not fit one block's shared memory"
    return None


def jax_kernel_fits(S: int, T: int, D: int, kv_bytes: int = 4, row_block: int = -1) -> bool:
    """Whether the JAX package runs its Pallas K1 at this site, the query
    block choice of its `_pallas_forward` (a block of SB query rows, k/v and
    the [SB, T] scores of a scene under a 12 MB VMEM budget a grid step);
    where no block fits it computes the attention in XLA, and the port's
    call site takes the plain version."""
    def fits(sb):
        return sb * D * 8 + 2 * T * D * kv_bytes + sb * T * 9 < 12 * 2**20

    if row_block > 0 and S % row_block == 0 and fits(row_block):
        return True
    if row_block < 0:  # the whole S, else a divisor of S in [32, S / 2], a multiple of 8
        blocks = [S] + [d for d in range(32, S // 2 + 1) if S % d == 0 and d % 8 == 0]
    else:  # _pick_row_block: a divisor of S, a multiple of 8, or S itself
        blocks = [S] if S <= 16 else [d for d in range(8, S + 1) if S % d == 0 and d % 8 == 0] or [S]
    return fits(min(blocks))


def _check_inputs(q, k, v, invalid, n_head):
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
    reason = kernel_refusal(T, D, n_head, k.element_size(), q.dtype == torch.bfloat16)
    if reason is not None:
        raise ValueError(reason)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if invalid.stride(2) != 1:
        raise ValueError("invalid must be contiguous along the target axis")
    if not (q.is_cuda and k.device == q.device and v.device == q.device and invalid.device == q.device):
        raise ValueError("fused_attention_core: q, k, v and invalid must lie on one CUDA device")


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
        ws = workspace(q, T, n_head, k.element_size())
        rc = cuda_build.entry(_KERNEL, "tb_fused_attention", _ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), src_ptr, out.data_ptr(),
            B, S, T, D, n_head, int(k.dtype == torch.bfloat16),
            invalid.stride(0), invalid.stride(1), ws.data_ptr() if ws.numel() else None, ws.numel(),
            cuda_build.stream(q),
        )
        cuda_build.check(rc, "fused_attention_core")
        LAUNCHES += 1
    if src_invalid is not None:
        LAUNCHES_SKIP += 1
    return out
