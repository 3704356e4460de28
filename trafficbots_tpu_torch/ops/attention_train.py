"""Training attention core with weight dropout (K3): CUDA kernels and their plain version.

Replaces the Pallas kernel pair `trafficbots_tpu/ops/attention_train.py`
(`fused_attention_train` -> `_fwd_kernel` / `_fwd_kernel_qb`, and its custom
VJP `_vjp_bwd` -> `_bwd_kernel` / `_bwd_kernel_qb`). Per head,

    A = softmax(q_h k_hᵀ / sqrt(d_head), masked);  out_h = (A ⊙ M) v_h

with `invalid` [B, S, T] True = disallowed target and M the inverted-dropout
mask of the weights from the port's Philox (`ops.dropout`; the logical
tensor [B, H, S, T], row (b H + h) S + s, col t, at (seed, site)). A row whose
targets are ALL disallowed comes out exactly 0 and gets no gradient.

`attention_train_plain` is plain tensor code that autograd differentiates.
`attention_train` sends a CUDA tensor to `csrc/attention_train.cu` (its
forward is K1's, `csrc/attn_fwd.cuh`, with the dropout factors and the row
statistics) through an autograd Function whose backward is the kernels' dq
and dk/dv pair (streamed 64-wide tiles, FlashAttention-2 style; see the
source), and a CPU tensor to the plain version; it never falls back from
one to the other.
`LAUNCHES_FWD` / `LAUNCHES_BWD` count the forward kernel's launches and the
backward's (one per backward call, which launches its two kernels).

`saved` (ops.dropout.SavedCores) is the rollout's save_attn residual: when it
holds this call's forward (the recompute of a checkpointed step), the
Function replays it instead of launching the forward kernel again.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_build, fused_attention, round_to
from .dropout import SavedCores, dropout_plain, keep_scale, threshold

Tensor = torch.Tensor

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

_KERNEL = "attention_train"
HEAD_DIMS = (16, 32)  # the head widths the kernels are instantiated for
ROWS_PER_BLOCK = fused_attention.ROWS_PER_BLOCK  # the forward is K1's (csrc/attn_fwd.cuh)
BWD_TILE = 64  # BT: keys of a backward tile, query rows of a dk/dv step
DQ_ROWS = (16, 64)  # the dq kernel's query blocks (16 where 64 gives < 128 blocks)
_PAD = 4  # PAD: floats after each transposed tile row
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on sm_90
_FWD_ARGS = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (ctypes.c_longlong,) * 2
             + (ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_BWD_ARGS = (ctypes.c_void_p,) * 5 + _FWD_ARGS


def attention_train_plain(q: Tensor, k: Tensor, v: Tensor, invalid: Tensor, n_head: int,
                          p: float, seed: int, site: int, dropout=dropout_plain, need_weights: bool = False,
                          lowp: Optional[torch.dtype] = None):
    """The plain version: q [B,S,D], k/v [B,T,D] fp32, invalid [B,S,T] bool
    -> [B,S,D]; dropout of the weights at (seed, site) when p > 0, by
    `dropout` (the plain mask; the training attention below K3's gate
    passes the K5 entry, which draws the same bits in one launch). With
    `need_weights` -> (out, the weights [B,H,S,T] after their dropout).

    `lowp` (bf16) computes the JAX package's XLA attention on bf16
    operands instead (its sites below the kernels' shapes): both einsums'
    operands and results rounded to bf16 with fp32 accumulation, the
    logits widened for the fp32 softmax and dropout; fp32 tensors in and
    out."""
    B, S, D = q.shape
    T = k.shape[1]
    dh = D // n_head

    def rnd(x: Tensor) -> Tensor:
        return x if lowp is None else round_to(x, lowp)

    qh = rnd(q).reshape(B, S, n_head, dh)
    kh = rnd(k).reshape(B, T, n_head, dh)
    vh = rnd(v).reshape(B, T, n_head, dh)
    logits = rnd(torch.einsum("bshd,bthd->bhst", qh, kh))
    no_valid = invalid.all(dim=-1)  # [B, S]
    use_mask = invalid & ~no_valid[..., None]
    logits = logits.masked_fill(use_mask[:, None], float("-inf"))
    attn = torch.softmax(logits / math.sqrt(dh), dim=-1)
    if p > 0:
        attn = dropout(attn, p, seed, site)
    out = rnd(torch.einsum("bhst,bthd->bshd", rnd(attn), vh)).reshape(B, S, D)
    out = torch.where(no_valid[..., None], torch.zeros_like(out), out)
    return (out, attn) if need_weights else out


def smem_bytes(T: int, d_head: int) -> int:
    """The largest dynamic shared memory of a block among the kernels
    (mirrors csrc/attn_fwd.cuh and csrc/attention_train.cu): the forward's
    (K1's blocks at fp32 K/V), the dq kernel's tiles at either query block,
    the dk/dv kernel's."""
    wide = BWD_TILE + _PAD

    def dq(bq):
        return 2 * d_head * (bq + _PAD) + 3 * bq + 256 // (4 * bq) * (2 * d_head + bq) * wide

    dkdv = (4 * d_head + 2 * BWD_TILE) * wide + 3 * BWD_TILE
    return max(fused_attention.smem_bytes(T, d_head, 4), 4 * max(dkdv, *(dq(bq) for bq in DQ_ROWS)))


def _check_inputs(q, k, v, invalid, n_head):
    if not (q.is_cuda and k.device == q.device and v.device == q.device and invalid.device == q.device):
        raise ValueError("attention_train: q, k, v and invalid must lie on one CUDA device")
    if q.dtype != torch.float32 or k.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"q, k and v must be float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if invalid.dtype != torch.bool:
        raise TypeError(f"invalid must be bool, got {invalid.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, S, D = q.shape
    T = k.shape[1]
    if k.shape[0] != B or k.shape[2] != D or tuple(invalid.shape) != (B, S, T):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} invalid {tuple(invalid.shape)}")
    if D % n_head or D // n_head not in HEAD_DIMS:
        raise ValueError(f"d_head = {D}/{n_head} must be one of {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if invalid.stride(2) != 1:
        raise ValueError("invalid must be contiguous along the target axis")
    if smem_bytes(T, D // n_head) > SMEM_LIMIT:
        raise ValueError(f"T={T} does not fit one block's shared memory")


def _dropout_args(p: float, seed: int, site: int):
    """(seed, site, threshold, scale, on) as the C entries take them."""
    return (seed, site, threshold(p), keep_scale(p), 1) if p > 0 else (0, site, 0, 1.0, 0)


def _launch_fwd(q, k, v, invalid, n_head, p, seed, site):
    global LAUNCHES_FWD
    B, S, D = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    rmax = torch.empty((B, n_head, S), dtype=torch.float32, device=q.device)
    rsum = torch.empty_like(rmax)
    rc = cuda_build.entry(_KERNEL, "tb_attention_train_fwd", _FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), out.data_ptr(), rmax.data_ptr(),
        rsum.data_ptr(), B, S, T, D, n_head, invalid.stride(0), invalid.stride(1), *_dropout_args(p, seed, site),
        cuda_build.stream(q),
    )
    cuda_build.check(rc, "attention_train forward")
    LAUNCHES_FWD += 1
    return out, rmax, rsum


def _launch_bwd(q, k, v, invalid, out, rmax, rsum, g, n_head, p, seed, site):
    global LAUNCHES_BWD
    B, S, D = q.shape
    T = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty_like(rmax)  # D = g . out of each row, from the dq kernel to the dk/dv kernel
    rc = cuda_build.entry(_KERNEL, "tb_attention_train_bwd", _BWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), out.data_ptr(), rmax.data_ptr(),
        rsum.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), B, S, T, D,
        n_head, invalid.stride(0), invalid.stride(1), *_dropout_args(p, seed, site), cuda_build.stream(q),
    )
    cuda_build.check(rc, "attention_train backward")
    LAUNCHES_BWD += 1
    return dq, dk, dv


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, invalid, n_head, p, seed, site, saved):
        entry = saved.take() if saved is not None else None
        if entry is None:
            entry = _launch_fwd(q, k, v, invalid, n_head, p, seed, site)
            if saved is not None:
                saved.put(tuple(t.detach() for t in entry))
        out, rmax, rsum = entry
        ctx.save_for_backward(q, k, v, invalid, out, rmax, rsum)
        ctx.args = (n_head, p, seed, site)
        return out.clone() if saved is not None else out

    @staticmethod
    def backward(ctx, g):
        q, k, v, invalid, out, rmax, rsum = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, invalid, out, rmax, rsum, g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def attention_train(q: Tensor, k: Tensor, v: Tensor, invalid: Tensor, n_head: int, p: float,
                    seed: int, site: int, saved: Optional[SavedCores] = None) -> Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors. `invalid` may
    be a stride-0 expand over S (a padding mask), read through its strides."""
    if q.device.type == "cpu":
        return attention_train_plain(q, k, v, invalid, n_head, p, seed, site)
    _check_inputs(q, k, v, invalid, n_head)
    if q.shape[0] * q.shape[1] == 0:
        return torch.zeros_like(q)
    return _AttentionTrain.apply(q, k, v, invalid, n_head, p, seed, site, saved)
