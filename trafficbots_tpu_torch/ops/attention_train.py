"""Training attention core with weight dropout (K3): CUDA kernels and their plain version.

Replaces the Pallas kernel pair `trafficbots_tpu/ops/attention_train.py`
(`fused_attention_train` -> `_fwd_kernel` / `_fwd_kernel_qb`, and its custom
VJP `_vjp_bwd` -> `_bwd_kernel` / `_bwd_kernel_qb`). Per head,

    A = softmax(q_h k_hᵀ / sqrt(d_head), masked);  out_h = (A ⊙ M) v_h

with `invalid` [B, S, T] True = disallowed target and M the inverted-dropout
mask of the weights from the port's Philox (`ops.dropout`; the logical
tensor [B, H, S, T], row (b H + h) S + s, col t, at (seed, site)). A row whose
targets are ALL disallowed comes out exactly 0 and gets no gradient.

`src_invalid` [B, S] True marks dead query rows (padding agents or
polylines; the JAX kernels' dead-block skip, fed by `row_live`, forward
and backward). Every row that is not `fused_attention.row_live` comes out
0 and takes no part in the backward, in the kernels and in the plain
version; a live row's output, its dropout bits and its statistics are
those without `src_invalid`. The JAX kernels compute the dead rows of a
partly live block; their callers zero them, so the two agree wherever a
value is read, and with the callers' zero cotangent on dead rows the
gradients are the same.

`kernel_refusal` is K3's shape predicate: None where the kernels take a
shape, else the reason they do not; `_check_inputs` raises with that
reason, so a CUDA tensor the kernels refuse raises. `jax_kernel_fits` is
the JAX package's own choice between its Pallas kernel and XLA, which the
call site (`models.modules.Attention`) follows.

`attention_train_plain` is plain tensor code that autograd differentiates.
`attention_train` sends a CUDA tensor to `csrc/attention_train.cu` (its
forward is K1's, `csrc/attn_fwd.cuh`, with the dropout factors and the row
statistics) through an autograd Function whose backward is the kernels' dq
and dk/dv pair (streamed 64-wide tiles, FlashAttention-2 style; see the
source), and a CPU tensor to the plain version; it never falls back from
one to the other.
`LAUNCHES_FWD` / `LAUNCHES_BWD` count the forward kernel's launches and the
backward's (one per backward call, which launches its two kernels);
`LAUNCHES_FWD_SKIP` / `LAUNCHES_BWD_SKIP` count those of them that carry
`src_invalid` (the backward of a forward that did).

`saved` (ops.dropout.SavedCores) is the rollout's save_attn residual: when it
holds this call's forward (the recompute of a checkpointed step), the
Function replays it instead of launching the forward kernel again.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import cuda_build, fused_attention, round_to
from .dropout import SavedCores, dropout_plain, keep_scale, threshold

Tensor = torch.Tensor

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
LAUNCHES_FWD_SKIP = 0
LAUNCHES_BWD_SKIP = 0

_KERNEL = "attention_train"
HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernels are instantiated for
ROWS_PER_BLOCK = fused_attention.ROWS_PER_BLOCK  # the forward is K1's (csrc/attn_fwd.cuh)
BWD_TILE = 64  # BT: keys of a backward tile, query rows of a dk/dv step
DQ_ROWS = (16, 64)  # the dq kernel's query blocks (16 where 64 gives < 128 blocks, up to d_head 64)
DQ_WIDE = 64  # past this d_head the dq kernel takes 64-row blocks only (the 16-row one's tiles do not fit)
_PAD = 4  # PAD: floats after each transposed tile row
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use on sm_90
_SHAPE_DROP_ARGS = ((ctypes.c_int,) * 5 + (ctypes.c_longlong,) * 2
                    + (ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_FWD_ARGS = (ctypes.c_void_p,) * 8 + _SHAPE_DROP_ARGS[:-1] + (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)
_BWD_ARGS = (ctypes.c_void_p,) * 12 + _SHAPE_DROP_ARGS


def attention_train_plain(q: Tensor, k: Tensor, v: Tensor, invalid: Tensor, n_head: int,
                          p: float, seed: int, site: int, dropout=dropout_plain, need_weights: bool = False,
                          lowp: Optional[torch.dtype] = None, src_invalid: Optional[Tensor] = None):
    """The plain version: q [B,S,D], k/v [B,T,D] fp32, invalid [B,S,T] bool
    -> [B,S,D]; dropout of the weights at (seed, site) when p > 0, by
    `dropout` (the plain mask; the training attention below K3's gate
    passes the K5 entry, which draws the same bits in one launch). With
    `need_weights` -> (out, the weights [B,H,S,T] after their dropout).

    `lowp` (bf16) computes the JAX package's XLA attention on bf16
    operands instead (its sites below the kernels' shapes): both einsums'
    operands and results rounded to bf16 with fp32 accumulation, the
    logits widened for the fp32 softmax and dropout; fp32 tensors in and
    out. Rows that are not `row_live(invalid, src_invalid)` come out 0."""
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
    dead = no_valid if src_invalid is None else ~fused_attention.row_live(invalid, src_invalid)
    out = torch.where(dead[..., None], torch.zeros_like(out), out)
    return (out, attn) if need_weights else out


def smem_bytes(T: int, d_head: int) -> int:
    """The largest dynamic shared memory of a block among the kernels
    (mirrors csrc/attn_fwd.cuh and csrc/attention_train.cu): the forward's
    (K1's blocks at fp32 K/V: path L's or S's, or path G's where path L's
    logits do not fit), the dq kernel's tiles at each query block it takes
    at this d_head, the dk/dv kernel's (the backward's do not grow with
    T)."""
    wide = BWD_TILE + _PAD

    def dq(bq):
        return 2 * d_head * (bq + _PAD) + 3 * bq + 256 // (4 * bq) * (2 * d_head + bq) * wide

    dkdv = (4 * d_head + 2 * BWD_TILE) * wide + 3 * BWD_TILE
    dq_rows = DQ_ROWS if d_head <= DQ_WIDE else (64,)
    return max(fused_attention.forward_smem_bytes(T, d_head, 4), 4 * max(dkdv, *(dq(bq) for bq in dq_rows)))


@functools.lru_cache(maxsize=None)
def kernel_refusal(T: int, d_model: int, n_head: int) -> Optional[str]:
    """None when K3 takes T keys at d_model / n_head heads, else the
    reason it does not: the head widths its kernels are instantiated for,
    every kernel's block in shared memory (`smem_bytes`: past path L's
    logits, path G's mask bits bound T)."""
    if n_head < 1 or d_model % n_head or d_model // n_head not in HEAD_DIMS:
        return f"d_head = {d_model}/{n_head} must be one of {HEAD_DIMS}"
    if smem_bytes(T, d_model // n_head) > SMEM_LIMIT:
        return f"T={T}: the mask bits of {T} keys do not fit one block's shared memory"
    return None


def jax_kernel_fits(S: int, T: int, D: int) -> bool:
    """Whether the JAX package runs its Pallas K3 at this site, its
    `fused_attention_train_fits`: a group of whole scenes, or a block of
    query rows of one scene, whose backward working set fits a 24 MB VMEM
    budget. Elsewhere it differentiates the XLA attention, and the port's
    call site takes the plain version."""
    budget = 24 * 2**20
    if 4 * (4 * T * D + 4 * S * D + 6 * S * T) < budget:  # one scene a grid step
        return True
    return any(S % sb == 0 and 4 * (4 * T * D + 3 * sb * D + 6 * sb * T) < budget for sb in (256, 128, 64, 32))


def _check_inputs(q, k, v, invalid, n_head):
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
    reason = kernel_refusal(T, D, n_head)
    if reason is not None:
        raise ValueError(reason)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if invalid.stride(2) != 1:
        raise ValueError("invalid must be contiguous along the target axis")
    if not (q.is_cuda and k.device == q.device and v.device == q.device and invalid.device == q.device):
        raise ValueError("attention_train: q, k, v and invalid must lie on one CUDA device")


def _dropout_args(p: float, seed: int, site: int):
    """(seed, site, threshold, scale, on) as the C entries take them."""
    return (seed, site, threshold(p), keep_scale(p), 1) if p > 0 else (0, site, 0, 1.0, 0)


def _launch_fwd(q, k, v, invalid, n_head, p, seed, site, src_invalid=None):
    global LAUNCHES_FWD, LAUNCHES_FWD_SKIP
    B, S, D = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    rmax = torch.empty((B, n_head, S), dtype=torch.float32, device=q.device)
    rsum = torch.empty_like(rmax)
    ws = fused_attention.workspace(q, T, n_head, 4)
    rc = cuda_build.entry(_KERNEL, "tb_attention_train_fwd", _FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), fused_attention.check_src_invalid(src_invalid, q),
        out.data_ptr(), rmax.data_ptr(), rsum.data_ptr(), B, S, T, D, n_head, invalid.stride(0), invalid.stride(1),
        *_dropout_args(p, seed, site), ws.data_ptr() if ws.numel() else None, ws.numel(), cuda_build.stream(q),
    )
    cuda_build.check(rc, "attention_train forward")
    LAUNCHES_FWD += 1
    if src_invalid is not None:
        LAUNCHES_FWD_SKIP += 1
    return out, rmax, rsum


def _launch_bwd(q, k, v, invalid, out, rmax, rsum, g, n_head, p, seed, site, skip=False):
    """The backward of a forward's (out, rmax, rsum); `skip`: that forward
    carried `src_invalid` (its dead rows' rmax is -inf, which drops them
    here), counted in LAUNCHES_BWD_SKIP."""
    global LAUNCHES_BWD, LAUNCHES_BWD_SKIP
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
    if skip:
        LAUNCHES_BWD_SKIP += 1
    return dq, dk, dv


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, invalid, n_head, p, seed, site, saved, src_invalid):
        entry = saved.take() if saved is not None else None
        if entry is None:
            entry = _launch_fwd(q, k, v, invalid, n_head, p, seed, site, src_invalid)
            if saved is not None:
                saved.put(tuple(t.detach() for t in entry))
        out, rmax, rsum = entry
        ctx.save_for_backward(q, k, v, invalid, out, rmax, rsum)
        ctx.args = (n_head, p, seed, site, src_invalid is not None)
        return out.clone() if saved is not None else out

    @staticmethod
    def backward(ctx, g):
        q, k, v, invalid, out, rmax, rsum = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, invalid, out, rmax, rsum, g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def attention_train(q: Tensor, k: Tensor, v: Tensor, invalid: Tensor, n_head: int, p: float,
                    seed: int, site: int, saved: Optional[SavedCores] = None,
                    src_invalid: Optional[Tensor] = None) -> Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors. `invalid` may
    be a stride-0 expand over S (a padding mask), read through its strides.
    `src_invalid` [B, S] (dead query rows) turns the dead-query-row skip on.
    A `saved` replay holds the forward of this same call, skip included."""
    if q.device.type == "cpu":
        return attention_train_plain(q, k, v, invalid, n_head, p, seed, site, src_invalid=src_invalid)
    _check_inputs(q, k, v, invalid, n_head)
    if src_invalid is not None:
        src_invalid = src_invalid.contiguous()
    if q.shape[0] * q.shape[1] == 0:
        return torch.zeros_like(q)
    return _AttentionTrain.apply(q, k, v, invalid, n_head, p, seed, site, saved, src_invalid)
