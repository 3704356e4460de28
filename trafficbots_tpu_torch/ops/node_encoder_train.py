"""Training node encoder with dropout (K4): CUDA kernels and their plain version.

Replaces the Pallas kernel pair `trafficbots_tpu/ops/node_encoder_train.py`
(`node_encoder_train_pooled` -> `_fwd_kernel`, and its custom VJP
`_vjp_bwd` -> `_bwd_kernel` / `_bwd_block`): the DenseTNT node stack of
`ops.node_encoder.FusedNodeEncoder` plus the masked max-pool, with inverted
dropout at four sites a layer (ops.dropout masks at (seed, 4 l + k): the
attention weights, the out-projection output, the FFN hidden after the ReLU,
the FFN output).

`node_encoder_train_plain` is `FusedNodeEncoder.forward` with those masks and
`max_pool_ties`, a masked max-pool whose backward splits each column's
cotangent evenly among the nodes tied at the max, as JAX's `reduce_max` VJP
does (`torch.amax` and `torch.max(dim)` send it elsewhere). Autograd
differentiates it. `node_encoder_train` sends a CUDA tensor to
`csrc/node_encoder_train.cu` through an autograd Function whose backward is
the hand-derived backward kernels, and a CPU tensor to the plain version.
`kernel_refusal` is K4's shape predicate, K2's set (both run
csrc/node_layer.cuh's layer code): None where the kernels take a shape,
else the reason they do not; `_check_inputs` raises with that reason, so a
CUDA tensor the kernels refuse raises. A width pair's kernels are a build
of their own (`ops.node_encoder.build_defines`).
`LAUNCHES_FWD` / `LAUNCHES_BWD` count the forward's and the backward's
launches (one call of each C entry; the backward's entry launches seven
kernels: the groups' row counts and offsets, the transposed weights, the
forward saving each layer, the walk down the layers, the weight products
and the fixed-order sums).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build
from .dropout import keep_scale, threshold
from .node_encoder import NEG, W_NAMES, FusedNodeEncoder, build_defines
from .node_encoder import kernel_refusal as _layer_refusal

Tensor = torch.Tensor

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

_KERNEL = "node_encoder_train"
KERNEL_MAX_NODES = 32  # MAXN in csrc/node_encoder_train.cu and csrc/node_layer.cuh


class _MaxPoolTies(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, valid):
        xm = torch.where(valid[..., None], x, torch.full_like(x, NEG))
        out = xm.amax(dim=1)
        ctx.save_for_backward(xm, out, valid)
        return out

    @staticmethod
    def backward(ctx, g):
        xm, out, valid = ctx.saved_tensors
        top = xm == out[:, None]
        cnt = top.sum(dim=1, keepdim=True).clamp(min=1).to(g.dtype)
        gx = torch.where(top & valid[..., None], (g / cnt[:, 0])[:, None].expand_as(xm), torch.zeros_like(xm))
        return gx, None


def max_pool_ties(x: Tensor, valid: Tensor) -> Tensor:
    """[BP, N, D], [BP, N] -> max over valid nodes [BP, D] (-1e30 for a
    polyline without one); ties share the cotangent evenly."""
    return _MaxPoolTies.apply(x, valid)


def node_encoder_train_plain(enc: FusedNodeEncoder, x: Tensor, valid: Tensor, p: float, seed: int) -> Tensor:
    """The plain version: [BP, N, D] fp32, [BP, N] bool -> pooled [BP, D]."""
    return max_pool_ties(enc(x, valid, p, seed), valid)


def n_params(n_layer: int, d_model: int, d_ff: int) -> int:
    """Length of the flat gradient of the 18 stacked arrays: a layer's
    four [D, D] matrices, w1 [D, F], w2 [F, D], b1 [F] and 11 vectors [D]."""
    D, Fd = d_model, d_ff
    return n_layer * (4 * D * D + 2 * D * Fd + Fd + 11 * D)


def _weight_ptrs(weights):
    return (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])


def _drop_args(p: float, seed: int):
    return (seed, threshold(p), keep_scale(p), 1) if p > 0 else (0, 0, 1.0, 0)


_FWD_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6
             + (ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_BWD_ARGS = (ctypes.c_void_p,) * 3 + _FWD_ARGS[:-1] + (ctypes.c_int, ctypes.c_void_p)
_SCRATCH_ARGS = (ctypes.c_int,) * 7 + (ctypes.POINTER(ctypes.c_longlong),)


def _widths(weights) -> Tuple[int, int]:
    """d_model and d_ff of the 18 stacked arrays (w1 is [L, D, F])."""
    w1 = weights[W_NAMES.index("w1")]
    return w1.shape[1], w1.shape[2]


def _launch_fwd(x, valid, p, seed, n_layer, n_head, weights):
    global LAUNCHES_FWD
    BP, N, D = x.shape
    d_model, d_ff = _widths(weights)
    out = torch.empty((BP, D), dtype=torch.float32, device=x.device)
    ptrs = _weight_ptrs(weights)
    rc = cuda_build.entry(_KERNEL, "tb_node_encoder_train_fwd", _FWD_ARGS, build_defines(d_model, d_ff))(
        x.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, N, n_layer, n_head, d_model, d_ff,
        ctypes.cast(ptrs, ctypes.c_void_p), *_drop_args(p, seed), cuda_build.stream(x))
    cuda_build.check(rc, "node_encoder_train forward")
    LAUNCHES_FWD += 1
    return out


def _launch_bwd(x, valid, g, p, seed, n_layer, n_head, weights):
    """dx and the flat weight gradient [n_params]. The scratch holds the
    saved rows of every node that could be valid (BP N), so its size needs
    no read of `valid` on the host: 3.0 GB at BP = 8192, N = 20, L = 3 and
    d_model = d_ff = 128, (10 D + 2 F) BP N L floats in all."""
    global LAUNCHES_BWD
    BP, N, D = x.shape
    d_model, d_ff = _widths(weights)
    defines = build_defines(d_model, d_ff)
    nblocks = cuda_build.entry(_KERNEL, "tb_node_encoder_train_nblocks", (), defines)()
    n_scratch = ctypes.c_longlong()
    scratch_floats = cuda_build.entry(_KERNEL, "tb_node_encoder_train_scratch", _SCRATCH_ARGS, defines)
    cuda_build.check(scratch_floats(BP, N, n_layer, n_head, d_model, d_ff, nblocks, ctypes.byref(n_scratch)),
                     "node_encoder_train backward's scratch")
    dx = torch.empty_like(x)
    scratch = torch.empty((n_scratch.value,), dtype=torch.float32, device=x.device)
    dw = torch.empty((n_params(n_layer, d_model, d_ff),), dtype=torch.float32, device=x.device)
    ptrs = _weight_ptrs(weights)
    rc = cuda_build.entry(_KERNEL, "tb_node_encoder_train_bwd", _BWD_ARGS, defines)(
        x.data_ptr(), valid.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(), dw.data_ptr(), BP, N,
        n_layer, n_head, d_model, d_ff, ctypes.cast(ptrs, ctypes.c_void_p), *_drop_args(p, seed), nblocks,
        cuda_build.stream(x))
    cuda_build.check(rc, "node_encoder_train backward")
    LAUNCHES_BWD += 1
    return dx, dw


class _NodeEncoderTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, valid, p, seed, n_layer, n_head, *weights):
        ctx.save_for_backward(x, valid, *weights)
        ctx.args = (p, seed, n_layer, n_head)
        return _launch_fwd(x, valid, p, seed, n_layer, n_head, weights)

    @staticmethod
    def backward(ctx, g):
        x, valid, *weights = ctx.saved_tensors
        dx, dw = _launch_bwd(x, valid, g.contiguous(), *ctx.args, weights)
        grads, off = [], 0
        for w in weights:
            grads.append(dw[off:off + w.numel()].view_as(w))
            off += w.numel()
        return (dx, None, None, None, None, None, *grads)


@functools.lru_cache(maxsize=None)
def kernel_refusal(n_node: int, d_model: int, d_feedforward: int, n_head: int) -> Optional[str]:
    """None when K4 takes polylines of n_node nodes at these widths, else
    the reason it does not: K2's set (`ops.node_encoder.kernel_refusal`),
    since K4f and K4b's save kernel run K2's layer code and K4b's walk
    sizes its groups to the heads' row statistics."""
    return _layer_refusal(n_node, d_model, d_feedforward, n_head)


def _check_inputs(enc: FusedNodeEncoder, x: Tensor, valid: Tensor) -> None:
    if x.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"x must be float32 and valid bool, got {x.dtype}/{valid.dtype}")
    if x.ndim != 3 or tuple(valid.shape) != tuple(x.shape[:2]) or x.shape[2] != enc.d_model:
        raise ValueError(f"bad shapes x {tuple(x.shape)} valid {tuple(valid.shape)}")
    reason = kernel_refusal(x.shape[1], enc.d_model, enc.d_feedforward, enc.n_head)
    if reason is not None:
        raise ValueError(reason)
    if not (x.is_contiguous() and valid.is_contiguous()):
        raise ValueError("x and valid must be contiguous")
    if not (x.is_cuda and valid.device == x.device):
        raise ValueError("node_encoder_train: x and valid must lie on one CUDA device")
    for name in W_NAMES:
        w = getattr(enc, name)
        if w.device != x.device or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError(f"parameter {name} must be contiguous float32 on {x.device}")


def node_encoder_train(enc: FusedNodeEncoder, x: Tensor, valid: Tensor, p: float, seed: int) -> Tensor:
    """[BP, N, D] fp32, [BP, N] bool -> pooled [BP, D] with dropout p at
    `seed`: the kernels on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return node_encoder_train_plain(enc, x, valid, p, seed)
    _check_inputs(enc, x, valid)
    if x.shape[0] == 0:
        return x.new_zeros((0, x.shape[2]))
    weights: Tuple[Tensor, ...] = tuple(getattr(enc, n) for n in W_NAMES)
    return _NodeEncoderTrain.apply(x, valid, p, seed, enc.n_layer, enc.n_head, *weights)
