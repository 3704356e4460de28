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
`LAUNCHES_FWD` / `LAUNCHES_BWD` count the forward's and the backward's
launches (one call of each C entry; the backward's entry launches seven
kernels: the groups' row counts and offsets, the transposed weights, the
forward saving each layer, the walk down the layers, the weight products
and the fixed-order sums).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build
from .dropout import keep_scale, threshold
from .node_encoder import KERNEL_D, NEG, W_NAMES, FusedNodeEncoder

Tensor = torch.Tensor

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

_KERNEL = "node_encoder_train"
KERNEL_MAX_NODES = 32  # MAXN in csrc/node_encoder_train.cu and csrc/node_layer.cuh
# K2's heads up to MAXH (csrc/node_layer.cuh): the backward keeps 3 row statistics a (head, node)
TRAIN_HEADS = (4, 8)
_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")


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


def n_params(n_layer: int) -> int:
    """Length of the flat gradient of the 18 stacked arrays."""
    return n_layer * (len(_MATRICES) * KERNEL_D * KERNEL_D + (len(W_NAMES) - len(_MATRICES)) * KERNEL_D)


def _weight_ptrs(weights):
    return (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])


def _drop_args(p: float, seed: int):
    return (seed, threshold(p), keep_scale(p), 1) if p > 0 else (0, 0, 1.0, 0)


_FWD_ARGS = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
_BWD_ARGS = (ctypes.c_void_p,) * 3 + _FWD_ARGS[:-1] + (ctypes.c_int, ctypes.c_void_p)
_SCRATCH_ARGS = (ctypes.c_int,) * 4 + (ctypes.POINTER(ctypes.c_longlong),)


def _launch_fwd(x, valid, p, seed, n_layer, n_head, weights):
    global LAUNCHES_FWD
    BP, N, D = x.shape
    out = torch.empty((BP, D), dtype=torch.float32, device=x.device)
    ptrs = _weight_ptrs(weights)
    rc = cuda_build.entry(_KERNEL, "tb_node_encoder_train_fwd", _FWD_ARGS)(
        x.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, N, n_layer, n_head,
        ctypes.cast(ptrs, ctypes.c_void_p), *_drop_args(p, seed), cuda_build.stream(x))
    cuda_build.check(rc, "node_encoder_train forward")
    LAUNCHES_FWD += 1
    return out


def _launch_bwd(x, valid, g, p, seed, n_layer, n_head, weights):
    """dx and the flat weight gradient [n_params]. The scratch holds the
    saved rows of every node that could be valid (BP N), so its size needs
    no read of `valid` on the host: 3.0 GB at BP = 8192, N = 20, L = 3."""
    global LAUNCHES_BWD
    BP, N, D = x.shape
    nblocks = cuda_build.entry(_KERNEL, "tb_node_encoder_train_nblocks", ())()
    n_scratch = ctypes.c_longlong()
    scratch_floats = cuda_build.entry(_KERNEL, "tb_node_encoder_train_scratch", _SCRATCH_ARGS)
    scratch_floats(BP, N, n_layer, nblocks, ctypes.byref(n_scratch))
    dx = torch.empty_like(x)
    scratch = torch.empty((n_scratch.value,), dtype=torch.float32, device=x.device)
    dw = torch.empty((n_params(n_layer),), dtype=torch.float32, device=x.device)
    ptrs = _weight_ptrs(weights)
    rc = cuda_build.entry(_KERNEL, "tb_node_encoder_train_bwd", _BWD_ARGS)(
        x.data_ptr(), valid.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(), dw.data_ptr(), BP, N,
        n_layer, n_head, ctypes.cast(ptrs, ctypes.c_void_p), *_drop_args(p, seed), nblocks, cuda_build.stream(x))
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


def _check_inputs(enc: FusedNodeEncoder, x: Tensor, valid: Tensor) -> None:
    if not (x.is_cuda and valid.device == x.device):
        raise ValueError("node_encoder_train: x and valid must lie on one CUDA device")
    if x.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"x must be float32 and valid bool, got {x.dtype}/{valid.dtype}")
    if x.ndim != 3 or tuple(valid.shape) != tuple(x.shape[:2]):
        raise ValueError(f"bad shapes x {tuple(x.shape)} valid {tuple(valid.shape)}")
    if not (x.is_contiguous() and valid.is_contiguous()):
        raise ValueError("x and valid must be contiguous")
    N, D = x.shape[1], x.shape[2]
    if D != KERNEL_D or enc.d_model != KERNEL_D or enc.d_feedforward != KERNEL_D:
        raise ValueError(f"the kernel takes d_model = d_feedforward = {KERNEL_D}")
    if not 1 <= N <= KERNEL_MAX_NODES or enc.n_head not in TRAIN_HEADS:
        raise ValueError(f"the kernels take 1..{KERNEL_MAX_NODES} nodes and n_head in {TRAIN_HEADS}")
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
