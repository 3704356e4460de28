"""Counter-based dropout (K5): the port's one source of dropout bits.

Replaces `trafficbots_tpu/ops/kernel_common.py` `dropout_mask` (the TPU's
hardware PRNG re-seeded per (seed, site) inside the training kernels) and
flax's `nn.Dropout` at every other site. Neither stream can be reproduced on
the card, so every dropout site of the port draws from one Philox4x32-10
(`csrc/philox.cuh`), keyed by a 64-bit seed. The mask of an element depends
only on (seed, site, its coordinates): a tensor of shape [..., C] is read as
[rows, C], row = the flat index of the leading coordinates, col = the last,
and the Philox counter is (col // 4, site, row low word, row high word); word
col % 4 of the output decides the element. Keep iff bits >= threshold(p),
kept elements scale by 1 / (1 - p), as `kernel_common.dropout_mask` does.

`dropout_mask_plain` computes the same bits with int64 tensor ops. The 32 x
32 -> 64-bit products of the Philox rounds overflow int64, so each is split
into 16-bit limbs of the multiplier. `dropout(x, p, seed, site)` launches
`csrc/dropout.cu` on a CUDA tensor (an autograd Function whose backward is
the same kernel on the cotangent, or the bare launch where autograd does not
record) and takes the plain version on a CPU tensor. Two fused entries fold
a neighbour into the same launch: `dropout_add(res, x, ...)` = res +
dropout(x) and `relu_dropout(x, ...)` = relu(dropout(x)), each one launch
forward and one backward, bit for bit their plain compositions. The C
entries are bound once (`cuda_build.entry`) and threshold / scale cached per
p: at the training step's small shapes the host's cost of a call is what a
call costs. `LAUNCHES` counts every K5 entry's kernel launches; the
attention and node-encoder kernels draw the same bits inside their own
launches.

Seeds: `DropoutSeeds(seed)` hands out one seed per dropout call, in call
order, from a CPU generator seeded by one integer. The training rollout
seeds it per step with a number drawn outside the checkpointed step body, so
the recompute under `torch.utils.checkpoint` draws the same seeds (its
`preserve_rng_state` restores only the default generators, not this one).
Seeds live on the host: drawing one costs no device sync.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import cuda_build

Tensor = torch.Tensor

LAUNCHES = 0

_KERNEL = "dropout"
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
SEED_BITS = 62


@functools.lru_cache(maxsize=None)
def threshold(p: float) -> int:
    """The keep threshold on a 32-bit draw: bits >= threshold keep."""
    return min(int(p * 2**32), 2**32 - 1)


@functools.lru_cache(maxsize=None)
def keep_scale(p: float) -> float:
    """The float32 factor of a kept element: 1 / (1 - p) rounded to float32
    (to nearest, as a float32 tensor would hold it), cached per p."""
    return float(np.float32(1.0 / (1.0 - p)))


def _mulhilo(m: int, c: Tensor) -> Tuple[Tensor, Tensor]:
    """(hi, lo) 32-bit words of m * c for c in [0, 2^32), in int64 without
    overflow: m is split into two 16-bit limbs."""
    p_lo = c * (m & 0xFFFF)  # < 2^48
    p_hi = c * (m >> 16)  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0: Tensor, c1: Tensor, c2: Tensor, c3: Tensor, k0: int, k1: int) -> List[Tensor]:
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcast)."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def keep_factors(seed: int, site: int, p: float, rows: Tensor, cols: Tensor) -> Tensor:
    """float32 dropout factors (0 or 1/(1-p)) of the elements at (rows,
    cols), two int64 tensors broadcast against each other."""
    rows, cols = torch.broadcast_tensors(rows.long(), cols.long())
    zero = torch.zeros_like(rows)
    words = philox4x32_10(cols >> 2, zero + site, rows & _MASK32, rows >> 32, seed & _MASK32, seed >> 32)
    lane = cols & 3
    bits = torch.where(lane == 0, words[0], torch.where(lane == 1, words[1], torch.where(lane == 2, words[2], words[3])))
    return torch.where(bits >= threshold(p), keep_scale(p), 0.0).to(torch.float32)


def dropout_mask_plain(shape, seed: int, site: int, p: float, device=None) -> Tensor:
    """The [*shape] float32 mask (0 or 1/(1-p)) of one dropout site."""
    C = shape[-1]
    n_rows = 1
    for s in shape[:-1]:
        n_rows *= s
    rows = torch.arange(n_rows, device=device)[:, None]
    cols = torch.arange(C, device=device)[None, :]
    return keep_factors(seed, site, p, rows, cols).reshape(shape)


_DROP_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
              ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p)
_ADD_ARGS = (ctypes.c_void_p,) + _DROP_ARGS
_RELU_BWD_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p)


def _check(x: Tensor, what: str = "dropout") -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if x.ndim == 0:
        raise ValueError(f"{what}: x must have at least one dimension")


def _check_seed(seed: int) -> None:
    if not 0 <= seed < 2**64:
        raise ValueError(f"dropout: seed {seed} is not a 64-bit unsigned integer")


def _rows(x: Tensor) -> Tuple[int, int]:
    C = x.shape[-1]
    return (x.numel() // C if C else 0), C


def _launch(x: Tensor, p: float, seed: int, site: int) -> Tensor:
    """out = x * mask: one launch of tb_dropout."""
    global LAUNCHES
    out = torch.empty_like(x)
    rc = cuda_build.entry(_KERNEL, "tb_dropout", _DROP_ARGS)(
        x.data_ptr(), out.data_ptr(), *_rows(x), seed, site, threshold(p), keep_scale(p), cuda_build.stream(x))
    cuda_build.check(rc, "dropout")
    LAUNCHES += 1
    return out


def _launch_add(res: Tensor, x: Tensor, p: float, seed: int, site: int) -> Tensor:
    """out = res + x * mask: one launch of tb_dropout_add."""
    global LAUNCHES
    out = torch.empty_like(x)
    rc = cuda_build.entry(_KERNEL, "tb_dropout_add", _ADD_ARGS)(
        res.data_ptr(), x.data_ptr(), out.data_ptr(), *_rows(x), seed, site, threshold(p), keep_scale(p),
        cuda_build.stream(x))
    cuda_build.check(rc, "dropout_add")
    LAUNCHES += 1
    return out


def _launch_relu(x: Tensor, p: float, seed: int, site: int) -> Tensor:
    """out = relu(x * mask): one launch of tb_relu_dropout."""
    global LAUNCHES
    out = torch.empty_like(x)
    rc = cuda_build.entry(_KERNEL, "tb_relu_dropout", _DROP_ARGS)(
        x.data_ptr(), out.data_ptr(), *_rows(x), seed, site, threshold(p), keep_scale(p), cuda_build.stream(x))
    cuda_build.check(rc, "relu_dropout")
    LAUNCHES += 1
    return out


def _launch_relu_bwd(g: Tensor, y: Tensor, p: float) -> Tensor:
    """dx = g * scale where y > 0, else 0: one launch of tb_relu_dropout_bwd."""
    global LAUNCHES
    dx = torch.empty_like(y)
    rc = cuda_build.entry(_KERNEL, "tb_relu_dropout_bwd", _RELU_BWD_ARGS)(
        g.data_ptr(), y.data_ptr(), dx.data_ptr(), y.numel(), keep_scale(p), cuda_build.stream(y))
    cuda_build.check(rc, "relu_dropout backward")
    LAUNCHES += 1
    return dx


def _records(*xs: Tensor) -> bool:
    """Whether autograd records a call on these inputs."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, seed, site):
        ctx.args = (p, seed, site)
        return _launch(x, p, seed, site)

    @staticmethod
    def backward(ctx, g):
        return _launch(g.contiguous(), *ctx.args), None, None, None


class _DropoutAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, res, x, p, seed, site):
        ctx.args = (p, seed, site)
        return _launch_add(res, x, p, seed, site)

    @staticmethod
    def backward(ctx, g):
        dx = _launch(g.contiguous(), *ctx.args) if ctx.needs_input_grad[1] else None
        return g, dx, None, None, None


class _ReluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, seed, site):
        y = _launch_relu(x, p, seed, site)
        ctx.save_for_backward(y)
        ctx.p = p
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _launch_relu_bwd(g.contiguous(), y, ctx.p), None, None, None


def dropout_plain(x: Tensor, p: float, seed: int, site: int) -> Tensor:
    """The plain version: x times the plain mask."""
    return x * dropout_mask_plain(tuple(x.shape), seed, site, p, device=x.device) if p > 0 else x


def dropout(x: Tensor, p: float, seed: int, site: int) -> Tensor:
    """Inverted dropout of x at (seed, site): the kernel on a CUDA tensor
    (through an autograd Function only where autograd records), the plain
    version on a CPU tensor. p == 0 returns x."""
    if p <= 0:
        return x
    _check_seed(seed)
    if x.device.type == "cpu":
        return dropout_plain(x, p, seed, site)
    _check(x)
    return _Dropout.apply(x, p, seed, site) if _records(x) else _launch(x, p, seed, site)


def dropout_add(res: Tensor, x: Tensor, p: float, seed: int, site: int) -> Tensor:
    """res + dropout(x) in one launch on CUDA tensors (backward: res gets
    the cotangent, x its dropout, one launch); on CPU tensors the plain
    composition. Bit for bit the plain composition on the card too."""
    if p <= 0:
        return res + x
    _check_seed(seed)
    if x.device.type == "cpu":
        return res + dropout_plain(x, p, seed, site)
    _check(x, "dropout_add")
    _check(res, "dropout_add")
    if res.shape != x.shape or res.device != x.device:
        raise ValueError(f"dropout_add: res {tuple(res.shape)} and x {tuple(x.shape)} must match")
    return _DropoutAdd.apply(res, x, p, seed, site) if _records(res, x) else _launch_add(res, x, p, seed, site)


def relu_dropout_plain(x: Tensor, p: float, seed: int, site: int) -> Tensor:
    """The plain version of relu_dropout: relu(dropout(x)), which equals
    dropout(relu(x)) value for value (the scale is positive)."""
    return torch.relu(dropout_plain(x, p, seed, site))


def relu_dropout(x: Tensor, p: float, seed: int, site: int) -> Tensor:
    """relu and dropout of x in one launch on a CUDA tensor; the backward,
    one launch, needs only the output (g * scale where it is > 0). The plain
    version on a CPU tensor."""
    if p <= 0:
        return torch.relu(x)
    _check_seed(seed)
    if x.device.type == "cpu":
        return relu_dropout_plain(x, p, seed, site)
    _check(x, "relu_dropout")
    return _ReluDropout.apply(x, p, seed, site) if _records(x) else _launch_relu(x, p, seed, site)


class SavedCores:
    """The training attention cores' outputs of one checkpointed rollout
    step (remat_policy "save_attn", and "save_core" with it): the step's
    first forward appends each core's (out, row max, row sum); the
    recompute in the backward replays them in the same order instead of
    launching the forward kernel again."""

    def __init__(self):
        self.entries: List[Tuple[Tensor, Tensor, Tensor]] = []
        self.pos = 0

    def rewind(self) -> None:
        self.pos = 0

    def take(self) -> Optional[Tuple[Tensor, Tensor, Tensor]]:
        if self.pos < len(self.entries):
            self.pos += 1
            return self.entries[self.pos - 1]
        return None

    def put(self, entry: Tuple[Tensor, Tensor, Tensor]) -> None:
        self.entries.append(entry)
        self.pos = len(self.entries)


class DropoutSeeds:
    """Seeds of one forward pass's dropout calls, one per call in call order,
    from a CPU generator seeded by `seed`. `saved_cores` carries the
    save_attn residuals of a checkpointed rollout step (rewound here, since
    the recompute builds a new DropoutSeeds from the same seed)."""

    def __init__(self, seed: int, saved_cores: Optional[SavedCores] = None):
        self._gen = torch.Generator().manual_seed(seed)
        self.saved_cores = saved_cores
        if saved_cores is not None:
            saved_cores.rewind()

    def next(self) -> int:
        return int(torch.randint(0, 2**SEED_BITS, (1,), generator=self._gen).item())

    def generator(self, device) -> torch.Generator:
        """A generator on `device` for a stochastic sample inside the pass."""
        return torch.Generator(device=device).manual_seed(self.next())
