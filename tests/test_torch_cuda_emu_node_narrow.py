"""K2, K2-bf16 and K4 at widths that are not multiples of 128, as CUDA
source run on the CPU against their plain versions.

As tests/test_torch_cuda_emu_node_wide.py does at the widths 128 and 256:
compiles `csrc/node_encoder.cu` and `csrc/node_encoder_train.cu` with g++
against the CUDA emulator in `tests/cuda_emu/`, once a width pair
(ops.node_encoder.build_defines), and holds the kernels at (d_model, d_ff,
n_head) = (64, 64, 2) (the tests/tiny.py widths: one 64-column pass a
product, 64 x 64 dW tiles), (64, 128, 4) (the override
model.hidden_dim=64), (128, 64, 4) (the FFN narrower than the model),
(96, 160, 4) (a 64-column and a 32-column pass after a whole one, the
tensor-core products' k-chunks of 96, 32 x 32 dW tiles), (32, 64, 2) and
(64, 32, 2) (products over 32 rows of W: one k-tile, so the weight ring's
prologue must stage no tile past it) against their plain versions:
polylines of 5 nodes, among which an all-padding and a partly valid one,
2 layers, a few groups of polylines so that a walk block takes more than
one. Every output buffer starts NaN-filled, so a weight gradient the dW
tiles leave unwritten fails its hold, and every weight ends where a page
that may not be read begins (`guarded`), so a read past a weight's end
faults.

Tolerances as in that file: K2 and K4's forward within atol = rtol = 1e-4
of the plain versions; K2-bf16 within a relative norm error of 1e-3 of its
plain version's bf16 function; K4's backward (dx and the 18 weight
gradients) within a relative norm error of 1e-3 of autograd through the
plain version, each gradient against its own norm or 1e-3 of the largest;
the backward with dropout live bitwise equal over two calls, padding
nodes' dx exactly 0; K4f at p = 0 K2 to the bit.
"""
import ctypes
import mmap

import pytest
import torch

from trafficbots_tpu_torch.ops import node_encoder as tne
from trafficbots_tpu_torch.ops import node_encoder_train as tnt

from test_torch_cuda_emu_node import build_emulated, k2, k4_bwd, k4_fwd, weight_ptrs
from test_torch_cuda_emu_node_wide import case as wide_case, key
from torch_one_thread import one_torch_thread  # noqa: F401

WIDTHS = [(64, 64, 2), (64, 128, 4), (128, 64, 4), (96, 160, 4), (32, 64, 2), (64, 32, 2)]
BP = 14  # polylines: 2 groups of 12 at a width of 128 or less (64 rows), 3 of 6 at 160 (52 rows)

_LIBC = ctypes.CDLL(None, use_errno=True)
_LIBC.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
_MAPS = []  # the guarded weights' mappings, kept for the process's life


def guarded(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy of t whose last byte is the last before a page that
    may not be read (an anonymous mapping of this process, its last page
    PROT_NONE), so that a kernel's read past t's end faults."""
    nbytes = 4 * t.numel()
    span = -(-nbytes // mmap.PAGESIZE) * mmap.PAGESIZE
    m = mmap.mmap(-1, span + mmap.PAGESIZE)
    base = ctypes.addressof(ctypes.c_char.from_buffer(m))
    assert _LIBC.mprotect(base + span, mmap.PAGESIZE, 0) == 0, ctypes.get_errno()  # PROT_NONE
    _MAPS.append(m)
    out = torch.frombuffer((ctypes.c_float * t.numel()).from_address(base + span - nbytes), dtype=torch.float32)
    return out.view_as(t).copy_(t)


def case(widths):
    """wide_case's encoder and inputs, the encoder's weights guarded."""
    enc, x, valid, g = wide_case(widths)
    for name in tne.W_NAMES:
        p = getattr(enc, name)
        p.data = guarded(p.data)
    return enc, x, valid, g


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """(name, d_model, d_ff) -> the emulator's build of csrc/<name>.cu at
    those widths."""
    builds = {}
    for d_model, d_ff in sorted({w[:2] for w in WIDTHS}):
        for name in ("node_encoder", "node_encoder_train"):
            builds[key(d_model, d_ff, name)] = (name, list(tne.build_defines(d_model, d_ff)))
    return build_emulated(tmp_path_factory.mktemp("cuda_emu_node_narrow"), builds)


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_k2_narrow_emulated_matches_plain(emulated, widths):
    enc, x, valid, _ = case(widths)
    out = k2(emulated[key(*widths[:2], "node_encoder")], enc, x, valid)
    with torch.no_grad():
        ref = enc.pooled_plain(x, valid)
    live = valid.any(-1)
    torch.testing.assert_close(out[live], ref[live], atol=1e-4, rtol=1e-4)
    assert (out[~live] == tne.NEG).all()


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_k2_bf16_narrow_emulated_matches_plain(emulated, widths, record_property):
    """Within a relative norm error of 1e-3 of the plain version's bf16
    function over the live polylines, and the fp32 function farther than
    that from it (an unrounded product tells)."""
    enc, x, valid, _ = case(widths)
    out = k2(emulated[key(*widths[:2], "node_encoder")], enc, x, valid, bf16=True)
    with torch.no_grad():
        ref = enc.pooled_plain(x, valid, bf16=True)
        ref32 = enc.pooled_plain(x, valid)
    live = valid.any(-1)
    err = ((out[live] - ref[live]).norm() / ref[live].norm()).item()
    gap = ((ref32[live] - ref[live]).norm() / ref[live].norm()).item()
    record_property("rel_norm_err", err)
    record_property("fp32_vs_bf16_rel_norm", gap)
    assert err < 1e-3, err
    assert gap > 2e-3, gap
    assert (out[~live] == tne.NEG).all()


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_k4_narrow_emulated_matches_plain(emulated, widths, p):
    """K4f and K4b (2 walk blocks over 2 or 3 groups) with dropout off and
    live, against the plain version and autograd; every gradient written
    (NaN-filled buffers); K4b with dropout live twice, bitwise equal; K4f
    at p = 0 K2 to the bit."""
    lib, seed = emulated[key(*widths[:2], "node_encoder_train")], 2**40 + 5
    enc, x, valid, g = case(widths)
    live = valid.any(-1)
    g = g * live[:, None]
    out = k4_fwd(lib, enc, x, valid, p, seed)
    xx = x.clone().requires_grad_()
    ref = tnt.node_encoder_train_plain(enc, xx, valid, p, seed)
    torch.testing.assert_close(out[live], ref.detach()[live], atol=1e-4, rtol=1e-4)
    assert (out[~live] == tne.NEG).all()
    if p == 0.0:
        assert torch.equal(out, k2(emulated[key(*widths[:2], "node_encoder")], enc, x, valid))
    leaves = [xx] + [getattr(enc, n) for n in tne.W_NAMES]
    ref_grads = torch.autograd.grad(ref, leaves, g)
    got = k4_bwd(lib, enc, x, valid, g, p, seed, nblocks=2)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    scale = max(r.norm().item() for r in ref_grads)
    for name, a, b in zip(["dx"] + list(tne.W_NAMES), got, ref_grads):
        err = (a - b).norm().item()
        assert err <= 1e-3 * max(b.norm().item(), 1e-3 * scale), (name, err, b.norm().item())
    assert (got[0][~valid] == 0).all()
    if p > 0:  # the dropout keys and the fixed-order sums: the same bits on a second call
        again = k4_bwd(lib, enc, x, valid, g, p, seed, nblocks=2)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_a_narrow_build_refuses_other_widths(emulated):
    """Each C entry of a narrow build returns cudaErrorInvalidValue (1) for
    widths it was not built for and for d_head 2, as the predicate
    refuses the latter (and routes each width pair to its own build)."""
    enc, x, valid, _ = case((64, 64, 2))
    out = torch.empty(BP, 64)
    fn = emulated[key(64, 128, "node_encoder")].tb_node_encoder
    fn.argtypes, fn.restype = list(tne._ARGS), ctypes.c_int
    assert fn(x.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, 5, 2, 2, 64, 64, weight_ptrs(enc), None) == 1
    fn = emulated[key(64, 64, "node_encoder")].tb_node_encoder
    fn.argtypes, fn.restype = list(tne._ARGS), ctypes.c_int
    assert fn(x.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, 5, 2, 32, 64, 64, weight_ptrs(enc), None) == 1
    assert tne.kernel_refusal(5, 64, 64, 32) is not None and tne.kernel_refusal(5, 64, 64, 16) is None
    fs = emulated[key(96, 160, "node_encoder_train")].tb_node_encoder_train_scratch
    fs.argtypes, fs.restype = list(tnt._SCRATCH_ARGS), ctypes.c_int
    n = ctypes.c_longlong()
    assert fs(BP, 5, 2, 4, 96, 128, 2, ctypes.byref(n)) == 1
    assert fs(BP, 5, 2, 4, 96, 160, 2, ctypes.byref(n)) == 0
