"""K6 (the hybrid node encoder's per-polyline attention core), as CUDA
source, run on the CPU against its plain version.

As tests/test_torch_cuda_emu_node.py does for K2 and K4: compiles
`trafficbots_tpu_torch/csrc/block_attn.cu` (with `mma.cuh` and
`node_trace.cuh` inlined) with the host's g++ against the CUDA emulator in `tests/cuda_emu/` (a fiber per CUDA thread,
`__syncthreads` a barrier, shared memory NaN-filled at each block, warp
ballots through a slot array, `cp.async` a plain copy, a card of two SMs
with one block each, so the persistent grid walks its polylines in several
passes) and holds the kernel at small shapes (7 polylines, among them an
all-padding one, one with a single valid node and a partly valid one)
against `block_attn_core_plain`. This holds the staging, the double buffer's
synchronisation, the node mask from the ballot, the lifted mask and the
arithmetic; it says nothing of the kernel's speed (the card runs the same
check at full width: chip_smoke.py, tests/test_torch_cuda.py).

Tolerance: every row within atol = rtol = 1e-5 of the plain version
(K6_TOL in chip_smoke.py: one d_head-long and one N-long sum a head, in
another order than the plain version's einsums), the rows of a polyline
without a valid node too (the caller zeroes them, but both sides lift its
mask: with the mask kept, its rows would still be finite and uniform).
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from trafficbots_tpu_torch.ops import block_attn as tba
from trafficbots_tpu_torch.ops import node_trace

from test_torch_cuda_emu_node import node_source

EMU = Path(__file__).resolve().parent / "cuda_emu"
BP = 7


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The ctypes libraries of csrc/block_attn.cu built for the emulator, as
    is and with -DTB_NODE_TRACE (both g++ at once)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel for the CPU emulator")
    out_dir = tmp_path_factory.mktemp("cuda_emu_block_attn")
    cpp = out_dir / "block_attn.cpp"
    cpp.write_text(node_source("block_attn"))
    procs = []
    for name, flags in (("libblock_attn.so", []), ("libblock_attn_trace.so", ["-DTB_NODE_TRACE"])):
        lib = out_dir / name
        procs.append((subprocess.Popen([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                                        f"-I{EMU}", *flags, "-o", str(lib), str(cpp)]), lib))
    assert all(p.wait() == 0 for p, _ in procs), "g++ failed"
    return [ctypes.CDLL(str(lib)) for _, lib in procs]


@pytest.fixture(scope="module")
def emulated_lib(builds):
    """The ctypes library of csrc/block_attn.cu built for the emulator."""
    return builds[0]


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = list(tba._ARGS), ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def emulated(emulated_lib):
    """K6's C entry in the emulated build."""
    return entry(emulated_lib, "tb_block_attn")


def inputs(N, D, seed=3):
    """q, k, v [BP, N, D] and valid [BP, N] (about 60% valid; polyline 0
    all padding, polyline 1 one valid node, polyline 2 its first two)."""
    rs = np.random.RandomState(seed)
    valid = rs.rand(BP, N) < 0.6
    valid[3, 0] = True
    valid[0] = False
    valid[1] = False
    valid[1, N // 2] = True
    valid[2] = False
    valid[2, :2] = True
    q, k, v = (torch.from_numpy(rs.normal(size=(BP, N, D)).astype(np.float32)) for _ in range(3))
    return q, k, v, torch.from_numpy(valid)


@pytest.mark.parametrize("N,D,H", [(5, 128, 4), (20, 128, 4), (20, 128, 1), (7, 20, 4)])
def test_k6_emulated_matches_plain(emulated, N, D, H):
    """D = 128 at 4 heads (float4 copies, N rounded up to 4 rows or not),
    one head of 128 (four 32-column output passes), and d_head = 5 (the
    copies one float at a time, a head's columns padded)."""
    q, k, v, valid = inputs(N, D)
    out = torch.full_like(q, float("nan"))
    rc = emulated(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, N, D, H,
                  1.0 / math.sqrt(D // H), None)
    assert rc == 0
    ref = tba.block_attn_core_plain(q, k, v, valid, H)
    live = valid.any(-1)
    assert not live[0] and live[1:].all()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[live], ref[live], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[~live], ref[~live], atol=1e-5, rtol=1e-5)  # the lifted mask


def one_ulp_flip(q, k, v, valid, H, p, s, c, gap):
    """Whether gap, the bf16 kernel's output minus the plain version's at
    polyline p, row s, column c, is one bf16 ulp of one of the row's fp32
    weights that lies within 8 fp32 ulps of a bf16 rounding boundary, times
    that key's v in bf16."""
    N, D = q.shape[1:]
    dh = D // H
    h = c // dh
    cols = slice(h * dh, (h + 1) * dh)
    qb, kb, vb = (tba.round_to(t[p, :, cols]) for t in (q, k, v))
    use_mask = (~valid[p] & valid[p].any()).float()
    w = torch.softmax((kb @ qb[s]) * (1.0 / math.sqrt(dh)) + use_mask * tba.NEG, dim=-1)
    _, e = torch.frexp(w)
    step = torch.ldexp(torch.ones_like(w), e - 8)  # the bf16 spacing at w (8 significant bits)
    boundary = (torch.floor(w / step) + 0.5) * step
    near = (w - boundary).abs() <= 8 * torch.ldexp(torch.ones_like(w), e - 24)
    moved = (step * vb[:, c - h * dh]).abs()
    return bool((near & ((moved - abs(gap)).abs() <= 1e-6)).any())


@pytest.mark.parametrize("N,D,H", [(5, 128, 4), (20, 128, 4), (7, 20, 4), (32, 128, 4), (7, 128, 8), (20, 120, 120)])
def test_k6_bf16_emulated_matches_plain(emulated_lib, record_property, N, D, H):
    """K6's bf16 variant (tb_block_attn_bf16: q kᵀ and the weights times v
    as bf16 mma.sync fragments, mma.cuh's layout through the emulator's
    MMA, an fp32 output) against the plain version's bf16 function: every
    element within atol = rtol = 1e-5 (the operands are rounded alike on
    both sides; only the fp32 sums' order differs; a fragment in the wrong
    place moves an element by O(1)), except where one_ulp_flip explains the
    gap: a weight on a bf16 rounding boundary, which the other order of the
    softmax's sum rounds the other way, moves its row by one bf16 ulp of
    that weight times v (one element at d_head 1 below, 5.9e-5); and away
    from the fp32 kernel's output. The
    shapes: one m-tile of 16 rows and one or two n-tiles of 8 keys (N = 5,
    7), two m-tiles with an odd n-tile count (20) and a full 32, d_head 32, 16
    (two heads a warp) and 5 (its fragments padded from 5 to 16 columns),
    and d_head 1 at 120 heads, where the padded row strides would not fit
    and the rows go unpadded."""
    q, k, v, valid = inputs(N, D)
    out = torch.full_like(q, float("nan"))
    rc = entry(emulated_lib, "tb_block_attn_bf16")(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                                                    out.data_ptr(), BP, N, D, H, 1.0 / math.sqrt(D // H), None)
    assert rc == 0
    ref = tba.block_attn_core_plain(q, k, v, valid, H, bf16=True)
    live = valid.any(-1)
    assert torch.isfinite(out).all()
    record_property("max_abs_err", (out[live] - ref[live]).abs().max().item())
    far = ~torch.isclose(out, ref, atol=1e-5, rtol=1e-5) & live[:, None, None]
    record_property("one_ulp_flips", int(far.sum()))
    for p, s, c in far.nonzero().tolist():
        assert one_ulp_flip(q, k, v, valid, H, p, s, c, (out - ref)[p, s, c].item()), (p, s, c)
    held = live[:, None, None].expand_as(out) & ~far
    torch.testing.assert_close(out[held], ref[held], atol=1e-5, rtol=1e-5)
    ref32 = tba.block_attn_core_plain(q, k, v, valid, H)
    assert (ref32[live] - ref[live]).abs().max() > 1e-3


def test_k6_trace_build_counts_its_phases(builds):
    """The -DTB_NODE_TRACE build names both kernels' phases and counts one
    work item a polyline, with time in every phase, for K6 and K6-bf16
    (ops/node_trace.py reads both)."""
    lib = builds[1]
    kernels = node_trace.phases(lib)
    assert [kernels[k][0] for k in (0, 1)] == ["block_attn_kernel", "block_attn_mma"]
    N, D, H = 20, 128, 4
    q, k, v, valid = inputs(N, D)
    out = torch.empty_like(q)
    counts = (ctypes.c_ulonglong * 64)()
    for kid, name in ((0, "tb_block_attn"), (1, "tb_block_attn_bf16")):
        assert lib.tb_node_trace_zero() == 0
        assert entry(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, N, D,
                                H, 1.0 / math.sqrt(D // H), None) == 0
        assert lib.tb_node_trace_read(counts) == 0
        names = kernels[kid][1]
        assert names[0] == "land" and names[-1] == "store"
        assert counts[16 * kid + 15] == BP and all(counts[16 * kid + 1 + i] > 0 for i in range(len(names)))
        assert counts[16 * (1 - kid) + 15] == 0
