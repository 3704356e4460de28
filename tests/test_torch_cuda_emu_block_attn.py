"""K6 (the hybrid node encoder's per-polyline attention core), as CUDA
source, run on the CPU against its plain version.

As tests/test_torch_cuda_emu_node.py does for K2 and K4: compiles
`trafficbots_tpu_torch/csrc/block_attn.cu` with the host's g++ against the
CUDA emulator in `tests/cuda_emu/` (a std::thread per CUDA thread,
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

from test_torch_cuda_emu_node import node_source

EMU = Path(__file__).resolve().parent / "cuda_emu"
BP = 7


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    """The ctypes library of csrc/block_attn.cu built for the emulator."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel for the CPU emulator")
    out_dir = tmp_path_factory.mktemp("cuda_emu_block_attn")
    cpp, lib = out_dir / "block_attn.cpp", out_dir / "libblock_attn.so"
    cpp.write_text(node_source("block_attn"))
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{EMU}",
                    "-o", str(lib), str(cpp)], check=True)
    return ctypes.CDLL(str(lib))


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


@pytest.mark.parametrize("N,D,H", [(5, 128, 4), (20, 128, 4), (7, 20, 4)])
def test_k6_bf16_emulated_matches_plain(emulated_lib, record_property, N, D, H):
    """K6's bf16 variant (tb_block_attn_bf16: q kᵀ and the weights times v
    on bf16 operands, an fp32 output) against the plain version's bf16
    function: every row within atol = rtol = 1e-5 (the operands are rounded
    alike on both sides; only the fp32 sums' order differs, and a weight on
    a bf16 rounding boundary would move its row by one bf16 ulp of that
    weight: the count of rows past 1e-5 is held to 0 here), and away from
    the fp32 kernel's output."""
    q, k, v, valid = inputs(N, D)
    out = torch.full_like(q, float("nan"))
    rc = entry(emulated_lib, "tb_block_attn_bf16")(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                                                    out.data_ptr(), BP, N, D, H, 1.0 / math.sqrt(D // H), None)
    assert rc == 0
    ref = tba.block_attn_core_plain(q, k, v, valid, H, bf16=True)
    live = valid.any(-1)
    assert torch.isfinite(out).all()
    record_property("max_abs_err", (out[live] - ref[live]).abs().max().item())
    torch.testing.assert_close(out[live], ref[live], atol=1e-5, rtol=1e-5)
    ref32 = tba.block_attn_core_plain(q, k, v, valid, H)
    assert (ref32[live] - ref[live]).abs().max() > 1e-3
