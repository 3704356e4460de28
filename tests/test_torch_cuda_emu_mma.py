"""The tensor-core primitive of the bf16 kernels (`csrc/mma.cuh`), run on the
CPU emulator against torch.matmul.

`tests/cuda_emu/mma_check.cu` (one warp: the 16 x 8 tiles of C in turn, k
in steps of 16, the A fragment and both B fragment loads of `mma.cuh`, the
m16n8k8 product in steps of 8 with its two fragment loads, and its
fp32-pair-to-bf16x2 conversion) is compiled with g++ against
`tests/cuda_emu/cuda_runtime.h`, whose `mma_bf16_16816` exchanges the
warp's fragments through per-lane slots in the PTX ISA's m16n8k16 layout
(`mma_bf16_1688` in its m16n8k8 layout).
`tests/test_torch_cuda.py` runs the same source with nvcc on the card: the
two agreeing with torch.matmul is what shows that the emulator's layout is
the hardware's.

Tolerances: the product of two bf16 values is exact in fp32, so C is the
fp32 sum of exact products; torch.matmul sums them in another order, a
relative norm error of at most 1e-6 (an fp32 ulp is 1.2e-7 relative; a
wrong fragment layout moves C by O(1)). The conversion is bitwise
torch's round to nearest even.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from trafficbots_tpu_torch.ops import cuda_build

from test_torch_cuda_emu import emulated_source

EMU = Path(__file__).resolve().parent / "cuda_emu"
MMA_SOURCE = EMU / "mma_check.cu"
MMA_RTOL = 1e-6
MMA_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
PACK_ARGS = (ctypes.c_void_p,) * 2 + (ctypes.c_int, ctypes.c_void_p)
MMA_K8_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def mma_operands(M, N, K, seed):
    """a [M, K], b [K, N] bf16 (b also as bt [N, K], contiguous) and their
    fp32 product by torch.matmul."""
    rs = np.random.RandomState(seed)
    a = torch.from_numpy(rs.normal(size=(M, K)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rs.normal(size=(K, N)).astype(np.float32)).bfloat16()
    return a, b, b.t().contiguous(), a.float() @ b.float()


def run_mma_check(lib, a, b, bt, stream=None):
    """c_nk, c_kn from tb_mma_check (a, b, bt on one device)."""
    (M, K), N = a.shape, b.shape[1]
    c_nk, c_kn = (torch.full((M, N), float("nan"), device=a.device) for _ in range(2))
    fn = lib.tb_mma_check
    fn.argtypes, fn.restype = list(MMA_ARGS), ctypes.c_int
    assert fn(a.data_ptr(), bt.data_ptr(), b.data_ptr(), c_nk.data_ptr(), c_kn.data_ptr(), M, N, K, stream) == 0
    return c_nk, c_kn


def run_mma_check_k8(lib, a, bt, stream=None):
    """c from tb_mma_check_k8 (the m16n8k8 product, a and bt on one device)."""
    (M, K), N = a.shape, bt.shape[0]
    c = torch.full((M, N), float("nan"), device=a.device)
    fn = lib.tb_mma_check_k8
    fn.argtypes, fn.restype = list(MMA_K8_ARGS), ctypes.c_int
    assert fn(a.data_ptr(), bt.data_ptr(), c.data_ptr(), M, N, K, stream) == 0
    return c


def run_pack_check(lib, x, stream=None):
    """pack_bf16 of x's pairs, as int32 words."""
    out = torch.zeros(x.numel() // 2, dtype=torch.int32, device=x.device)
    fn = lib.tb_pack_check
    fn.argtypes, fn.restype = list(PACK_ARGS), ctypes.c_int
    assert fn(x.data_ptr(), out.data_ptr(), out.numel(), stream) == 0
    return out


def pack_inputs():
    """fp32 values on and off bf16 rounding boundaries (ties to even both
    ways, signs, zeros) and the expected bf16x2 words."""
    rs = np.random.RandomState(3)
    x = rs.normal(size=256).astype(np.float32)
    bits = x.view(np.uint32)
    bits[:8] = (bits[:8] & 0xffff0000) | 0x8000  # exact ties: to the even neighbour
    bits[8:16] = (bits[8:16] & 0xfffe0000) | 0x18000
    x[16:18] = (0.0, -0.0)
    x = torch.from_numpy(x)
    h = x.bfloat16().view(torch.int16).to(torch.int32) & 0xffff
    return x, h[0::2] | (h[1::2] << 16)


@pytest.fixture(scope="module")
def mma_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the check for the CPU emulator")
    out_dir = tmp_path_factory.mktemp("cuda_emu_mma")
    cpp = out_dir / "mma_check.cpp"
    cpp.write_text(emulated_source(MMA_SOURCE.read_text()))
    lib = out_dir / "libmma_check.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{EMU}",
                    f"-I{cuda_build.CSRC}", "-o", str(lib), str(cpp)], check=True)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("M,N,K", [(16, 8, 16), (64, 128, 128)])
def test_mma_emulated_matches_matmul(mma_lib, M, N, K):
    """One m16n8k16 MMA, and the 64 x 128 x 128 tiling of K2-bf16's
    products: both B fragment loads within MMA_RTOL of torch.matmul."""
    a, b, bt, ref = mma_operands(M, N, K, seed=M + N + K)
    for c in run_mma_check(mma_lib, a, b, bt):
        assert ((c - ref).norm() / ref.norm()).item() <= MMA_RTOL


@pytest.mark.parametrize("M,N,K", [(16, 8, 8), (32, 128, 8), (64, 24, 40)])
def test_mma_k8_emulated_matches_matmul(mma_lib, M, N, K):
    """The m16n8k8 MMA (K1-bf16's logits at d_head 8 and 4): one tile, a
    head's 32 x 128 logits block, several k-steps; within MMA_RTOL of
    torch.matmul."""
    a, _, bt, ref = mma_operands(M, N, K, seed=M + N + K + 1)
    c = run_mma_check_k8(mma_lib, a, bt)
    assert ((c - ref).norm() / ref.norm()).item() <= MMA_RTOL


def test_pack_bf16_emulated_rounds_to_nearest_even(mma_lib):
    x, want = pack_inputs()
    assert torch.equal(run_pack_check(mma_lib, x), want)
