"""K3's backward and K5's entries, as CUDA source, run on the CPU against
their plain versions.

The card's compiler is not here, so these tests compile
`trafficbots_tpu_torch/csrc/attention_train.cu` and `dropout.cu` with the
host's g++ against `tests/cuda_emu/cuda_runtime.h`, an emulator of the part
of the CUDA runtime they use (a std::thread per CUDA thread, blocks one
after another, `__syncthreads` a barrier, shared memory NaN-filled at each
block). The `kernel<<<grid, threads, smem, stream>>>(args)` launches are
rewritten into calls of the emulator's launcher. This holds the kernels'
indexing, tiling, masking, block-size choice, synchronisation and
arithmetic at small shapes; it says nothing of their speed, and the
forward kernels (warp shuffles) are not run here. The card runs the same
checks at full width (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: dq, dk, dv within a relative norm error of 1e-5 of autograd
through the plain version (fp32, the sums in another order, as on the
card); K5's entries bit for bit.
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from trafficbots_tpu_torch.ops import attention_train as tat
from trafficbots_tpu_torch.ops import cuda_build
from trafficbots_tpu_torch.ops import dropout as tdo

EMU = Path(__file__).resolve().parent / "cuda_emu"


def emulated_source(cu: str) -> str:
    """The .cu text with each launch `k<<<grid, threads, smem, st>>>(args)`
    made `emu_launch(grid, threads, [&] { k(args); })` and the dynamic
    shared memory the emulator's buffer."""
    src = cu.replace("extern __shared__ float smem[];", "float* smem = emu_smem;")
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        k, depth = j, 0  # back over the kernel's name and template arguments
        while k > 0:
            c = src[k - 1]
            if c in "<>":
                depth += 1 if c == ">" else -1
            elif depth == 0 and not (c.isalnum() or c in "_:"):
                break
            k -= 1
        e = src.index(">>>", j)
        grid, threads = (c.strip() for c in src[j + 3:e].split(",")[:2])
        q, depth = e + 3, 0
        while True:  # the matching parenthesis of the argument list
            depth += (src[q] == "(") - (src[q] == ")")
            if depth == 0:
                break
            q += 1
        out += [src[i:k], f"emu_launch({grid}, {threads}, [&] {{ {src[k:j]}({src[e + 4:q]}); }})"]
        i = q + 1
    return "".join(out) + src[i:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """name -> the ctypes library of csrc/<name>.cu built for the emulator."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the CPU emulator")
    out_dir = tmp_path_factory.mktemp("cuda_emu")
    libs = {}
    for name in ("attention_train", "dropout"):
        cpp = out_dir / f"{name}.cpp"
        cpp.write_text(emulated_source((cuda_build.CSRC / f"{name}.cu").read_text()))
        lib = out_dir / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                        f"-I{EMU}", f"-I{cuda_build.CSRC}", "-o", str(lib), str(cpp)], check=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def row_stats(q, k, invalid, n_head):
    """The forward's saved row max and sum of exp ([B, H, S]; -inf and 0
    for a row with every target masked)."""
    B, S, D = q.shape
    T, dh = k.shape[1], D // n_head
    logits = torch.einsum("bshd,bthd->bhst", q.view(B, S, n_head, dh), k.view(B, T, n_head, dh)) / math.sqrt(dh)
    logits = logits.masked_fill(invalid[:, None], float("-inf"))
    m = logits.amax(-1)
    live = torch.isfinite(m)
    e = torch.exp(logits - torch.where(live, m, torch.zeros_like(m))[..., None])
    return m.contiguous(), torch.where(live, e.sum(-1), torch.zeros_like(m)).contiguous()


@pytest.mark.parametrize("B,S,T,D,H,full_mask,p", [
    (2, 48, 300, 128, 4, True, 0.1),  # partial tiles, an all-masked row, dead key tiles; 16-row dq blocks
    (2, 70, 200, 64, 4, False, 0.0),  # d_head 16, no dropout
    (8, 256, 130, 128, 4, False, 0.1),  # 128 blocks of 64 rows: the 64-row dq blocks
    (4, 130, 70, 64, 2, True, 0.2),
])
def test_k3_backward_emulated_matches_plain(emulated, B, S, T, D, H, full_mask, p):
    rs = np.random.RandomState(S + T)
    q, k, v, g = (torch.from_numpy(rs.normal(size=s).astype(np.float32)) for s in ((B, S, D), (B, T, D), (B, T, D), (B, S, D)))
    if full_mask:
        invalid = torch.from_numpy(rs.rand(B, S, T) < 0.3)
        invalid[0, 1] = True
        invalid[1, :, : T // 2] = True  # key tiles no row of scene 1 may use
    else:
        pad = torch.zeros(B, T, dtype=torch.bool)
        pad[:, int(T * 0.75):] = True
        pad[0] = True  # scene 0: every row dead, its keys get no gradient
        invalid = pad[:, None, :].expand(B, S, T)  # read through stride 0
    seed, site = 2**45 + 3, 2
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tat.attention_train_plain(*leaves, invalid, H, p, seed, site)
    out.backward(g)
    rmax, rsum = row_stats(q, k, invalid, H)
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    dsum = torch.full((B, H, S), float("nan"))
    fn = emulated["attention_train"].tb_attention_train_bwd
    fn.argtypes, fn.restype = list(tat._BWD_ARGS), ctypes.c_int
    o = out.detach().contiguous()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), o.data_ptr(), rmax.data_ptr(),
            rsum.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), B, S, T, D,
            H, invalid.stride(0), invalid.stride(1), *tat._dropout_args(p, seed, site), None)
    assert rc == 0
    for name, got, leaf in zip(("dq", "dk", "dv"), (dq, dk, dv), leaves):
        assert torch.isfinite(got).all(), name
        assert ((got - leaf.grad).norm() / leaf.grad.norm()).item() < 1e-5, name
    dead = ~torch.isfinite(rmax).transpose(1, 2)  # [B, S, H]
    assert (dq.view(B, S, H, -1)[dead] == 0).all()
    torch.testing.assert_close(dsum, torch.einsum("bshd,bshd->bhs", g.view(B, S, H, -1), o.view(B, S, H, -1)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(5, 37, 130), (8, 64, 128), (3, 7), (2, 3, 4, 1)])
@pytest.mark.parametrize("offset", [0, 1])  # 1: a storage offset, not 16-byte aligned (the scalar path)
def test_k5_entries_emulated_equal_the_plain_compositions(emulated, shape, offset):
    lib = emulated["dropout"]
    for name, args in (("tb_dropout", tdo._DROP_ARGS), ("tb_dropout_add", tdo._ADD_ARGS),
                       ("tb_relu_dropout", tdo._DROP_ARGS), ("tb_relu_dropout_bwd", tdo._RELU_BWD_ARGS)):
        getattr(lib, name).argtypes, getattr(lib, name).restype = list(args), ctypes.c_int
    seed, site, p = 2**61 + 12345, 7, 0.1
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.normal(size=int(np.prod(shape)) + offset).astype(np.float32))[offset:].view(shape)
    res, g = (torch.from_numpy(rs.normal(size=shape).astype(np.float32)) for _ in range(2))
    drop = (*tdo._rows(x), seed, site, tdo.threshold(p), tdo.keep_scale(p), None)
    out, added, relu, dx = (torch.empty(shape) for _ in range(4))
    assert lib.tb_dropout(x.data_ptr(), out.data_ptr(), *drop) == 0
    assert lib.tb_dropout_add(res.data_ptr(), x.data_ptr(), added.data_ptr(), *drop) == 0
    assert lib.tb_relu_dropout(x.data_ptr(), relu.data_ptr(), *drop) == 0
    assert lib.tb_relu_dropout_bwd(g.data_ptr(), relu.data_ptr(), dx.data_ptr(), relu.numel(), tdo.keep_scale(p),
                                   None) == 0
    plain = tdo.dropout_plain(x, p, seed, site)
    xx = x.clone().requires_grad_()
    ref = torch.relu(tdo.dropout_plain(xx, p, seed, site))
    ref.backward(g)
    assert torch.equal(out, plain)
    assert torch.equal(added, res + plain)
    assert torch.equal(relu, ref.detach())
    assert torch.equal(dx, xx.grad)


def test_k3_wrapper_mirrors_the_kernels_layout():
    """The wrapper's shared-memory check mirrors csrc/attention_train.cu:
    its tile constants, and at T = 1024 the largest block is the 16-row dq
    kernel's (four key groups' tiles), well inside a block's limit."""
    import re

    src = (cuda_build.CSRC / "attention_train.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["ROWS"], const["BT"], const["PAD"]) == (tat.ROWS_PER_BLOCK, tat.BWD_TILE, tat._PAD)
    assert const["MIN_BLOCKS"] == 128 and tat.DQ_ROWS == (16, 64)
    dq16 = 4 * (2 * 32 * (16 + 4) + 3 * 16 + 4 * (2 * 32 + 16) * (64 + 4))
    assert tat.smem_bytes(1024, 32) == dq16 == 92352 <= tat.SMEM_LIMIT
    assert tat.smem_bytes(4096, 32) > tat.SMEM_LIMIT  # the forward's [16, T] logits bound T
