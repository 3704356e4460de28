"""K2 and K4 (the node-stack kernels), as CUDA source, run on the CPU
against their plain versions.

As tests/test_torch_cuda_emu.py does for the attention kernels: compiles
`trafficbots_tpu_torch/csrc/node_encoder.cu` and `node_encoder_train.cu`
(with `node_layer.cuh`, `node_trace.cuh` and `philox.cuh` inlined) with the
host's g++ against the CUDA emulator in `tests/cuda_emu/` (a fiber per CUDA
thread, `__syncthreads` a barrier, shared memory NaN-filled at each
block, static `__shared__` variables one per block, `cp.async` a plain
copy), and holds the kernels at a small shape (d_model 128, 4 heads, 2
layers, polylines of 5 nodes among which an all-padding and a partly valid
one, a few groups of polylines so that a walk block takes more than one)
against their plain versions. This holds the compaction of the valid
nodes, the indexing, synchronisation, dropout keys and arithmetic; it says
nothing of their speed (the card runs the same checks at full width:
chip_smoke.py, tests/test_torch_cuda.py).

Tolerances: K2 and K4's forward within atol = rtol = 1e-4 of the plain
versions (fp32, the sums in another order); K4's backward (dx and the 18
weight gradients) within a relative norm error of 1e-3 of autograd through
the plain version, each gradient against its own norm or 1e-3 of the
largest (the key-projection bias's exact gradient is 0: rounding noise on
both sides), as on the card; the backward bitwise equal over two calls,
padding nodes' dx exactly 0.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from trafficbots_tpu_torch.ops import cuda_build
from trafficbots_tpu_torch.ops import node_encoder as tne
from trafficbots_tpu_torch.ops import node_encoder_train as tnt
from trafficbots_tpu_torch.ops import node_trace

from test_torch_cuda_emu import emulated_source

EMU = Path(__file__).resolve().parent / "cuda_emu"
HEADERS = ("node_layer.cuh", "mma.cuh", "node_trace.cuh", "philox.cuh")
D, H, L, N = 128, 4, 2, 5


def node_source(name: str) -> str:
    """csrc/<name>.cu with its headers inlined, its dynamic shared memory
    the emulator's, its launches rewritten for the emulator."""
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    while any(f'#include "{h}"' in src for h in HEADERS):
        for h in HEADERS:
            src = src.replace(f'#include "{h}"', (cuda_build.CSRC / h).read_text().replace("#pragma once", ""), 1)
            src = src.replace(f'#include "{h}"', "")  # a header already inlined
    src = src.replace("extern __shared__ float4 smem4[];", "float4* smem4 = reinterpret_cast<float4*>(emu_smem);")
    return emulated_source(src)


def build_emulated(out_dir: Path, builds: dict) -> dict:
    """key -> the ctypes library of csrc/<name>.cu built for the emulator
    with g++ and `flags`, for builds {key: (name, flags)}, all compiled at
    once."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the CPU emulator")
    procs = {}
    for key, (name, flags) in builds.items():
        cpp = out_dir / f"{key}.cpp"
        cpp.write_text(node_source(name))
        lib = out_dir / f"lib{key}.so"
        procs[key] = (subprocess.Popen([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                                        f"-I{EMU}", *flags, "-o", str(lib), str(cpp)]), lib)
    libs = {}
    for key, (p, lib) in procs.items():
        assert p.wait() == 0, f"g++ failed for {key}"
        libs[key] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """name -> the ctypes library of csrc/<name>.cu built for the emulator
    ("node_encoder_trace", "node_encoder_train_trace": K2, K4 built with
    -DTB_NODE_TRACE)."""
    return build_emulated(tmp_path_factory.mktemp("cuda_emu_node"), {
        "node_encoder": ("node_encoder", []), "node_encoder_train": ("node_encoder_train", []),
        "node_encoder_trace": ("node_encoder", ["-DTB_NODE_TRACE"]),
        "node_encoder_train_trace": ("node_encoder_train", ["-DTB_NODE_TRACE"])})


def encoder(seed=1, d_model=D, n_head=H, n_layer=L, d_ff=None):
    """A node encoder with non-trivial LayerNorm scales and biases."""
    enc = tne.FusedNodeEncoder(d_model, n_head, n_layer, d_ff or d_model)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name in tne.W_NAMES:
            p = getattr(enc, name)
            if p.ndim == 3:
                p.copy_(torch.from_numpy(rs.normal(scale=p.shape[1] ** -0.5, size=p.shape).astype(np.float32)))
            else:
                p.add_(torch.from_numpy(0.1 * rs.normal(size=p.shape).astype(np.float32)))
    return enc


def inputs(BP, seed=2, d_model=D):
    """x [BP, N, D], valid [BP, N] (about 70% valid; polyline 1 all
    padding, polyline 2 with its first two nodes valid), g [BP, D]."""
    D = d_model
    rs = np.random.RandomState(seed)
    valid = rs.rand(BP, N) < 0.7
    valid[0, 0] = True
    valid[1] = False
    valid[2] = False
    valid[2, :2] = True
    x = (rs.normal(size=(BP, N, D)) * valid[..., None]).astype(np.float32)
    g = rs.normal(size=(BP, D)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(g)


def weight_ptrs(enc):
    return ctypes.cast(tnt._weight_ptrs([getattr(enc, n) for n in tne.W_NAMES]), ctypes.c_void_p)


def shape_args(enc, x):
    """BP, N, L, H, d_model, d_ff of a C entry's call."""
    return x.shape[0], x.shape[1], enc.n_layer, enc.n_head, enc.d_model, enc.d_feedforward


def k2(lib, enc, x, valid, bf16=False):
    out = torch.full((x.shape[0], enc.d_model), float("nan"))
    fn = lib.tb_node_encoder_bf16 if bf16 else lib.tb_node_encoder
    fn.argtypes, fn.restype = list(tne._ARGS), ctypes.c_int
    assert fn(x.data_ptr(), valid.data_ptr(), out.data_ptr(), *shape_args(enc, x), weight_ptrs(enc), None) == 0
    return out


def k4_fwd(lib, enc, x, valid, p, seed):
    out = torch.full((x.shape[0], enc.d_model), float("nan"))
    fn = lib.tb_node_encoder_train_fwd
    fn.argtypes, fn.restype = list(tnt._FWD_ARGS), ctypes.c_int
    assert fn(x.data_ptr(), valid.data_ptr(), out.data_ptr(), *shape_args(enc, x), weight_ptrs(enc),
              *tnt._drop_args(p, seed), None) == 0
    return out


def k4_bwd(lib, enc, x, valid, g, p, seed, nblocks):
    BP, _, L, H, Dm, Fd = args = shape_args(enc, x)
    n = ctypes.c_longlong()
    fs = lib.tb_node_encoder_train_scratch
    fs.argtypes, fs.restype = list(tnt._SCRATCH_ARGS), ctypes.c_int
    assert fs(BP, x.shape[1], L, H, Dm, Fd, nblocks, ctypes.byref(n)) == 0
    scratch = torch.full((n.value,), float("nan"))
    dx = torch.full_like(x, float("nan"))
    dw = torch.full((tnt.n_params(L, Dm, Fd),), float("nan"))
    fn = lib.tb_node_encoder_train_bwd
    fn.argtypes, fn.restype = list(tnt._BWD_ARGS), ctypes.c_int
    rc = fn(x.data_ptr(), valid.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(), dw.data_ptr(), *args,
            weight_ptrs(enc), *tnt._drop_args(p, seed), nblocks, None)
    assert rc == 0
    grads, off = [], 0
    for name in tne.W_NAMES:
        w = getattr(enc, name)
        grads.append(dw[off:off + w.numel()].view_as(w))
        off += w.numel()
    return [dx] + grads


@pytest.mark.parametrize("BP", [6, 30])
def test_k2_emulated_matches_plain(emulated, BP):
    """At N = 5 a block holds 12 polylines: one block, then three."""
    enc = encoder()
    x, valid, _ = inputs(BP)
    out = k2(emulated["node_encoder"], enc, x, valid)
    with torch.no_grad():
        ref = enc.pooled_plain(x, valid)
    live = valid.any(-1)
    torch.testing.assert_close(out[live], ref[live], atol=1e-4, rtol=1e-4)
    assert (out[~live] == tne.NEG).all()


def test_k2_bf16_emulated_matches_plain(emulated, record_property):
    """K2's bf16 variant (tb_node_encoder_bf16, every product's operands
    rounded to bf16) against the plain version's bf16 function, within a
    relative norm error of 1e-3 over the live polylines (the fp32 sums run
    in another order, so an operand on a bf16 rounding boundary lands one
    bf16 ulp, 3.9e-3 relative, away and moves what follows); dead polylines
    at -1e30; and K2's fp32 output unchanged beside it."""
    enc = encoder()
    x, valid, _ = inputs(30)
    out = k2(emulated["node_encoder"], enc, x, valid, bf16=True)
    with torch.no_grad():
        ref = enc.pooled_plain(x, valid, bf16=True)
        ref32 = enc.pooled_plain(x, valid)
    live = valid.any(-1)
    err = ((out[live] - ref[live]).norm() / ref[live].norm()).item()
    record_property("rel_norm_err", err)
    assert err < 1e-3, err
    assert ((ref32[live] - ref[live]).norm() / ref[live].norm()).item() > 10 * err  # bf16 moves it
    assert (out[~live] == tne.NEG).all()


def test_k2_trace_build_counts_its_phases(emulated):
    """The -DTB_NODE_TRACE build names its phases and counts one work item
    a block with a valid node (ops/node_trace.py reads both)."""
    lib = emulated["node_encoder_trace"]
    (kname, names), = node_trace.phases(lib).values()
    assert kname.startswith("node_kernel") and names[-1] == "pool"
    x, valid, _ = inputs(30)
    assert lib.tb_node_trace_zero() == 0
    k2(lib, encoder(), x, valid)
    counts = (ctypes.c_ulonglong * 64)()
    assert lib.tb_node_trace_read(counts) == 0
    assert counts[15] == 3 and all(counts[1 + i] > 0 for i in range(len(names)))


def test_k4f_trace_build_counts_its_phases(emulated):
    """K4's traced build names the phases of its three traced kernels, and
    K4f counts one work item a group of polylines (3 at 30 polylines of 5
    nodes) and time in each of its phases."""
    lib = emulated["node_encoder_train_trace"]
    kernels = node_trace.phases(lib)
    assert [kernels[k][0].split(" ")[0] for k in (1, 2, 3)] == ["fwd_kernel", "walk_kernel", "save_kernel"]
    names = kernels[1][1]
    assert names[-1] == "pool" and kernels[3][1][:-1] == names[:-1]
    x, valid, _ = inputs(30)
    assert lib.tb_node_trace_zero() == 0
    k4_fwd(lib, encoder(), x, valid, 0.1, 7)
    counts = (ctypes.c_ulonglong * 64)()
    assert lib.tb_node_trace_read(counts) == 0
    assert counts[16 + 15] == 3 and all(counts[16 + 1 + i] > 0 for i in range(len(names)))


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_k4_emulated_matches_plain(emulated, p):
    """K4f (3 groups of 12 polylines) and K4b at 30 polylines (3 groups of
    12; 2 walk blocks, so one walks two groups) with dropout off and live,
    against the plain version and autograd; K4b twice, bitwise equal."""
    lib, seed = emulated["node_encoder_train"], 2**40 + 3
    enc = encoder()
    x, valid, g = inputs(30)
    live = valid.any(-1)
    g = g * live[:, None]
    out = k4_fwd(lib, enc, x, valid, p, seed)
    xx = x.clone().requires_grad_()
    ref = tnt.node_encoder_train_plain(enc, xx, valid, p, seed)
    torch.testing.assert_close(out[live], ref.detach()[live], atol=1e-4, rtol=1e-4)
    assert (out[~live] == tne.NEG).all()
    leaves = [xx] + [getattr(enc, n) for n in tne.W_NAMES]
    ref_grads = torch.autograd.grad(ref, leaves, g)
    got = k4_bwd(lib, enc, x, valid, g, p, seed, nblocks=2)
    scale = max(r.norm().item() for r in ref_grads)
    for name, a, b in zip(["dx"] + list(tne.W_NAMES), got, ref_grads):
        err = (a - b).norm().item()
        assert err <= 1e-3 * max(b.norm().item(), 1e-3 * scale), (name, err, b.norm().item())
    assert (got[0][~valid] == 0).all()
    again = k4_bwd(lib, enc, x, valid, g, p, seed, nblocks=2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_k4f_without_dropout_is_k2_to_the_bit(emulated):
    """K4f at p = 0 runs K2's layer code (csrc/node_layer.cuh) with every
    dropout factor exactly 1.0: its output is K2's, bit for bit."""
    enc = encoder()
    x, valid, _ = inputs(30)
    assert torch.equal(k4_fwd(emulated["node_encoder_train"], enc, x, valid, 0.0, 2**40 + 3),
                       k2(emulated["node_encoder"], enc, x, valid))
