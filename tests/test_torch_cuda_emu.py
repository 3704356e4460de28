"""K1's and K3's kernels and K5's entries, as CUDA source, run on the CPU
against their plain versions.

The card's compiler is not here, so these tests compile
`trafficbots_tpu_torch/csrc/fused_attention.cu`, `attention_train.cu` and
`dropout.cu` (with the shared forward `attn_fwd.cuh` inlined) with the
host's g++ against `tests/cuda_emu/cuda_runtime.h`, an emulator of the part
of the CUDA runtime they use (a fiber per CUDA thread on the launching
thread, `__syncthreads` a barrier over a block's fibers, shared memory NaN-filled at each block, warp shuffles through a
per-warp slot array, `cp.async` as a synchronous copy, the blocks of a
thread-block cluster run at once with a cluster barrier and a map into each
other's shared memory; other blocks one after another). The
`kernel<<<grid, threads, smem, stream>>>(args)` launches are rewritten into
calls of the emulator's launcher. This holds the kernels' indexing, tiling,
masking, path and block-size choice, synchronisation and arithmetic at
small shapes; it says nothing of their speed. The card runs the same checks
at full width (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: the forwards (K1, K3f) within atol = rtol = 1e-5 of the plain
versions (K1's bf16 variant within a relative norm error of 1e-3: a bf16
ulp is 3.9e-3 relative, and only values on a rounding boundary move) and K3f's row statistics within 1e-6 (fp32, the sums in another
order, as on the card); dq, dk, dv within a relative norm error of 1e-5 of
autograd through the plain version; K5's entries bit for bit.
"""
import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from trafficbots_tpu_torch.ops import attention_train as tat
from trafficbots_tpu_torch.ops import cuda_build
from trafficbots_tpu_torch.ops import dropout as tdo
from trafficbots_tpu_torch.ops import fused_attention as tfa

EMU = Path(__file__).resolve().parent / "cuda_emu"
K1_BF16_RTOL = 1e-3


def emulated_source(cu: str) -> str:
    """The .cu text with each launch `k<<<grid, threads, smem, st>>>(args)`
    made `emu_launch(grid, threads, [&] { k(args); })` and the dynamic
    shared memory the emulator's buffer."""
    header = (cuda_build.CSRC / "attn_fwd.cuh").read_text().replace("#pragma once", "")
    src = cu.replace('#include "attn_fwd.cuh"', header)
    src = src.replace("extern __shared__ float smem[];", "float* smem = emu_smem;")
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
    for name in ("fused_attention", "attention_train", "dropout"):
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


def emulated_backward(emulated, q, k, v, invalid, out, rmax, rsum, g, H, p, seed, site):
    """dq, dk, dv and D = g . out from the emulated K3b on the given
    forward output and row statistics."""
    (B, S, D), T = q.shape, k.shape[1]
    dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
    dsum = torch.full((B, H, S), float("nan"))
    fn = emulated["attention_train"].tb_attention_train_bwd
    fn.argtypes, fn.restype = list(tat._BWD_ARGS), ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), out.data_ptr(), rmax.data_ptr(),
            rsum.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), B, S, T, D,
            H, invalid.stride(0), invalid.stride(1), *tat._dropout_args(p, seed, site), None)
    assert rc == 0
    return dq, dk, dv, dsum


_WORKSPACES = []  # path G's workspaces, kept alive through their calls


def ws_args(q, T, H, kv_bytes):
    """(pointer, floats) of path G's logits workspace for a forward call
    on the emulator's card (EMU_SMS SMs in tests/cuda_emu/cuda_runtime.h):
    (None, 0) where the call takes path L or S."""
    (B, S, D), sms = q.shape, int(re.search(r"EMU_SMS = (\d+);", (EMU / "cuda_runtime.h").read_text())[1])
    n = tfa.workspace_floats(B, S, T, D // H, H, kv_bytes, sms)
    if n == 0:
        return None, 0
    _WORKSPACES.append(ws := torch.full((n,), float("nan")))
    return ws.data_ptr(), n


def fwd_constants() -> dict:
    """The integer constants of csrc/attn_fwd.cuh (products evaluated)."""
    src = (cuda_build.CSRC / "attn_fwd.cuh").read_text()
    return {m[0]: math.prod(int(x) for x in m[1].split("*"))
            for m in re.findall(r"constexpr int (\w+) = ([\d *]+);", src)}


def takes_cluster(B, S, T, H) -> bool:
    """The forward's path choice (tb_attn::takes_cluster): path S, the
    cluster over T, or path L, the 32-row blocks."""
    c = fwd_constants()
    row_blocks = -(-S // c["ROWS_L"]) * H * B
    return S <= c["ROWS_S"] and -(-T // c["TK"]) <= c["MAX_CLUSTER"] and row_blocks < c["LARGE_GRID"]


def fwd_inputs(B, S, T, D, seed, kv_dtype=torch.float32, offset=0):
    """q, k, v (k/v at a storage offset of `offset` elements: 1 is not
    16-byte aligned, the kernel's plain-copy path), a full mask with an
    all-masked row and, where B > 1, a scene with every target masked, and
    a padding mask (stride 0 over S) with the last 40% of the keys masked
    (dead key tiles and cluster ranks) and, where B > 1, scene 1's keys all
    masked."""
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.normal(size=(B, S, D)).astype(np.float32))
    k, v = (torch.from_numpy(rs.normal(size=B * T * D + offset).astype(np.float32)).to(kv_dtype)[offset:].view(B, T, D)
            for _ in range(2))
    full = torch.from_numpy(rs.rand(B, S, T) < 0.3)
    full[0, 1] = True
    pad = torch.zeros(B, T, dtype=torch.bool)
    pad[:, int(T * 0.6):] = True
    if B > 1:
        full[1] = True
        pad[1] = True
    return q, k, v, full, pad[:, None, :].expand(B, S, T)


def dead_rows(invalid):
    return invalid.all(-1)  # [B, S]


@pytest.mark.parametrize("B,S,T,D,H,bf16,offset,path", [
    (2, 37, 300, 128, 4, True, 0, "S"),  # d_head 32: three ranks, S and T off the tiles
    (1, 64, 1000, 64, 4, False, 0, "S"),  # d_head 16: eight ranks, the last partial; dead ranks
    (2, 20, 200, 128, 2, True, 1, "S"),  # d_head 64, unaligned K/V
    (1, 70, 260, 128, 4, False, 0, "L"),  # d_head 32: three row blocks, the last of 6 rows
    (2, 100, 130, 64, 4, True, 0, "L"),  # d_head 16
    (1, 80, 300, 128, 2, False, 1, "L"),  # d_head 64, unaligned K/V
    (2, 37, 300, 256, 2, True, 0, "S"),  # d_head 128: the weighted sum in two column passes
    (1, 40, 200, 128, 1, False, 1, "S"),  # d_head 128, fp32 K/V, unaligned
    (1, 70, 260, 128, 1, False, 0, "L"),  # d_head 128, fp32 K/V: one K/V tile buffer
    (2, 66, 140, 256, 2, True, 0, "L"),  # d_head 128, bf16 K/V: two tile buffers
])
def test_k1_forward_emulated_matches_plain(emulated, B, S, T, D, H, bf16, offset, path):
    """K1 (csrc/fused_attention.cu -> attn_fwd.cuh) on both paths, both K/V
    types, every head width, with a full and a stride-0 padding mask:
    within 1e-5 of the plain version, all-masked rows exactly 0, two calls
    bitwise equal."""
    assert takes_cluster(B, S, T, H) == (path == "S")
    fn = emulated["fused_attention"].tb_fused_attention
    fn.argtypes, fn.restype = list(tfa._ARGS), ctypes.c_int
    q, k, v, full, pad = fwd_inputs(B, S, T, D, S + T, torch.bfloat16 if bf16 else torch.float32, offset)
    for invalid in (full, pad):
        outs = []
        for _ in range(2):
            out = torch.full_like(q, float("nan"))
            assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), None, out.data_ptr(), B, S, T, D,
                      H, int(bf16), invalid.stride(0), invalid.stride(1), *ws_args(q, T, H, 2 if bf16 else 4),
                      None) == 0
            outs.append(out)
        ref = tfa.attention_core_plain(q, k, v, invalid, H)
        torch.testing.assert_close(outs[0], ref, atol=1e-5, rtol=1e-5)
        assert (outs[0][dead_rows(invalid)] == 0).all()
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("B,S,T,D,H,path", [
    (2, 37, 300, 128, 4, "S"),  # d_head 32: three ranks, S and T off the tiles
    (1, 64, 1000, 64, 4, "S"),  # d_head 16: eight ranks, the last partial; dead ranks
    (1, 70, 260, 128, 4, "L"),  # d_head 32: three row blocks, the last of 6 rows
    (1, 80, 300, 128, 2, "L"),  # d_head 64
    (1, 70, 260, 128, 1, "L"),  # d_head 128: K and V in slabs of 64 columns
])
def test_k1_bf16_emulated_matches_plain(emulated, record_property, B, S, T, D, H, path):
    """K1's bf16 variant (tb_fused_attention_bf16: bf16 q/k/v, weights
    rounded to bf16, a bf16 output) on both paths (`path`: fp32 K1's for
    the shape; path S gives way to path L where path L's blocks fill the
    card, on the emulator's two SMs wherever B H > 1), with a full and a
    stride-0 padding mask, against the plain version's bf16 function: the
    output within a relative norm error of K1_BF16_RTOL (the sums run in
    another order, and a weight or an output on a bf16 rounding boundary
    then lands one bf16 ulp away), all-masked rows exactly 0, two calls
    bitwise equal."""
    assert takes_cluster(B, S, T, H) == (path == "S")
    fn = emulated["fused_attention"].tb_fused_attention_bf16
    fn.argtypes, fn.restype = list(tfa._ARGS_BF16), ctypes.c_int
    q, k, v, full, pad = fwd_inputs(B, S, T, D, 3 * S + T, torch.bfloat16)
    q = q.to(torch.bfloat16)
    for invalid in (full, pad):
        outs = []
        for _ in range(2):
            out = torch.full_like(q, float("nan"))
            assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), None, out.data_ptr(), B, S, T, D,
                      H, invalid.stride(0), invalid.stride(1), None) == 0
            outs.append(out)
        ref = tfa.attention_core_plain(q, k, v, invalid, H)
        assert ref.dtype == torch.bfloat16
        err = ((outs[0].float() - ref.float()).norm() / ref.float().norm()).item()
        record_property(f"rel_norm_err_{'full' if invalid is full else 'pad'}", err)
        assert err < K1_BF16_RTOL, err
        assert (outs[0][dead_rows(invalid)] == 0).all()
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("B,S,T,D,H,dead", [
    (1, 20, 300, 32, 1, ((12, 20),)),  # one row block: path S (three ranks), the last rows dead
    (1, 40, 1024, 64, 1, ()),  # d_head 64 at T = 1024: K and V do not both fit, V takes K's place
    (1, 100, 300, 32, 1, ((0, 32), (90, 100))),  # one head: 2 blocks walk 4 row blocks, the first all dead
    (1, 24, 300, 128, 1, ((16, 24),)),  # d_head 128 on path S (three ranks), the last rows dead
    (1, 40, 1024, 128, 1, ((0, 32),)),  # d_head 128 at T = 1024: K and V in slabs, the first row block dead
])
def test_k1_bf16_emulated_layouts(emulated, B, S, T, D, H, dead):
    """K1-bf16's layouts beyond test_k1_bf16_emulated_matches_plain's:
    path S (which the emulator's two SMs take only for a single row block),
    path L with V staged in K's place once the logits are made, and path L
    with K and V resident in blocks that walk several row blocks of a head,
    with dead rows (`src_invalid`), on path L a first row block all dead;
    a full and a stride-0 padding mask: the output within K1_BF16_RTOL of
    the plain version (with the same `src_invalid`), dead and all-masked
    rows 0, live rows bitwise the output without `src_invalid`."""
    row_blocks = -(-S // fwd_constants()["ROWS_L"]) * H * B
    assert (takes_cluster(B, S, T, H) and row_blocks < 2) == (S <= 32)  # the emulator's card: two SMs
    q, k, v, full, pad = fwd_inputs(B, S, T, D, 17 + S, torch.bfloat16)
    q = q.to(torch.bfloat16)
    src = torch.zeros(B, S, dtype=torch.bool)
    for r0, r1 in dead:
        src[:, r0:r1] = True
    for invalid in (full, pad):
        out = k1_emulated(emulated, q, k, v, invalid, src if dead else None, H)
        ref = tfa.attention_core_plain(q, k, v, invalid, H, src if dead else None)
        assert ((out.float() - ref.float()).norm() / ref.float().norm()).item() < K1_BF16_RTOL
        live = tfa.row_live(invalid, src)
        assert (out[~live] == 0).all()
        if dead:
            assert torch.equal(out[live], k1_emulated(emulated, q, k, v, invalid, None, H)[live])


def k1_emulated(emulated, q, k, v, invalid, src_invalid, H):
    """One emulated K1 call (the bf16 variant for bf16 q), its output."""
    (B, S, D), T = q.shape, k.shape[1]
    bf16_q = q.dtype == torch.bfloat16
    fn = emulated["fused_attention"].tb_fused_attention_bf16 if bf16_q else emulated["fused_attention"].tb_fused_attention
    fn.argtypes, fn.restype = list(tfa._ARGS_BF16 if bf16_q else tfa._ARGS), ctypes.c_int
    out = torch.full_like(q, float("nan"))
    kv_flag = () if bf16_q else (int(k.dtype == torch.bfloat16),)
    ws = () if bf16_q else ws_args(q, T, H, k.element_size())
    src = None if src_invalid is None else src_invalid.data_ptr()
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), src, out.data_ptr(), B, S, T, D, H,
              *kv_flag, invalid.stride(0), invalid.stride(1), *ws, None) == 0
    return out


@pytest.mark.parametrize("B,S,T,D,H,bf16,live_rows,path", [
    # fp32 q, bf16 K/V, padding mask (stride 0): scene 0 partly dead, scene 1's clusters all dead
    (2, 40, 300, 64, 2, False, (24, 0), "S"),
    # K1-bf16, full mask: row block 0 live, block 1 partly dead, block 2 all dead
    (1, 96, 260, 64, 2, True, (40,), "L"),
    # d_head 128: fp32 q on path S; K1-bf16 on path L's slabs
    (2, 40, 300, 256, 2, False, (24, 0), "S"),
    (1, 96, 260, 128, 1, True, (40,), "L"),
])
def test_k1_skip_emulated(emulated, B, S, T, D, H, bf16, live_rows, path):
    """K1's dead-query-row skip (`src_invalid`): every dead row exactly 0,
    every live row bitwise equal to K1 without `src_invalid`, and the
    output against the plain version with the same `src_invalid` (within
    1e-5, the bf16 variant within K1_BF16_RTOL of relative norm error)."""
    assert takes_cluster(B, S, T, H) == (path == "S")
    q, k, v, full, pad = fwd_inputs(B, S, T, D, 5 * S + T, torch.bfloat16)
    invalid = full if bf16 else pad
    if bf16:
        q = q.to(torch.bfloat16)
    src_invalid = torch.arange(S)[None, :] >= torch.tensor(live_rows)[:, None]
    out = k1_emulated(emulated, q, k, v, invalid, src_invalid, H)
    unskipped = k1_emulated(emulated, q, k, v, invalid, None, H)
    live = tfa.row_live(invalid, src_invalid)
    assert (out[~live] == 0).all()
    assert torch.equal(out[live], unskipped[live])
    ref = tfa.attention_core_plain(q, k, v, invalid, H, src_invalid)
    if bf16:
        assert ((out.float() - ref.float()).norm() / ref.float().norm()).item() < K1_BF16_RTOL
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_k3_skip_emulated_forward_and_backward(emulated):
    """K3f with `src_invalid` on path L (three row blocks: live, partly dead,
    all dead), dropout live: live rows' output and row statistics bitwise
    those of K3f without it, dead rows 0 with max -inf and sum 0; K3b on
    the skipped forward, with the cotangent zero on dead rows, gives the
    unskipped forward's dq, dk, dv bit for bit (up to the sign of a zero)
    and autograd's through the plain version within a relative norm error
    of 1e-5."""
    B, S, T, D, H, p = 1, 96, 130, 64, 2, 0.1
    assert not takes_cluster(B, S, T, H)
    q, k, v, _, invalid = fwd_inputs(B, S, T, D, 11)
    src_invalid = torch.arange(S)[None, :] >= 40
    live = tfa.row_live(invalid, src_invalid)
    g = torch.from_numpy(np.random.RandomState(12).normal(size=(B, S, D)).astype(np.float32))
    g[~live] = 0  # the callers zero dead rows
    seed, site = 2**45 + 9, 1
    fn = emulated["attention_train"].tb_attention_train_fwd
    fn.argtypes, fn.restype = list(tat._FWD_ARGS), ctypes.c_int

    def fwd(src):
        out = torch.full_like(q, float("nan"))
        rmax, rsum = (torch.full((B, H, S), float("nan")) for _ in range(2))
        assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), src, out.data_ptr(), rmax.data_ptr(),
                  rsum.data_ptr(), B, S, T, D, H, invalid.stride(0), invalid.stride(1),
                  *tat._dropout_args(p, seed, site), *ws_args(q, T, H, 4), None) == 0
        return out, rmax, rsum

    (out, rmax, rsum), (out0, rmax0, rsum0) = fwd(src_invalid.data_ptr()), fwd(None)
    hl = live[:, None, :].expand(B, H, S)
    assert torch.equal(out[live], out0[live]) and (out[~live] == 0).all()
    assert torch.equal(rmax[hl], rmax0[hl]) and torch.equal(rsum[hl], rsum0[hl])
    assert (rmax[~hl] == float("-inf")).all() and (rsum[~hl] == 0).all()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tat.attention_train_plain(*leaves, invalid, H, p, seed, site, src_invalid=src_invalid)
    ref.backward(g)
    torch.testing.assert_close(out, ref.detach(), atol=1e-5, rtol=1e-5)
    skipped = emulated_backward(emulated, q, k, v, invalid, out, rmax, rsum, g, H, p, seed, site)[:3]
    unskipped = emulated_backward(emulated, q, k, v, invalid, out0, rmax0, rsum0, g, H, p, seed, site)[:3]
    for name, a, b, leaf in zip(("dq", "dk", "dv"), skipped, unskipped, leaves):
        assert torch.equal(a + 0.0, b + 0.0), name  # + 0.0: -0 and +0 alike
        assert ((a - leaf.grad).norm() / leaf.grad.norm()).item() < 1e-5, name


@pytest.mark.parametrize("B,S,T,D,H,full_mask,p,path", [
    (2, 48, 300, 128, 4, True, 0.1, "S"),
    (2, 64, 1000, 64, 4, False, 0.0, "S"),
    (2, 70, 260, 64, 4, False, 0.1, "L"),
    (1, 100, 200, 128, 4, True, 0.0, "L"),
    (2, 70, 260, 128, 2, True, 0.1, "L"),  # d_head 64
    (2, 48, 300, 256, 2, True, 0.1, "S"),  # d_head 128
    (1, 70, 260, 128, 1, False, 0.1, "L"),  # d_head 128: one K/V tile buffer
])
def test_k3f_forward_emulated_feeds_k3b(emulated, B, S, T, D, H, full_mask, p, path):
    """K3f (csrc/attention_train.cu -> attn_fwd.cuh) with dropout live or
    off: the output within 1e-5 of the plain version, the row statistics
    within 1e-6 of the plain ones (-inf and 0 on all-masked rows), and fed
    through the emulated K3b, dq, dk, dv within a relative norm error of
    1e-5 of autograd through the plain version."""
    assert takes_cluster(B, S, T, H) == (path == "S")
    q, k, v, full, pad = fwd_inputs(B, S, T, D, 7 * S + T)
    invalid = full if full_mask else pad
    g = torch.from_numpy(np.random.RandomState(S).normal(size=(B, S, D)).astype(np.float32))
    seed, site = 2**45 + 7, 4
    out = torch.full_like(q, float("nan"))
    rmax, rsum = (torch.full((B, H, S), float("nan")) for _ in range(2))
    fn = emulated["attention_train"].tb_attention_train_fwd
    fn.argtypes, fn.restype = list(tat._FWD_ARGS), ctypes.c_int
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), None, out.data_ptr(), rmax.data_ptr(),
              rsum.data_ptr(), B, S, T, D, H, invalid.stride(0), invalid.stride(1), *tat._dropout_args(p, seed, site),
              *ws_args(q, T, H, 4), None) == 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tat.attention_train_plain(*leaves, invalid, H, p, seed, site)
    ref.backward(g)
    torch.testing.assert_close(out, ref.detach(), atol=1e-5, rtol=1e-5)
    assert (out[dead_rows(invalid)] == 0).all()
    m, l = row_stats(q, k, invalid, H)
    torch.testing.assert_close(rmax, m, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(rsum, l, atol=1e-6, rtol=1e-6)
    dq, dk, dv, _ = emulated_backward(emulated, q, k, v, invalid, out, rmax, rsum, g, H, p, seed, site)
    for name, got, leaf in zip(("dq", "dk", "dv"), (dq, dk, dv), leaves):
        assert torch.isfinite(got).all(), name
        assert ((got - leaf.grad).norm() / leaf.grad.norm()).item() < 1e-5, name


@pytest.mark.parametrize("B,S,T,D,H,full_mask,p", [
    (2, 48, 300, 128, 4, True, 0.1),  # partial tiles, an all-masked row, dead key tiles; 16-row dq blocks
    (2, 70, 200, 64, 4, False, 0.0),  # d_head 16, no dropout
    (8, 256, 130, 128, 4, False, 0.1),  # 128 blocks of 64 rows: the 64-row dq blocks
    (4, 130, 70, 64, 2, True, 0.2),
    (2, 100, 140, 256, 4, False, 0.1),  # d_head 64
    (2, 70, 130, 256, 2, True, 0.1),  # d_head 128: 64-row dq blocks below 128 of them
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
    o = out.detach().contiguous()
    dq, dk, dv, dsum = emulated_backward(emulated, q, k, v, invalid, o, rmax, rsum, g, H, p, seed, site)
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


def test_div_rn_is_the_ieee_quotient(tmp_path):
    """attn_fwd.cuh's div_rn (a product by the reciprocal and one FMA
    correction, in place of a division) gives x / d bit for bit: the
    logits' x / sqrt(dh) at each head width and the weights' e / sum, over
    random floats of many exponents."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    (tmp_path / "check.cpp").write_text(emulated_source(r"""
#include <cuda_runtime.h>
#include "attn_fwd.cuh"
#include <cstdio>
#include <random>
int main() {
    std::mt19937 g(5);
    long bad = 0;
    const float ds[] = {sqrtf(16.f), sqrtf(32.f), sqrtf(64.f)};
    for (float d : ds)
        for (int i = 0; i < 1000000; ++i) {
            uint32_t u = (g() & 0x807fffffu) | ((uint32_t)(87 + g() % 80) << 23);  // 2^-40 .. 2^39
            float x;
            std::memcpy(&x, &u, 4);
            const float q = tb_attn::div_rn(x, d, 1.f / d), ref = x / d;
            bad += std::memcmp(&q, &ref, 4) != 0;
        }
    std::uniform_real_distribution<float> sums(1.f, 1300.f), es(0.f, 1.f);
    for (int i = 0; i < 3000000; ++i) {
        const float s = sums(g), e = es(g), q = tb_attn::div_rn(e, s, 1.f / s), ref = e / s;
        bad += std::memcmp(&q, &ref, 4) != 0;
    }
    std::printf("%ld\\n", bad);
    return bad != 0;
}
"""))
    exe = tmp_path / "check"
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread", f"-I{EMU}", f"-I{cuda_build.CSRC}",
                    "-o", str(exe), str(tmp_path / "check.cpp")], check=True)
    res = subprocess.run([str(exe)], capture_output=True, text=True)
    assert res.returncode == 0, f"div_rn differs from x / d in {res.stdout.strip()} cases"


def test_k3_wrapper_mirrors_the_kernels_layout():
    """The wrappers' shared-memory checks mirror csrc/attn_fwd.cuh and
    csrc/attention_train.cu: their tile constants, and at T = 1024 the
    largest block is the forward's path-L block (the [32, T] logits, q, two
    128-key K/V tiles, the mask bits, eight warp columns' and the final row
    max and sum, the live tiles and their flags), within a block's limit;
    past the T whose logits fit, path G's block (path L's without the
    logits) takes T."""
    src = (cuda_build.CSRC / "attention_train.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    fwd = fwd_constants()
    assert (fwd["ROWS_L"], fwd["TK"], const["BT"], const["PAD"]) == (tat.ROWS_PER_BLOCK, tfa.KEY_TILE, tat.BWD_TILE,
                                                                     tat._PAD)
    assert const["MIN_BLOCKS"] == 128 and tat.DQ_ROWS == (16, 64)
    rows_l = 4 * (32 * (1024 + 8) + 32 * (32 + 4) + 2 * 128 * (32 + 4) + 32 * 32 + (8 + 2) * 32 + 2 * 8)
    assert tat.smem_bytes(1024, 32) == tfa.smem_bytes(1024, 32) == rows_l == 179008 <= tat.SMEM_LIMIT
    assert tfa.smem_bytes(1024, 32, 2) < rows_l  # bf16 K/V tiles take half
    assert tfa.smem_bytes(4096, 32) > tat.SMEM_LIMIT and tfa.takes_workspace(4096, 32)
    assert tfa.ws_smem_bytes(4096, 32) == tfa.smem_bytes(4096, 32) - 4 * 32 * (4096 + 8) == 59392
    assert tat.smem_bytes(4096, 32) == 92352  # path G's block below K3b's 16-row dq block, which T does not grow
    assert fwd["WS_BLOCKS_PER_SM"] == tfa.WS_BLOCKS_PER_SM
    # d_head 128: path L's one fp32 K/V tile (two bf16 ones) beside T = 1024 keys' logits; K1-bf16's
    # slabs; K3b's 64-row dq block (157,440 B) and its dk/dv block (174,848 B) below the forward's
    assert (fwd["KV_BUF_BYTES"], fwd["CS"]) == (tfa.KV_BUF_BYTES, tfa.SLAB)
    assert tfa.smem_bytes(1024, 128) == tat.smem_bytes(1024, 128) == 4 * (32 * 1032 + 32 * 132 + 128 * 132 + 32 * 32
                                                                          + 10 * 32 + 16) == 222016
    assert tfa.smem_bytes(1024, 128, 2) == 224064 and tfa.smem_bytes_bf16(1024, 128) == 228128
    assert all(tfa.kernel_refusal(1024, 256, 2, kv, bf16) is None for kv, bf16 in ((4, False), (2, False), (2, True)))
    assert tat.kernel_refusal(1024, 128, 1) is None and tat.kernel_refusal(1152, 256, 2) is None  # path G
    assert tfa.kernel_refusal(1152, 256, 2) is None and tfa.kernel_refusal(1024, 256, 1) is not None
