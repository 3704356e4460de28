"""K1, K1-bf16, K1-skip, K3f and K3b past 1,024 keys, as CUDA source, run on
the CPU against their plain versions.

The emulator of tests/test_torch_cuda_emu.py (tests/cuda_emu/cuda_runtime.h;
its card has EMU_SMS = 2 SMs) runs `csrc/fused_attention.cu` and
`csrc/attention_train.cu` at T of 1,100, 1,536, 2,048 and (K3b) 4,096 keys:

- the fp32 forward (K1 with fp32 or bf16 K/V, K3f) on path L past eight
  key tiles (T = 1,100 at d_head 16 and 32, where the [32, T] logits still
  fit shared memory; path S takes at most eight) and on path G, whose
  logits lie in a global workspace (T = 1,536 and 2,048, and d_head 128 at
  1,152), with its blocks walking more work items than they are;
- K1-bf16's path L in rounds of eight key tiles (every T past 1,024),
  d_head 16 to 128;
- the dead-query-row skip on both;
- K3b fed by K3f's row statistics, and alone at 4,096 keys.

Tolerances are tests/test_torch_cuda_emu.py's: the fp32 forwards within
atol = rtol = 1e-5 of the plain versions, K1-bf16 within a relative norm
error of 1e-3, K3f's row statistics within 1e-6, dq, dk, dv within a
relative norm error of 1e-5 of autograd through the plain version.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_cuda_emu import (EMU, K1_BF16_RTOL, dead_rows, emulated_backward, emulated_source, fwd_inputs,
                                 k1_emulated, row_stats, takes_cluster, ws_args, _WORKSPACES)
from torch_one_thread import one_torch_thread  # noqa: F401
from trafficbots_tpu_torch.ops import attention_train as tat
from trafficbots_tpu_torch.ops import cuda_build
from trafficbots_tpu_torch.ops import fused_attention as tfa


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """name -> the ctypes library of csrc/<name>.cu built for the emulator."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the CPU emulator")
    out_dir = tmp_path_factory.mktemp("cuda_emu_long")
    libs = {}
    for name in ("fused_attention", "attention_train"):
        cpp = out_dir / f"{name}.cpp"
        cpp.write_text(emulated_source((cuda_build.CSRC / f"{name}.cu").read_text()))
        lib = out_dir / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
                        f"-I{EMU}", f"-I{cuda_build.CSRC}", "-o", str(lib), str(cpp)], check=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def path_of(B, S, T, D, H, kv_bytes):
    """The fp32 forward's path: S (the cluster), L or G (the workspace)."""
    if takes_cluster(B, S, T, H):
        return "S"
    return "G" if tfa.takes_workspace(T, D // H, kv_bytes) else "L"


@pytest.mark.parametrize("B,S,T,D,H,bf16,path", [
    (1, 64, 1100, 32, 2, False, "L"),  # d_head 16: nine key tiles, the last partial; no cluster
    (1, 40, 1100, 32, 1, True, "L"),  # d_head 32, bf16 K/V
    (1, 96, 1536, 64, 2, False, "G"),  # d_head 32: six work items over the grid's two blocks
    (1, 64, 2048, 32, 2, False, "G"),  # d_head 16
    (2, 32, 2048, 32, 1, True, "G"),  # d_head 32, bf16 K/V, two scenes (scene 1 all masked)
    (1, 40, 1152, 128, 1, False, "G"),  # d_head 128: one fp32 K/V tile buffer
])
def test_k1_long_emulated_matches_plain(emulated, B, S, T, D, H, bf16, path):
    """K1 past 1,024 keys, fp32 or bf16 K/V, a full and a stride-0 padding
    mask (its last 40% of keys masked: dead key tiles): within 1e-5 of the
    plain version, all-masked rows exactly 0, two calls bitwise equal; on
    path G the workspace written."""
    assert path_of(B, S, T, D, H, 2 if bf16 else 4) == path
    q, k, v, full, pad = fwd_inputs(B, S, T, D, S + T, torch.bfloat16 if bf16 else torch.float32)
    for invalid in (full, pad):
        n_ws = len(_WORKSPACES)
        out = k1_emulated(emulated, q, k, v, invalid, None, H)
        if path == "G":  # the logits went through the workspace
            assert not torch.isnan(_WORKSPACES[n_ws]).all()
        torch.testing.assert_close(out, tfa.attention_core_plain(q, k, v, invalid, H), atol=1e-5, rtol=1e-5)
        assert (out[dead_rows(invalid)] == 0).all()
        assert torch.equal(out, k1_emulated(emulated, q, k, v, invalid, None, H))


@pytest.mark.parametrize("B,S,T,D,H", [
    (1, 32, 1100, 32, 2),  # d_head 16: two rounds, the second of one partial tile
    (1, 64, 1536, 32, 1),  # d_head 32: two row blocks, two rounds of six tiles
    (1, 32, 2048, 64, 2),  # d_head 32: two full rounds
    (2, 24, 1152, 128, 1),  # d_head 128: the logits over four column slabs, four output slabs
])
def test_k1_bf16_long_emulated_matches_plain(emulated, record_property, B, S, T, D, H):
    """K1-bf16 past eight key tiles (its rounds of key tiles, the logits
    recomputed in each pass), a full and a padding mask: within a relative
    norm error of K1_BF16_RTOL of the plain version's bf16 function,
    all-masked rows exactly 0, two calls bitwise equal."""
    assert T > tfa.BF16_WARP_TILES * tfa.KEY_TILE
    q, k, v, full, pad = fwd_inputs(B, S, T, D, 3 * S + T, torch.bfloat16)
    q = q.to(torch.bfloat16)
    for invalid in (full, pad):
        out = k1_emulated(emulated, q, k, v, invalid, None, H)
        ref = tfa.attention_core_plain(q, k, v, invalid, H)
        err = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        record_property(f"rel_norm_err_{'full' if invalid is full else 'pad'}", err)
        assert err < K1_BF16_RTOL, err
        assert (out[dead_rows(invalid)] == 0).all()
        assert torch.equal(out, k1_emulated(emulated, q, k, v, invalid, None, H))


@pytest.mark.parametrize("B,S,T,D,H,bf16,live_rows", [
    (2, 96, 1536, 64, 2, False, (40, 0)),  # path G: scene 0's third row block dead, scene 1 all dead
    (1, 96, 1100, 32, 1, True, (40,)),  # K1-bf16's rounds: row block 0 live, 1 partly dead, 2 dead
])
def test_k1_skip_long_emulated(emulated, B, S, T, D, H, bf16, live_rows):
    """K1's dead-query-row skip past 1,024 keys: every dead row exactly 0,
    every live row bitwise K1 without `src_invalid`, and the output against
    the plain version with the same `src_invalid`."""
    q, k, v, full, pad = fwd_inputs(B, S, T, D, 5 * S + T, torch.bfloat16)
    invalid = full if bf16 else pad
    if bf16:
        q = q.to(torch.bfloat16)
    src_invalid = torch.arange(S)[None, :] >= torch.tensor(live_rows)[:, None]
    out = k1_emulated(emulated, q, k, v, invalid, src_invalid, H)
    live = tfa.row_live(invalid, src_invalid)
    assert (out[~live] == 0).all()
    assert torch.equal(out[live], k1_emulated(emulated, q, k, v, invalid, None, H)[live])
    ref = tfa.attention_core_plain(q, k, v, invalid, H, src_invalid)
    if bf16:
        assert ((out.float() - ref.float()).norm() / ref.float().norm()).item() < K1_BF16_RTOL
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def k3f_emulated(emulated, q, k, v, invalid, H, p, seed, site, src_invalid=None):
    """One emulated K3f call: its output and row statistics."""
    (B, S, D), T = q.shape, k.shape[1]
    fn = emulated["attention_train"].tb_attention_train_fwd
    fn.argtypes, fn.restype = list(tat._FWD_ARGS), ctypes.c_int
    out = torch.full_like(q, float("nan"))
    rmax, rsum = (torch.full((B, H, S), float("nan")) for _ in range(2))
    src = None if src_invalid is None else src_invalid.data_ptr()
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), invalid.data_ptr(), src, out.data_ptr(), rmax.data_ptr(),
              rsum.data_ptr(), B, S, T, D, H, invalid.stride(0), invalid.stride(1), *tat._dropout_args(p, seed, site),
              *ws_args(q, T, H, 4), None) == 0
    return out, rmax, rsum


@pytest.mark.parametrize("B,S,T,D,H,full_mask,p,skip", [
    (1, 40, 1100, 32, 1, True, 0.0, False),  # path L past eight tiles, d_head 32
    (1, 96, 1536, 64, 2, False, 0.1, False),  # path G, d_head 32: six work items, two blocks
    (1, 64, 2048, 32, 2, True, 0.1, False),  # path G, d_head 16
    (1, 96, 1536, 64, 2, False, 0.1, True),  # path G with the skip: rows 40.. dead
])
def test_k3_long_emulated(emulated, B, S, T, D, H, full_mask, p, skip):
    """K3f past 1,024 keys with dropout live or off: the output within 1e-5
    of the plain version, the row statistics within 1e-6 of the plain ones
    (-inf and 0 on all-masked and dead rows), and through the emulated K3b,
    dq, dk, dv within a relative norm error of 1e-5 of autograd through the
    plain version (with `src_invalid`, the cotangent zero on dead rows as
    the callers give it)."""
    q, k, v, full, pad = fwd_inputs(B, S, T, D, 7 * S + T)
    invalid = full if full_mask else pad
    src_invalid = torch.arange(S)[None, :].expand(B, S) >= 40 if skip else None
    live = tfa.row_live(invalid, src_invalid)
    g = torch.from_numpy(np.random.RandomState(S).normal(size=(B, S, D)).astype(np.float32))
    g[~live] = 0
    seed, site = 2**45 + 7, 4
    out, rmax, rsum = k3f_emulated(emulated, q, k, v, invalid, H, p, seed, site,
                                   None if src_invalid is None else src_invalid.contiguous())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tat.attention_train_plain(*leaves, invalid, H, p, seed, site, src_invalid=src_invalid)
    ref.backward(g)
    torch.testing.assert_close(out, ref.detach(), atol=1e-5, rtol=1e-5)
    assert (out[~live] == 0).all()
    m, l = row_stats(q, k, invalid, H)
    hl = live[:, None, :].expand(B, H, S)
    torch.testing.assert_close(rmax[hl], m[hl], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(rsum[hl], l[hl], atol=1e-6, rtol=1e-6)
    assert (rmax[~hl] == float("-inf")).all() and (rsum[~hl] == 0).all()
    dq, dk, dv, _ = emulated_backward(emulated, q, k, v, invalid, out, rmax, rsum, g, H, p, seed, site)
    for name, got, leaf in zip(("dq", "dk", "dv"), (dq, dk, dv), leaves):
        assert torch.isfinite(got).all(), name
        assert ((got - leaf.grad).norm() / leaf.grad.norm()).item() < 1e-5, name


@pytest.mark.parametrize("B,S,T,D,H,p", [
    (1, 32, 4096, 32, 2, 0.1),  # 64 key blocks of the dk/dv kernel, 16-row dq blocks over 64 key tiles
    (1, 70, 2048, 64, 4, 0.2),  # d_head 16
])
def test_k3b_long_emulated_matches_plain(emulated, B, S, T, D, H, p):
    """K3b alone at 2,048 and 4,096 keys (a full mask with an all-masked
    row and the last quarter of the keys masked for every row), on the
    plain forward's output and row statistics: dq, dk, dv within a relative
    norm error of 1e-5 of autograd, D = g . out within 1e-5."""
    rs = np.random.RandomState(S + T)
    q, k, v, g = (torch.from_numpy(rs.normal(size=s).astype(np.float32))
                  for s in ((B, S, D), (B, T, D), (B, T, D), (B, S, D)))
    invalid = torch.from_numpy(rs.rand(B, S, T) < 0.3)
    invalid[0, 1] = True
    invalid[:, :, 3 * T // 4:] = True
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
    assert (dk[:, 3 * T // 4:] == 0).all() and (dv[:, 3 * T // 4:] == 0).all()
    torch.testing.assert_close(dsum, torch.einsum("bshd,bshd->bhs", g.view(B, S, H, -1), o.view(B, S, H, -1)),
                               atol=1e-5, rtol=1e-5)
