"""Where a block of the attention forward (csrc/attn_fwd.cuh) spends its time.

    python3 -m trafficbots_tpu_torch.ops.attn_fwd_trace [--bf16]

Builds `csrc/fused_attention.cu` (K1) a second time with `-DTB_ATTN_TRACE`,
into `build/trace/`: thread 0 of every block then adds the clock64 cycles
between the kernel's phase marks (`TB_TRACE` in the header) to a device
counter. Runs K1 at the main path's sites (the rollout's as2pl at 8 and 48
scenes, path S; the map self-attention and the latent as2pl, path L) on
seeded inputs with a padding mask over the last quarter of the keys, and
prints, for each site, the card's name, its ms a call (CUDA events over 10
calls of the traced build) and each phase's mean cycles a block. A phase's
cycles are those of one thread and include its waits at barriers; blocks
that share an SM overlap, so the phases of a block add up to more than the
call's time over the waves. With --bf16, the same for K1-bf16
(tb_fused_attention_bf16, the tensor-core kernels fwd_rows_mma and
fwd_cluster_mma) on bf16 q, k and v. Needs an NVIDIA GPU with nvcc
(sm_90a).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from . import cuda_build
from .fused_attention import _ARGS, _ARGS_BF16

PHASES = {
    "L": ("q issued, mask bits", "live tiles, fills", "logits", "row max, exp, sum", "weights", "weighted sum",
          "partials, output"),
    "S": ("q and K arrived, mask bits", "logits", "slice max exchanged", "exp, slice sum", "sum exchanged, weights",
          "weighted sum", "groups' partials", "ranks' partials, output"),
}
# K1-bf16 (logits and weights in registers, V staged beside K or in its place)
PHASES_BF16 = {
    "L": ("q, K (and V) issued, mask bits, live tiles", "q and K arrived", "logits", "row max, exp, sum, V arrived",
          "weights, weighted sum", "tiles' partials, output"),
    "S": ("q and K arrived, mask bits", "logits", "slice max exchanged", "exp, slice sum",
          "sum exchanged, V arrived", "weights, weighted sum", "halves' sums", "ranks' partials, output"),
}
SITES = (("rollout as2pl", 8, 64, True), ("joint futures rollout as2pl", 48, 64, True),
         ("map polyline self-attention", 8, 1024, False), ("latent as2pl", 8, 19 * 64, False))


def build() -> ctypes.CDLL:
    out_dir = cuda_build.BUILD / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libfused_attention_trace.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DTB_ATTN_TRACE", "-o", str(lib),
                    str(cuda_build.CSRC / "fused_attention.cu")], check=True)
    return ctypes.CDLL(str(lib))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attn_fwd_trace: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    lowp = sys.argv[1:] == ["--bf16"]
    lib = build()
    fn = lib.tb_fused_attention_bf16 if lowp else lib.tb_fused_attention
    fn.argtypes, fn.restype = list(_ARGS_BF16 if lowp else _ARGS), ctypes.c_int
    phases = PHASES_BF16 if lowp else PHASES
    counts = (ctypes.c_ulonglong * 32)()
    gen = torch.Generator().manual_seed(0)
    T, D, H, n_call = 1024, 128, 4, 10
    for name, B, S, bf16 in SITES:
        q = torch.randn(B, S, D, generator=gen).cuda()
        k, v = (torch.randn(B, T, D, generator=gen).cuda() for _ in range(2))
        if bf16 or lowp:
            k, v = k.bfloat16(), v.bfloat16()
        if lowp:
            q = q.bfloat16()
        pad = torch.zeros(B, T, dtype=torch.bool)
        pad[:, 3 * T // 4:] = True
        inv = pad.cuda()[:, None, :].expand(B, S, T)
        out = torch.empty_like(q)
        stream = cuda_build.stream(q)

        def call():
            kv_flag = () if lowp else (int(bf16),)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), inv.data_ptr(), None, out.data_ptr(), B, S, T, D, H,
                    *kv_flag, inv.stride(0), inv.stride(1), stream)
            cuda_build.check(rc, "traced K1")

        call()
        torch.cuda.synchronize()
        cuda_build.check(lib.tb_attn_trace_zero(), "trace counters")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n_call):
            call()
        e1.record()
        torch.cuda.synchronize()
        cuda_build.check(lib.tb_attn_trace_read(counts), "trace counters")
        for p, path in enumerate("LS"):
            blocks = counts[16 * p + 15]
            if blocks:
                cycles = {ph: round(counts[16 * p + 1 + i] / blocks) for i, ph in enumerate(phases[path])}
                print(f"{name}{' (K1-bf16)' if lowp else ''}: B={B} S={S} T={T} path {path}, {blocks // n_call} blocks, "
                      f"{e0.elapsed_time(e1) / n_call} ms a call, cycles a block by phase {cycles} [{card}]",
                      flush=True)


if __name__ == "__main__":
    main()
