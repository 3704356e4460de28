"""K6 sources side by side on one card: each one's output bits and device ms.

    python3 -m trafficbots_tpu_torch.ops.block_attn_ab SRC.cu [SRC.cu ...]

Builds every listed source of K6 (each a `csrc/block_attn.cu`, e.g. this
commit's and another's from `git show`), all at once, into `build/ab/`, and
runs each source's two entries, K6 (`tb_block_attn`) and K6-bf16
(`tb_block_attn_bf16`), on the main path's input: the validity of 8 seed-0
synthetic scenes of 1024 polylines x 20 nodes at 768/1024 fill, q, k, v
[8192, 20, 128] drawn from a seeded generator, 4 heads. For each it prints
ptxas's registers and spills of the N = 20 kernel, the largest error
against `block_attn_core_plain` (its bf16 function for K6-bf16) on the rows
of polylines with a valid node, the SHA-1 of the whole output (equal
digests: equal bits) and its device ms (a CUDA graph of 20 launches,
replayed; the sources timed in turns, 5 rounds, the median), beside the
card's name and power limit. Needs an NVIDIA GPU with nvcc (sm_90a).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from . import block_attn as BA
from . import cuda_build

ROUNDS = 5
N_GRAPH = 20
# entry -> (C symbol, a test of ptxas's entry line for its N = 20 kernel)
ENTRIES = {
    "K6": ("tb_block_attn", lambda ln: "block_attn_kernelILi20E" in ln and "Lb1E" not in ln),
    "K6-bf16": ("tb_block_attn_bf16", lambda ln: "block_attn_mmaILi3E" in ln or "block_attn_kernelILi20ELb1E" in ln),
}


def build(srcs) -> list:
    """Each source's {entry: (C function, ptxas's lines for its N = 20
    kernel)}."""
    out_dir = cuda_build.BUILD / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(srcs):
        lib = out_dir / f"libblock_attn_{i}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib))
    fns = []
    for src, (p, lib) in zip(srcs, procs):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        lines = log.splitlines()
        entries = {}
        for label, (symbol, is_n20) in ENTRIES.items():
            at = [j for j, ln in enumerate(lines) if "entry function" in ln and is_n20(ln)]
            info = [ln.split(":")[-1].strip() for ln in lines[at[0] + 2:at[0] + 4]] if at else []
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes, fn.restype = list(BA._ARGS), ctypes.c_int
            entries[label] = (fn, info)
        fns.append(entries)
    return fns


def graph_ms(fn) -> float:
    """Device ms a call: N_GRAPH calls in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(N_GRAPH):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (5 * N_GRAPH)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("block_attn_ab: needs a CUDA device")
    srcs = [Path(a) for a in sys.argv[1:]]
    if not srcs:
        sys.exit("block_attn_ab: name one or more K6 sources")
    from ..config import ExperimentConfig
    from ..data.synthetic import synthetic_episode_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    fns = build(srcs)
    batch = synthetic_episode_batch(ExperimentConfig().data, n_scene=8, seed=0, n_valid_pl=768, n_valid_agent=40)
    valid = torch.from_numpy(batch["map/valid"]).reshape(-1, batch["map/valid"].shape[-1]).cuda()
    BP, N = valid.shape
    D, H = 128, 4
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(BP, N, D, generator=gen).cuda() for _ in range(3))
    out = torch.empty_like(q)
    live = valid.any(-1)
    refs = {"K6": BA.block_attn_core_plain(q, k, v, valid, H),
            "K6-bf16": BA.block_attn_core_plain(q, k, v, valid, H, bf16=True)}

    def call(fn):
        return lambda: cuda_build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
                                           BP, N, D, H, 1.0 / math.sqrt(D // H), cuda_build.stream(q)), "K6")

    for src, entries in zip(srcs, fns):
        for label, (fn, info) in entries.items():
            out.fill_(float("nan"))
            call(fn)()
            torch.cuda.synchronize()
            err = (out[live] - refs[label][live]).abs().max().item()
            sha = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:16]
            print(f"{src} {label}: {info}; max_abs_err {err}, all finite {bool(torch.isfinite(out).all())}, "
                  f"sha1 {sha}", flush=True)
    times = [{label: [] for label in ENTRIES} for _ in srcs]
    for _ in range(ROUNDS):
        for i, entries in enumerate(fns):
            for label, (fn, _) in entries.items():
                times[i][label].append(graph_ms(call(fn)))
    for src, by_label in zip(srcs, times):
        for label, t in by_label.items():
            print(f"{src} {label}: device ms median {statistics.median(t)} of {t} [{card}]", flush=True)


if __name__ == "__main__":
    main()
