"""Where the node kernels (K2, K4f, K4b, K6) spend their time, phase by phase.

    python3 -m trafficbots_tpu_torch.ops.node_trace [--widths DxFxH] [LABEL ...]

Builds `csrc/node_encoder.cu`, `csrc/node_encoder_train.cu` and
`csrc/block_attn.cu` a second time with `-DTB_NODE_TRACE`, into
`build/trace/`, and has the wrappers launch those builds: thread 0 of every
block then adds the clock64 cycles between the kernel's phase marks
(`csrc/node_trace.cuh`; each source names its phases) to a device counter.
Runs K2, K4's forward and K4's backward at the main path's shape (8 seed-0
synthetic scenes of 1024 polylines x 20 nodes at 768/1024 fill, d_model 128,
4 heads, 3 layers, dropout 0.1 for K4) and K6 on that validity with seeded
q, k, v [8192, 20, 128], and prints, for each (and for K2-bf16 and K6-bf16,
the bf16 variants, on the same inputs), the card's name and power limit, the
device time of each CUDA kernel the call launches (torch.profiler, the mean
over 5 calls) and each phase's mean cycles a work item (a block, or one
polyline or polyline group of a block that walks several). Blocks that
share the card overlap, so the phases add up to more than the call's time
over the waves. LABELs (K2, K2-bf16, K4f, K4b, K6, K6-bf16) pick the calls;
none runs them all. `--widths 64x64x2` runs K2 and K4 at that d_model,
d_feedforward and head count instead (their build at those widths,
`node_encoder.build_defines`). Needs an NVIDIA GPU with nvcc (sm_90a).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from . import block_attn as BA
from . import cuda_build
from . import node_encoder as NE
from . import node_encoder_train as NT

N_CALL = 5


def build(widths=(128, 128)) -> dict:
    """name -> the traced build of csrc/<name>.cu (the node kernels' at
    widths = (d_model, d_ff)), installed as the library the wrappers
    launch."""
    out_dir = cuda_build.BUILD / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("node_encoder", "node_encoder_train", "block_attn"):
        defines = () if name == "block_attn" else NE.build_defines(*widths)
        lib = out_dir / f"lib{name}_trace{''.join(defines)}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defines, "-DTB_NODE_TRACE", "-o", str(lib),
               str(cuda_build.CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd), lib, defines)
    libs = {}
    for name, (p, lib, defines) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for the traced {name}.cu")
        libs[name] = cuda_build._LIBS[(name, defines)] = ctypes.CDLL(str(lib))
        for key in [k for k in cuda_build._ENTRIES if k[0] == name]:
            del cuda_build._ENTRIES[key]
    return libs


def phases(lib) -> dict:
    """kernel id -> (kernel name, phase names) as the source declares them."""
    fn = lib.tb_node_trace_phases
    fn.restype = ctypes.c_char_p
    out = {}
    for item in fn().decode().split(";"):
        head, names = item.split(":", 1)
        kid, kname = head.strip().split(" ", 1)
        out[int(kid)] = (kname, [n.strip() for n in names.split("|")])
    return out


def device_ms(call) -> dict:
    """Each CUDA kernel's device ms a call, by name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(N_CALL):
            call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3 / N_CALL
    return by_name


def inputs(dev, D=128, Fd=128, H=4):
    """The main path's node-encoder inputs (see the module docstring), at
    d_model D, d_feedforward Fd and H heads."""
    from ..config import ExperimentConfig
    from ..data.synthetic import synthetic_episode_batch
    from ..weights import init_params

    cfg = ExperimentConfig()
    batch = synthetic_episode_batch(cfg.data, n_scene=8, seed=0, n_valid_pl=768, n_valid_agent=40)
    gen = torch.Generator().manual_seed(0)
    enc = NE.FusedNodeEncoder(D, H, 3, Fd)
    init_params(enc, 0)
    with torch.no_grad():
        for name in NE.W_NAMES:
            p = getattr(enc, name)
            if p.ndim == 2:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    valid = torch.from_numpy(batch["map/valid"]).reshape(-1, batch["map/valid"].shape[-1]).clone()
    x = torch.randn(*valid.shape, D, generator=gen) * valid[..., None]
    g = torch.randn(valid.shape[0], D, generator=gen) * valid.any(-1)[:, None]
    return enc.to(dev), x.to(dev), valid.to(dev), g.to(dev)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("node_trace: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    args = sys.argv[1:]
    widths = (128, 128, 4)
    if args[:1] == ["--widths"]:
        widths, args = tuple(int(w) for w in args[1].split("x")), args[2:]
    libs = build(widths[:2])
    enc, x, valid, g = inputs("cuda", *widths)
    weights = [getattr(enc, n) for n in NE.W_NAMES]
    L, H, p, seed = enc.n_layer, enc.n_head, 0.1, 2**50 + 9
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(x.shape, generator=gen).cuda() for _ in range(3))
    calls = (
        ("K2", "node_encoder", lambda: enc.encode_pooled(x, valid)),
        ("K2-bf16", "node_encoder", lambda: enc.encode_pooled(x, valid, bf16=True)),
        ("K4f", "node_encoder_train", lambda: NT._launch_fwd(x, valid, p, seed, L, H, weights)),
        ("K4b", "node_encoder_train", lambda: NT._launch_bwd(x, valid, g, p, seed, L, H, weights)),
        ("K6", "block_attn", lambda: BA.block_attn_core(q, k, v, valid, H)),
        ("K6-bf16", "block_attn", lambda: BA.block_attn_core(q, k, v, valid, H, bf16=True)),
    )
    picked = set(args) or {label for label, _, _ in calls}
    counts = (ctypes.c_ulonglong * 64)()
    with torch.no_grad():
        for label, name, call in calls:
            if label not in picked:
                continue
            lib = libs[name]
            times = device_ms(call)
            cuda_build.check(lib.tb_node_trace_zero(), "trace counters")
            for _ in range(N_CALL):
                call()
            torch.cuda.synchronize()
            cuda_build.check(lib.tb_node_trace_read(counts), "trace counters")
            print(f"{label}: BP={x.shape[0]} N={x.shape[1]} (D, F, H)={widths}, device ms a call by kernel {times} "
                  f"[{card}]", flush=True)
            for kid, (kname, names) in phases(lib).items():
                items = counts[16 * kid + 15]
                if items:
                    cycles = {ph: round(counts[16 * kid + 1 + i] / items) for i, ph in enumerate(names)}
                    print(f"{label}: {kname}, {items // N_CALL} work items a call, cycles a work item by phase "
                          f"{cycles}", flush=True)


if __name__ == "__main__":
    main()
