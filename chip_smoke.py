#!/usr/bin/env python3
"""Smoke run of the PyTorch port (trafficbots_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Written for an H100 (the kernels are built for sm_90a). Phases, each printing
its own lines:

  1. the card: nvidia-smi's name and power limit, torch and CUDA versions,
     the TF32 flags (both off);
  2. the build: every CUDA kernel from trafficbots_tpu_torch/csrc, one nvcc
     per source, all started together;
  3. each kernel against its plain PyTorch version at the shapes the main
     path gives it at full width, with its time, the plain version's time,
     one PyTorch library call's time where one computes the same function,
     and the bound (the least time the card could take: bytes over 3.35 TB/s
     or fp32 operations over 67 TFLOP/s, whichever is larger);
  4. the main path at full width (ExperimentConfig defaults: 64 agents,
     1024 x 20 polylines, hidden 128, 91 steps) on seed-0 synthetic scenes at
     WOMD-like fill (768 polylines, 40 agents valid), N_SCENE scenes, with
     the port's seeded init: `orchestration.eval_rollout` with the launch
     counts set to 0 just before and read just after, agent-steps/s over
     N_ITER synced runs, the same path with the plain versions, and a small
     config on the card against the port on the CPU (which the tests hold
     against JAX), each comparison held over the first HELD_STEPS steps;
  5. the kernels line, the card line, and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero before the last line. Without CUDA the
script exits non-zero at once. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from trafficbots_tpu_torch import ops
from trafficbots_tpu_torch import orchestration as O
from trafficbots_tpu_torch.config import ExperimentConfig
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch
from trafficbots_tpu_torch.ops import cuda_build
from trafficbots_tpu_torch.ops import fused_attention as FA
from trafficbots_tpu_torch.ops import node_encoder as NE
from trafficbots_tpu_torch.weights import init_params

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores

# kernel vs plain version on the same inputs: fp32 throughout (K/V widened
# from bf16 at the load on both sides); the sums run in another order
# (shared-memory loops vs cuBLAS), a few ulp of outputs of order 1-10
K1_TOL = dict(atol=1e-5, rtol=1e-5)
K2_TOL = dict(atol=1e-4, rtol=1e-4)  # 3 layers of 128-long sums, outputs up to ~10
# rollouts: two implementations that sum in another order differ at the ulp
# level, and the closed loop amplifies that step by step (with random
# weights the full-width policy is chaotic). preds are held to ROLLOUT_ATOL
# over the first HELD_STEPS steps (10 teacher-forced warm-up steps, then
# closed-loop ones), with validity equal there. Over the whole horizon the
# gap is a reading, printed beside what moving the map positions by one ulp
# does to the reference run, not a limit. On an H100 at full width the
# kernels-vs-plain gap first exceeds 1e-3 m at step 34, the card-vs-CPU gap
# at step 37, and a one-ulp map nudge moves the reference past it at step 25.
HELD_STEPS = 30
ROLLOUT_ATOL = 1e-3  # metres
READING_THRESHOLDS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)  # metres
N_SCENE = 8  # scenes of the main path's batch
N_ITER = 3  # timed rollouts


def log(*a):
    print(*a, flush=True)


def require(ok: bool, what: str) -> None:
    """A check of this run (not an assert, which python -O would drop)."""
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Device ms per call: CUDA events around n calls after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def bound_ms(n_bytes: float, n_flop: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err_checked(out: torch.Tensor, ref: torch.Tensor, tol: dict, what: str) -> float:
    err = (out - ref).abs()
    limit = tol["atol"] + tol["rtol"] * ref.abs()
    require(bool(torch.isfinite(out).all()) and not bool((err > limit).any()),
            f"{what}: kernel disagrees with its plain version, max abs err {err.max().item()}")
    return err.max().item()


# ------------------------------------------------------------------ K1


def k1_case(gen, B, S, T, kv_bf16, pad_frac, full_mask, dev):
    """Inputs at one call site: a [B, T] padding mask read through a
    stride-0 expand (as the model passes it), or a full [B, S, T] mask with
    one all-masked row."""
    D, H = 128, 4
    q = torch.randn(B, S, D, generator=gen).to(dev)
    k = torch.randn(B, T, D, generator=gen).to(dev)
    v = torch.randn(B, T, D, generator=gen).to(dev)
    if kv_bf16:
        k, v = k.bfloat16(), v.bfloat16()
    if full_mask:
        invalid = torch.rand(B, S, T, generator=gen) < pad_frac
        invalid[0, 1] = True
        invalid = invalid.to(dev)
        mask_bytes = invalid.numel()
    else:
        pad = torch.zeros(B, T, dtype=torch.bool)
        pad[:, int(round(T * (1 - pad_frac))):] = True
        invalid = pad.to(dev)[:, None, :].expand(B, S, T)
        mask_bytes = B * T
    return (q, k, v, invalid, H), mask_bytes


def k1_bound(args, mask_bytes):
    q, k, v, invalid, _ = args
    n_bytes = 2 * q.numel() * 4 + 2 * k.numel() * k.element_size() + mask_bytes
    # 4 D operations (q.k and the weighted sum over dh, every head) for each
    # allowed (query, target) pair this data has
    n_flop = 4 * q.shape[-1] * int((~invalid).sum().item())
    return bound_ms(n_bytes, n_flop)


def sdpa_call(args):
    """torch's scaled_dot_product_attention on the same inputs (K/V widened
    to fp32 before the call), timed as a yardstick only."""
    q, k, v, invalid, H = args
    B, S, D = q.shape
    T = k.shape[1]
    qh = q.view(B, S, H, D // H).transpose(1, 2)
    kh = k.float().view(B, T, H, D // H).transpose(1, 2)
    vh = v.float().view(B, T, H, D // H).transpose(1, 2)
    allowed = (~invalid)[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed)


def check_k1(gen, n_scene, dev):
    """K1 at every main-path call site; returns the kernels-line entry (timed
    at the rollout's as2pl, the site with 270 launches a rollout)."""
    sites = [
        ("rollout as2pl", n_scene, 64, 1024, True, 0.25, False),
        ("map polyline self-attention", n_scene, 1024, 1024, False, 0.25, False),
        ("latent as2pl", n_scene, 19 * 64, 1024, False, 0.25, False),
        # the latent as2tl runs on 40 traffic lights, under the T >= 64 gate, so
        # it stays plain on the main path; kept as the kernel's small-T case
        ("as2tl-like, off the main path", n_scene * 19, 64, 100, False, 0.5, False),
        ("rollout as2pl, full mask, all-masked row", n_scene, 64, 1024, True, 0.3, True),
    ]
    entry, max_err = None, 0.0
    for name, B, S, T, bf16, pad, full in sites:
        args, mask_bytes = k1_case(gen, B, S, T, bf16, pad, full, dev)
        out = FA.fused_attention_core(*args)
        torch.cuda.synchronize()
        ref = FA.attention_core_plain(*args)
        err = max_err_checked(out, ref, K1_TOL, f"K1 {name}")
        if full:
            require(bool((out[0, 1] == 0).all()), "K1: an all-masked row must come out 0")
        max_err = max(max_err, err)
        ms = time_ms(lambda: FA.fused_attention_core(*args))
        plain_ms = time_ms(lambda: FA.attention_core_plain(*args))
        lib_ms = time_ms(sdpa_call(args))
        b_ms, b_by = k1_bound(args, mask_bytes)
        log(f"K1 {name}: B={B} S={S} T={T} kv={'bf16' if bf16 else 'fp32'} max_abs_err={err} "
            f"ms={ms} plain_ms={plain_ms} library_ms={lib_ms} bound_ms={b_ms} ({b_by})")
        if entry is None:
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         shape=f"B={B} S={S} T={T} D=128 H=4 bf16 K/V, {name}")
    entry["max_abs_err"] = max_err
    return entry


# ------------------------------------------------------------------ K2


def check_k2(gen, n_scene, dev, batch):
    """K2 on [n_scene * 1024, 20, 128] with the batch's node validity (768
    valid polylines a scene of 5-20 nodes, the rest all padding), plus an
    all-invalid and a partly valid polyline among the valid ones."""
    enc = NE.FusedNodeEncoder(128, 4, 3, 128)
    init_params(enc, 0)
    with torch.no_grad():  # non-trivial LayerNorm scales and biases
        for name in NE.W_NAMES:
            p = getattr(enc, name)
            if p.ndim == 2:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    enc = enc.to(dev)
    valid = torch.from_numpy(batch["map/valid"]).reshape(-1, batch["map/valid"].shape[-1]).clone()
    valid[3] = False
    valid[4] = False
    valid[4, :2] = True
    x = torch.randn(*valid.shape, 128, generator=gen) * valid[..., None]
    x, valid = x.to(dev), valid.to(dev)
    with torch.no_grad():
        out = enc.encode_pooled(x, valid)
        torch.cuda.synchronize()
        ref = enc.pooled_plain(x, valid)
        err = max_err_checked(out, ref, K2_TOL, "K2")
        ms = time_ms(lambda: enc.encode_pooled(x, valid), n=10)
        plain_ms = time_ms(lambda: enc.pooled_plain(x, valid), n=5)
    n_valid = valid.sum(dim=1).double()
    L, D = enc.n_layer, enc.d_model
    n_flop = L * (12 * D * D * n_valid.sum() + 4 * D * (n_valid * n_valid).sum()).item()
    n_weight_bytes = sum(getattr(enc, n).numel() * 4 for n in NE.W_NAMES)
    n_bytes = x.numel() * 4 + valid.numel() + n_weight_bytes + x.shape[0] * D * 4
    b_ms, b_by = bound_ms(n_bytes, n_flop)
    log(f"K2 node encoder + pool: BP={x.shape[0]} N={x.shape[1]} valid polylines={(n_valid > 0).sum().item()} "
        f"max_abs_err={err} ms={ms} plain_ms={plain_ms} library_ms=None bound_ms={b_ms} ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=err,
                shape=f"BP={x.shape[0]} N={x.shape[1]} D=F=128 H=4 L=3, {n_scene} scenes at 768/1024 fill")


# ------------------------------------------------------------------ main path


def nudged(batch):
    """The batch with every map position moved by one ulp."""
    return dict(batch, **{"map/pos": np.nextafter(batch["map/pos"], np.float32(np.inf))})


def first_step_over(diff: torch.Tensor) -> dict:
    """For each threshold, the first step whose max |diff| exceeds it (None
    if none does); diff [B, A, S, 4]."""
    per_step = diff.amax(dim=(0, 1, 3)).tolist()
    return {str(t): next((s for s, e in enumerate(per_step) if e > t), None) for t in READING_THRESHOLDS}


def compare_rollouts(out, ref, ref_nudged, what) -> dict:
    """Holds preds over the first HELD_STEPS to ROLLOUT_ATOL and validity
    equal there; returns the whole horizon's readings beside the one-ulp
    map nudge's."""
    for o in (out, ref):
        require(bool(torch.isfinite(o.preds).all()), f"{what}: non-finite preds")
    r = ref.preds.float().cpu()
    diff = (out.preds.float().cpu() - r).abs()
    diff_nudge = (ref_nudged.preds.float().cpu() - r).abs()
    held = diff[:, :, :HELD_STEPS].max().item()
    flips = out.valid.cpu() != ref.valid.cpu()
    held_flips = flips[:, :, :HELD_STEPS].sum().item()
    reading = dict(
        preds_err_held=held, held_steps=HELD_STEPS, preds_err_all=diff.max().item(),
        nudge_err_all=diff_nudge.max().item(), valid_flips_all=flips.sum().item(),
        first_step_over=first_step_over(diff), nudge_first_step_over=first_step_over(diff_nudge),
    )
    log(f"{what}: preds max abs diff over the first {HELD_STEPS} steps {held} m (tolerance {ROLLOUT_ATOL} m), "
        f"valid flips there {held_flips}; readings over all {r.shape[2]} steps: preds {reading['preds_err_all']} m, "
        f"first step over each threshold (m) {reading['first_step_over']}, valid flips {reading['valid_flips_all']}; "
        f"a one-ulp map nudge moves the reference {reading['nudge_err_all']} m, first step over each threshold "
        f"{reading['nudge_first_step_over']}")
    require(held <= ROLLOUT_ATOL, f"{what}: preds differ by {held} m > {ROLLOUT_ATOL} m in the first {HELD_STEPS} steps")
    require(held_flips == 0, f"{what}: validity differs in the first {HELD_STEPS} steps")
    return reading


def profile_rollout(cfg, model, batch, dev, wall_s):
    """One eval_rollout under torch.profiler: the device's busy time (the sum
    of its kernels and copies, one stream), the number of device operations,
    the host's syncs with the device, and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        O.eval_rollout(cfg, model, batch, device=dev)
        torch.cuda.synchronize()
    ops_ = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops_:
        log("profile: the profiler saw no device operations; device busy share not measured")
        return None
    busy_ms = sum(e.time_range.elapsed_us() for e in ops_) / 1e3
    by_name = {}
    for e in ops_:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    # host waits on the device: explicit syncs, and copies that block the host
    syncs = sum(1 for e in prof.events() if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    log(f"profile: {len(ops_)} device operations a rollout, device busy {busy_ms} ms of the unprofiled "
        f"{1e3 * wall_s} ms wall ({busy_ms / (1e3 * wall_s)} busy share), {syncs} host syncs")
    for name, (t, n) in top:
        log(f"profile:   {t:10.3f} ms  {n:6d}x  {name[:110]}")
    return dict(device_ops=len(ops_), busy_ms=busy_ms, busy_share=busy_ms / (1e3 * wall_s), host_syncs=syncs,
                top=[dict(name=name[:110], ms=t, count=n) for name, (t, n) in top])


def main_path(cfg, batch, n_iter, dev):
    n_scene = batch["map/valid"].shape[0]
    model = O.make_model(cfg, device=dev, seed=0)
    O.eval_rollout(cfg, model, batch, device=dev)  # first call: library loads, cuBLAS handles
    torch.cuda.synchronize()

    FA.LAUNCHES = 0
    NE.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    out = O.eval_rollout(cfg, model, batch, device=dev)
    torch.cuda.synchronize()
    launches = {"K1": FA.LAUNCHES, "K2": NE.LAUNCHES}
    log(f"main path launches in one eval_rollout: {launches}")
    for k, n in launches.items():
        require(n > 0, f"the main path did not launch {k}")
    n_steps = cfg.time_step_end - cfg.time_step_sim_start + 1
    require(out.preds.shape == (n_scene, cfg.data.n_agent, n_steps, 4), f"preds shape {tuple(out.preds.shape)}")
    require(bool(torch.isfinite(out.preds).all()), "non-finite preds")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    secs = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        O.eval_rollout(cfg, model, batch, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    median = statistics.median(secs)
    asps = n_scene * cfg.data.n_agent * n_steps / median
    log(f"main path: {n_scene} scenes, eval_rollout seconds {secs}, median {median} s, "
        f"{asps} agent-steps/s, peak device memory {peak_gib} GiB [{card_line()}]")

    prof = profile_rollout(cfg, model, batch, dev, median)

    with ops.plain_versions():
        ref = O.eval_rollout(cfg, model, batch, device=dev)
        ref_nudged = O.eval_rollout(cfg, model, nudged(batch), device=dev)
    vs_plain = compare_rollouts(out, ref, ref_nudged, "main path, kernels vs plain versions on the card")
    return launches, dict(n_scene=n_scene, seconds=secs, agent_steps_per_s=asps, vs_plain=vs_plain,
                          peak_gib=peak_gib, profile=prof)


def small_reference(cfg, dev):
    """A small config at the model's full width on the card, against the
    port on the CPU (the path the tests hold against JAX)."""
    data = dataclasses.replace(cfg.data, n_agent=32, n_pl=128, n_tl=16, n_tl_stop=8)
    small = dataclasses.replace(cfg, data=data)
    batch = synthetic_episode_batch(data, n_scene=2, seed=1, n_valid_pl=96, n_valid_agent=20)
    out = O.eval_rollout(small, O.make_model(small, device=dev, seed=1), batch, device=dev)
    cpu_model = O.make_model(small, device="cpu", seed=1)
    ref = O.eval_rollout(small, cpu_model, batch, device="cpu")
    ref_nudged = O.eval_rollout(small, cpu_model, nudged(batch), device="cpu")
    return compare_rollouts(out, ref, ref_nudged, "small config, card (kernels) vs CPU (plain)")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this smoke run needs one NVIDIA GPU")
    dev = O.resolve_device("cuda")  # also turns TF32 off
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    build_s = cuda_build.build_all(["fused_attention", "node_encoder"])
    log(f"build: {build_s} (wall {time.perf_counter() - t0:.1f} s)")

    cfg = ExperimentConfig()
    gen = torch.Generator().manual_seed(0)
    batch = synthetic_episode_batch(cfg.data, n_scene=N_SCENE, seed=0, n_valid_pl=768, n_valid_agent=40)
    k1 = check_k1(gen, N_SCENE, dev)
    k2 = check_k2(gen, N_SCENE, dev, batch)

    launches, path = main_path(cfg, batch, N_ITER, dev)
    path["small_config_vs_cpu"] = small_reference(cfg, dev)

    kernels = [
        dict(name="K1 fused_attention_core (masked multi-head attention core)", route="cuda",
             source="trafficbots_tpu_torch/csrc/fused_attention.cu",
             replaces="trafficbots_tpu/ops/fused_attention.py:123", launches=launches["K1"], **k1),
        dict(name="K2 FusedNodeEncoder.encode_pooled (DenseTNT node stack + max-pool)", route="cuda",
             source="trafficbots_tpu_torch/csrc/node_encoder.cu",
             replaces="trafficbots_tpu/ops/node_encoder.py:245", launches=launches["K2"], **k2),
    ]
    for k in kernels:
        require(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")), str(k))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"main_path": path}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
