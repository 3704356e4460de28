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
     path gives it at full width, with its time as a caller sees it (`ms`:
     back-to-back calls, the host's issue rate included), its device time
     (`device_ms`: the bare launches captured in a CUDA graph and replayed),
     the plain version's time, one PyTorch library call's time where one
     computes the same function, and the bound (the least time the card
     could take: bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s,
     whichever is larger); K5's fused entries (dropout_add, relu_dropout)
     against their plain compositions; K1 at every site (the validation
     joint futures' batch 48 included) and K3 at every training site
     beside SDPA's forward and backward on the device
     (`library_device_ms`), K1's output and K3f's output and row
     statistics bitwise equal over two calls; K4 on two draws of inputs
     (the usual one, and the B=48 draw: replayed_generator), each held
     against an fp64 plain run, the max-pool's near-ties counted, and K4f
     at p = 0 bitwise equal to K2; K6 with three polylines past the main
     path's (all padding, partly valid, fully valid) and one with a single
     valid node; K2's, K4f's and K6's outputs' SHA-1 digests (two commits'
     runs in one call that print the same digest gave the same bits);
  4. the eval main path at full width (ExperimentConfig defaults: 64
     agents, 1024 x 20 polylines, hidden 128, 91 steps) on seed-0 synthetic
     scenes at WOMD-like fill (768 polylines, 40 agents valid), N_SCENE
     scenes, with the port's seeded init: `orchestration.eval_rollout` with
     the launch counts set to 0 just before and read just after,
     agent-steps/s over N_ITER synced runs, the same path with the plain
     versions, and a small config on the card against the port on the CPU
     (which the tests hold against JAX), each comparison held over the first
     HELD_STEPS steps;
  5. the training main path on the same scenes and config (dropout 0.1
     live, the 90-step BPTT with per-step rematerialisation):
     `training.train.make_train_step`, one warm-up step, then N_TRAIN_ITER
     timed steps, the training kernels' launch counts set to 0 just before
     each and read just after; the loss and grad norm finite, the
     parameters moved; train-step ms, agent-steps/s, peak memory, the busy
     share of one profiled step; then one training step's loss and
     gradients with the kernels against the plain versions (same seeds),
     held over the first HELD_STEPS steps, the whole horizon as a reading
     beside a one-ulp map nudge;
  6. the validation main path on the same scenes and config with
     map_encoder.node_encoder_impl = "hybrid" (the node stack's matmuls
     around the attention core K6): `evaluation_loop.Validator`, one
     warm-up step, then N_ITER timed `step` calls, each with the launch
     counts set to 0 just before and read just after, then `epoch_end`;
     validation agent-steps/s (the reactive replay and the K joint futures),
     peak memory, the busy share of one profiled step, finite val/loss,
     mAP and position error; then one validation step with the kernels
     against the plain versions (same generator seed), the reactive replay's
     and the deterministic joint future's preds held over the first
     HELD_STEPS steps, the rest (and the sampled futures) readings beside a
     one-ulp map nudge;
  7. the kernels line, the card line, and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero before the last line. Without CUDA the
script exits non-zero at once. It imports nothing of JAX.

    python3 chip_smoke.py --attention
    python3 chip_smoke.py --node

build K1 and K3 (--attention), or K2, K4 and K6 (--node), alone and run
only their checks and timings (phase 3's lines for them and one JSON line,
no last line; --node replays the shared generator's earlier draws on the
CPU, so K2, K4 and K6 see the inputs a full run gives them): a quick check
after an edit of their sources, or, copied into an unpacked older commit
and run there, that commit's numbers beside this one's in the same call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from trafficbots_tpu_torch import evaluation_loop as EL
from trafficbots_tpu_torch import ops
from trafficbots_tpu_torch import orchestration as O
from trafficbots_tpu_torch.config import ExperimentConfig
from trafficbots_tpu_torch.data.preprocessing import to_torch
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch
from trafficbots_tpu_torch.ops import attention_train as AT
from trafficbots_tpu_torch.ops import block_attn as BA
from trafficbots_tpu_torch.ops import cuda_build
from trafficbots_tpu_torch.ops import dropout as DO
from trafficbots_tpu_torch.ops import fused_attention as FA
from trafficbots_tpu_torch.ops import node_encoder as NE
from trafficbots_tpu_torch.ops import node_encoder_train as NT
from trafficbots_tpu_torch.training import train as TT
from trafficbots_tpu_torch.weights import init_params

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores

# kernel vs plain version on the same inputs: fp32 throughout (K/V widened
# from bf16 at the load on both sides); the sums run in another order
# (shared-memory loops vs cuBLAS), a few ulp of outputs of order 1-10
K1_TOL = dict(atol=1e-5, rtol=1e-5)
K2_TOL = dict(atol=1e-4, rtol=1e-4)  # 3 layers of 128-long sums, outputs up to ~10
K6_TOL = dict(atol=1e-5, rtol=1e-5)  # one 32-long and one 20-long sum a head
HYBRID_TOL = dict(atol=1e-4, rtol=1e-4)  # hybrid (K6) vs fused (K2) pooled features: as K2
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
N_TRAIN_ITER = 3  # timed training steps
KERNEL_SOURCES = ("fused_attention", "node_encoder", "dropout", "attention_train", "node_encoder_train", "block_attn")
P_DROP = 0.1  # ExperimentConfig's dropout rates, live in every training check
# training kernels vs plain versions on the same inputs and seeds (K5's
# masks are bit-equal): forwards as K1/K2; gradients by relative norm error,
# each gradient's error against its own norm or 1e-3 of the largest
# gradient's (a key-projection bias has an exact gradient of 0: rounding
# noise on both sides). Sums in another order over up to 1216 query rows or
# 20k nodes: a few ulp of the norm.
K3_TOL = dict(atol=1e-5, rtol=1e-5)
K4_TOL = dict(atol=1e-4, rtol=1e-4)
K3_GRAD_RTOL = 1e-5
# K4's gradients: 1e-3. The node stack's fp32 gradients are themselves
# ~1e-4 from fp64 (max-pool near-ties, where a ulp moves a column's whole
# cotangent to another node, and the LayerNorm backward): check_k4 prints
# the plain version's own fp32-vs-fp64 gap beside the kernel's.
K4_GRAD_RTOL = 1e-3
# one training step, kernels vs plain, over time_step_end = HELD_STEPS: the
# loss to rel 1e-5 and each gradient to a relative norm error of 1e-2. The
# forward is the eval path's (held to 1e-3 m over these steps) plus dropout
# on bit-equal masks, so the loss stays ulp-close. The gradients do not:
# max aggregations (the latent encoders' max over steps, the node pool)
# send each column's cotangent to one step or node, and a ulp in the
# forward flips a near-tie and moves a whole cotangent. On the H100 the
# largest leaf gap was 2.1e-3, at the posterior latent's interaction layer
# (below its max over steps), while the loss matched to the bit. A wrong
# kernel gradient moves the leaves above it by O(1); 1e-2 catches that.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-2


T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase(name: str) -> None:
    log(f"phase: {name} at {time.perf_counter() - T_START:.1f} s")


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
    """Ms per call as the caller sees it: CUDA events around n back-to-back
    calls after a warm-up (for a small kernel, the host's issue rate)."""
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


def interleaved_ms(fns: dict, n: int = 50, rounds: int = 7) -> dict:
    """time_ms of each callable, taken in turns over several rounds, the
    median of each: host-bound calls compared on the same host moment."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, n=n))
    return {name: statistics.median(t) for name, t in times.items()}


def graph_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Device ms per call: n calls captured in one CUDA graph, its replays
    timed with CUDA events (no host cost between the launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / (n * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def profiled_ms(fn, n: int = 5):
    """Device ms per call from torch.profiler: the device operations of n
    calls summed (for a library call whose autograd backward cannot be
    captured raw); None if the profiler sees no device operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops_ = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ops_) / 1e3 / n if ops_ else None


def bound_ms(n_bytes: float, n_flop: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err_checked(out: torch.Tensor, ref: torch.Tensor, tol: dict, what: str) -> float:
    err = (out - ref).abs()
    limit = tol["atol"] + tol["rtol"] * ref.abs()
    require(bool(torch.isfinite(out).all()) and not bool((err > limit).any()),
            f"{what}: kernel disagrees with its plain version, max abs err {err.max().item()}")
    return err.max().item()


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the tensor's bytes' SHA-1: two runs (two
    commits in one call) that print the same digest gave the same bits."""
    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


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


K1_B48 = "joint futures rollout as2pl"


def k1_sites(n_scene):
    """K1's main-path call sites: (name, B, S, T, bf16 K/V, padding share, full mask)."""
    return [
        ("rollout as2pl", n_scene, 64, 1024, True, 0.25, False),
        # validation's K = 6 joint futures folded into the batch: 270 launches a step
        (K1_B48, n_scene * 6, 64, 1024, True, 0.25, False),
        ("map polyline self-attention", n_scene, 1024, 1024, False, 0.25, False),
        ("latent as2pl", n_scene, 19 * 64, 1024, False, 0.25, False),
        # the latent as2tl runs on 40 traffic lights, under the T >= 64 gate, so
        # it stays plain on the main path; kept as the kernel's small-T case
        ("as2tl-like, off the main path", n_scene * 19, 64, 100, False, 0.5, False),
        ("rollout as2pl, full mask, all-masked row", n_scene, 64, 1024, True, 0.3, True),
    ]


def check_k1(gen, n_scene, dev):
    """K1 at every main-path call site: against its plain version, two calls
    bitwise equal, its times beside SDPA's (host and device). Returns the
    kernels-line entry (timed at the rollout's as2pl, the site with 270
    launches a rollout) with every site's numbers under `sites`."""
    entry, max_err, per_site = None, 0.0, []
    for name, B, S, T, bf16, pad, full in k1_sites(n_scene):
        # the joint futures' site draws from a generator of its own, so that
        # the later checks' inputs stay what the shared one gave them before
        site_gen = torch.Generator().manual_seed(48) if name == K1_B48 else gen
        args, mask_bytes = k1_case(site_gen, B, S, T, bf16, pad, full, dev)
        out = FA.fused_attention_core(*args)
        again = FA.fused_attention_core(*args)
        torch.cuda.synchronize()
        require(torch.equal(out, again), f"K1 {name}: not bitwise reproducible")
        ref = FA.attention_core_plain(*args)
        err = max_err_checked(out, ref, K1_TOL, f"K1 {name}")
        if full:
            require(bool((out[0, 1] == 0).all()), "K1: an all-masked row must come out 0")
        max_err = max(max_err, err)
        ms = time_ms(lambda: FA.fused_attention_core(*args))
        dev_ms = graph_ms(lambda: FA.fused_attention_core(*args))
        plain_ms = time_ms(lambda: FA.attention_core_plain(*args))
        lib = sdpa_call(args)
        lib_ms, lib_dev = time_ms(lib), graph_ms(lib)
        b_ms, b_by = k1_bound(args, mask_bytes)
        log(f"K1 {name}: B={B} S={S} T={T} kv={'bf16' if bf16 else 'fp32'} max_abs_err={err} ms={ms} "
            f"device_ms={dev_ms} plain_ms={plain_ms} library_ms={lib_ms} library_device_ms={lib_dev} "
            f"bound_ms={b_ms} ({b_by}); two calls bitwise equal [{card_line()}]")
        site = dict(site=name, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        per_site.append(site)
        if entry is None:
            entry = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_device_ms=lib_dev, shape=f"B={B} S={S} T={T} D=128 H=4 bf16 K/V, {name}")
    entry["max_abs_err"] = max_err
    entry["sites"] = per_site
    return entry


# ------------------------------------------------------------------ K2


def check_k2(gen, n_scene, dev, batch):
    """K2 on [n_scene * 1024, 20, 128] with the batch's node validity (768
    valid polylines a scene of 5-20 nodes, the rest all padding), plus an
    all-invalid and a partly valid polyline among the valid ones."""
    enc, x, valid = node_encoder_case(gen, dev, batch)
    with torch.no_grad():
        out = enc.encode_pooled(x, valid)
        torch.cuda.synchronize()
        ref = enc.pooled_plain(x, valid)
        err = max_err_checked(out, ref, K2_TOL, "K2")
        ms = time_ms(lambda: enc.encode_pooled(x, valid), n=10)
        dev_ms = graph_ms(lambda: enc.encode_pooled(x, valid), n=5)
        plain_ms = time_ms(lambda: enc.pooled_plain(x, valid), n=5)
    n_valid = valid.sum(dim=1).double()
    L, D = enc.n_layer, enc.d_model
    n_flop = L * (12 * D * D * n_valid.sum() + 4 * D * (n_valid * n_valid).sum()).item()
    n_weight_bytes = sum(getattr(enc, n).numel() * 4 for n in NE.W_NAMES)
    n_bytes = x.numel() * 4 + valid.numel() + n_weight_bytes + x.shape[0] * D * 4
    b_ms, b_by = bound_ms(n_bytes, n_flop)
    log(f"K2 node encoder + pool: BP={x.shape[0]} N={x.shape[1]} valid polylines={(n_valid > 0).sum().item()} "
        f"max_abs_err={err} ms={ms} device_ms={dev_ms} plain_ms={plain_ms} library_ms=None bound_ms={b_ms} ({b_by}) "
        f"out sha1={digest(out)}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err, out_sha1=digest(out), shape=f"BP={x.shape[0]} N={x.shape[1]} D=F=128 H=4 L=3, {n_scene} scenes at 768/1024 fill")


# ------------------------------------------------------------------ K6 (hybrid node encoder)


def node_encoder_case(gen, dev, batch):
    """A full-width node encoder with non-trivial LayerNorm scales and
    biases, and [n_scene * 1024, 20, 128] inputs with the batch's node
    validity (768 valid polylines a scene of 5-20 nodes, the rest all
    padding) plus an all-invalid and a partly valid polyline among the
    valid ones."""
    enc = NE.FusedNodeEncoder(128, 4, 3, 128)
    init_params(enc, 0)
    with torch.no_grad():
        for name in NE.W_NAMES:
            p = getattr(enc, name)
            if p.ndim == 2:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    valid = torch.from_numpy(batch["map/valid"]).reshape(-1, batch["map/valid"].shape[-1]).clone()
    valid[3] = False
    valid[4] = False
    valid[4, :2] = True
    x = torch.randn(*valid.shape, 128, generator=gen) * valid[..., None]
    return enc.to(dev), x.to(dev), valid.to(dev)


def k6_sdpa_call(q, k, v, valid, H):
    """scaled_dot_product_attention per polyline on [BP, H, N, dh] with the
    same mask (lifted for a polyline without a valid node); a yardstick only."""
    BP, N, D = q.shape
    qh, kh, vh = (t.view(BP, N, H, D // H).transpose(1, 2) for t in (q, k, v))
    allowed = (valid | ~valid.any(dim=-1, keepdim=True))[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed)


def check_k6(gen, n_scene, dev, batch):
    """K6 on [n_scene * 1024, 20, 128] q, k, v with the batch's node validity
    (one more polyline with a single valid node), and three more polylines
    (all padding, partly valid, fully valid; a count of polylines that the
    persistent grid's passes do not divide): kernel vs plain on the rows of
    polylines with a valid node, the other rows finite; timed at the main
    path's shape; then the whole hybrid node encoder (K6) against the fused
    one (K2) on the same inputs."""
    H = 4
    enc, x, valid = node_encoder_case(gen, dev, batch)
    BP, N, D = x.shape
    q, k, v = (torch.randn(BP, N, D, generator=gen).to(dev) for _ in range(3))
    tail = torch.tensor([[False] * N, [True] * (N // 2) + [False] * (N - N // 2), [True] * N])
    valid6 = torch.cat([valid, tail.to(dev)])
    valid6[5] = False
    valid6[5, N // 3] = True
    q6, k6, v6 = (torch.cat([t, torch.randn(3, N, D, generator=gen).to(dev)]) for t in (q, k, v))
    live = valid6.any(dim=-1)
    require(not bool(live.all()), "K6 check: the inputs need a polyline without a valid node")
    out = BA.block_attn_core(q6, k6, v6, valid6, H)
    torch.cuda.synchronize()
    ref = BA.block_attn_core_plain(q6, k6, v6, valid6, H)
    require(bool(torch.isfinite(out).all()), "K6: non-finite output (rows of dead polylines included)")
    err = max_err_checked(out[live], ref[live], K6_TOL, "K6")
    live = valid.any(dim=-1)
    ms = time_ms(lambda: BA.block_attn_core(q, k, v, valid, H))
    dev_ms = graph_ms(lambda: BA.block_attn_core(q, k, v, valid, H))
    plain_ms = time_ms(lambda: BA.block_attn_core_plain(q, k, v, valid, H), n=5)
    lib_ms = time_ms(k6_sdpa_call(q, k, v, valid, H))
    # q, k, v read and the output written once, the node flags read once;
    # 4 D operations (q.k and the weighted sum over d_h, every head) for each
    # allowed (query, target) pair of this data
    n_valid = valid.sum(dim=-1)
    pairs = int((N * torch.where(n_valid > 0, n_valid, torch.full_like(n_valid, N))).sum().item())
    b_ms, b_by = bound_ms(4 * q.numel() * 4 + valid.numel(), 4 * D * pairs)
    log(f"K6 block attention core: BP={BP} (+3 held) N={N} D={D} H={H} live polylines={int(live.sum())} "
        f"max_abs_err={err} ms={ms} device_ms={dev_ms} plain_ms={plain_ms} library_ms={lib_ms} bound_ms={b_ms} "
        f"({b_by}) out sha1={digest(out)} [{card_line()}]")
    with torch.no_grad():
        hyb = enc.encode_pooled_hybrid(x, valid)
        fused = enc.encode_pooled(x, valid)
        torch.cuda.synchronize()
        hyb_err = max_err_checked(hyb[live], fused[live], HYBRID_TOL, "hybrid (K6) vs fused (K2) node encoder")
        require(bool((hyb[~live] == NE.NEG).all()) and bool((fused[~live] == NE.NEG).all()),
                "a polyline without a valid node must pool to -1e30")
        hyb_ms = time_ms(lambda: enc.encode_pooled_hybrid(x, valid), n=10)
        fused_ms = time_ms(lambda: enc.encode_pooled(x, valid), n=10)
    log(f"hybrid node encoder (matmuls + K6) vs fused (K2): pooled max_abs_err={hyb_err}, "
        f"hybrid ms={hyb_ms}, fused ms={fused_ms}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                max_abs_err=err, out_sha1=digest(out),
                shape=f"BP={BP} N={N} D=128 H=4, {n_scene} scenes at 768/1024 fill"), \
        dict(hybrid_vs_fused_max_abs_err=hyb_err, hybrid_ms=hyb_ms, fused_ms=fused_ms)


# ------------------------------------------------------------------ K5, K3, K4 (training)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def grads_checked(got, ref, names, rtol, what) -> float:
    """Each gradient's norm error within rtol of its own norm or of 1e-3 of
    the largest; returns the largest relative error against its own norm."""
    scale = max(r.norm().item() for r in ref)
    errs = {n: ((g - r).norm().item(), r.norm().item()) for n, g, r in zip(names, got, ref)}
    bad = {n: e for n, e in errs.items() if not e[0] <= rtol * max(e[1], 1e-3 * scale)}
    require(all(torch.isfinite(g).all() for g in got) and not bad,
            f"{what}: gradients disagree with the plain version's: {bad}")
    return max(e / max(n, 1e-3 * scale) for e, n in errs.values())


def k5_entries(seed, site):
    """Each K5 entry beside its plain composition: (name, inputs it takes
    of (x, res), kernel entry, plain composition, bare launch)."""
    return (
        ("dropout", 1, lambda x: DO.dropout(x, P_DROP, seed, site),
         lambda x: DO.dropout_plain(x, P_DROP, seed, site), lambda x: DO._launch(x, P_DROP, seed, site)),
        ("dropout_add", 2, lambda x, r: DO.dropout_add(r, x, P_DROP, seed, site),
         lambda x, r: r + DO.dropout_plain(x, P_DROP, seed, site), lambda x, r: DO._launch_add(r, x, P_DROP, seed, site)),
        ("relu_dropout", 1, lambda x: DO.relu_dropout(x, P_DROP, seed, site),
         lambda x: torch.relu(DO.dropout_plain(x, P_DROP, seed, site)),
         lambda x: DO._launch_relu(x, P_DROP, seed, site)),
    )


def check_k5(dev):
    """K5 at the main path's shapes: the mask equal to the plain bits, and
    every entry (dropout, the fused dropout_add and relu_dropout) equal to
    its plain composition bit for bit, forward and backward. Timed at the
    rollout step's [8, 64, 128] (the most launches) and at the map input
    MLP's hidden [8 x 1024 x 20, 32] (the largest): each entry's per-call
    time as a caller sees it without grad (the bare launch) and with
    requires_grad (the autograd Function), beside F.dropout's, and its bare
    launch's device time from a CUDA graph. The host times are medians of
    interleaved rounds (the entry, then F.dropout, in turns)."""
    entry = None
    for name, shape in (("rollout step hidden", (N_SCENE, 64, 128)), ("map input MLP hidden", (N_SCENE * 1024 * 20, 32))):
        seed, site = 2**61 + 17, 3
        out = DO.dropout(torch.ones(shape, device=dev), P_DROP, seed, site)
        torch.cuda.synchronize()
        require(torch.equal(out, DO.dropout_mask_plain(shape, seed, site, P_DROP, device=dev)),
                f"K5 {name}: the kernel's mask differs from the plain bits")
        x, res, g = (torch.randn(shape, device=dev) for _ in range(3))
        times = {}
        for ename, n_in, fn, plain, bare in k5_entries(seed, site):
            inputs = (x, res)[:n_in]
            leaves = [t.clone().requires_grad_() for t in inputs]
            got = fn(*leaves)
            got_g = torch.autograd.grad(got, leaves, g)
            ref_leaves = [t.clone().requires_grad_() for t in inputs]
            ref = plain(*ref_leaves)
            ref_g = torch.autograd.grad(ref, ref_leaves, g)
            torch.cuda.synchronize()
            require(torch.equal(got, ref) and all(torch.equal(a, b) for a, b in zip(got_g, ref_g)),
                    f"K5 {ename} {name}: differs from its plain composition")
            with torch.no_grad():
                require(torch.equal(fn(*inputs), ref), f"K5 {ename} {name}: the bare launch differs")
            host = interleaved_ms({"ms": lambda: fn(*inputs), "ms_grad": lambda: fn(*leaves),
                                   "library_ms": lambda: torch.nn.functional.dropout(x, P_DROP),
                                   "library_ms_grad": lambda: torch.nn.functional.dropout(leaves[0], P_DROP)})
            times[ename] = dict(host, device_ms=graph_ms(lambda: bare(*inputs)),
                                plain_ms=time_ms(lambda: plain(*inputs), n=5))
        lib_ms, lib_ms_grad = times["dropout"]["library_ms"], times["dropout"]["library_ms_grad"]
        b_ms, b_by = bound_ms(8 * x.numel(), 0)  # read x, write out; the Philox integer work is not counted
        d = times["dropout"]
        log(f"K5 {name} {tuple(shape)}: every entry bit-equal to its plain composition, forward and backward; "
            f"dropout ms={d['ms']} (requires_grad {d['ms_grad']}) device_ms={d['device_ms']} plain_ms={d['plain_ms']} "
            f"library_ms={lib_ms} (F.dropout; requires_grad {lib_ms_grad}) bound_ms={b_ms} ({b_by}); "
            f"fused: dropout_add {times['dropout_add']}, relu_dropout {times['relu_dropout']} [{card_line()}]")
        if entry is None:
            entry = dict(ms=d["ms"], ms_grad=d["ms_grad"], device_ms=d["device_ms"], plain_ms=d["plain_ms"],
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library_ms_grad=lib_ms_grad,
                         max_abs_err=0.0, fused={k: v for k, v in times.items() if k != "dropout"},
                         shape=f"{tuple(shape)} fp32 p=0.1, {name}")
    return entry


def k3_inputs(gen, B, S, T, pad_frac, full_mask, dev):
    D = 128
    q, k, v, g = (torch.randn(*s, generator=gen).to(dev) for s in ((B, S, D), (B, T, D), (B, T, D), (B, S, D)))
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
    return q, k, v, invalid, g, mask_bytes


def sdpa_train(q, k, v, invalid, H):
    """scaled_dot_product_attention with the same mask and dropout rate,
    forward and a graph for the backward; a yardstick only."""
    B, S, D = q.shape
    T = k.shape[1]
    qh, kh, vh = (t.view(B, -1, H, D // H).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    allowed = (~invalid)[:, None]
    fwd = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed, dropout_p=P_DROP)  # noqa: E731
    return fwd, (qh, kh, vh)


def k3_sites(n_scene):
    """K3's main-path training sites: (name, B, S, T, padding share, full mask)."""
    return [
        ("rollout as2pl", n_scene, 64, 1024, 0.25, False),
        ("map polyline self-attention", n_scene, 1024, 1024, 0.25, False),
        ("posterior latent as2pl", n_scene, 19 * 64, 1024, 0.25, False),
        ("rollout as2pl, full mask, all-masked row", n_scene, 64, 1024, 0.3, True),
    ]


def check_k3(gen, n_scene, dev):
    """K3 forward and backward at every main-path training site, dropout
    live on the same seeds as the plain version; the backward twice,
    bitwise equal. Each site's times: through autograd as the step calls it
    (`ms`), the bare launches' device time from a CUDA graph (`device_ms`),
    and SDPA's, its backward's device time from the profiler. The entries
    are the rollout's as2pl (277 launches a step); `sites` holds them all."""
    H = 4
    fwd_entry = bwd_entry = None
    err_f = err_b = 0.0
    per_site = []
    for name, B, S, T, pad, full in k3_sites(n_scene):
        q, k, v, invalid, g, mask_bytes = k3_inputs(gen, B, S, T, pad, full, dev)
        seed = 2**40 + S

        def graph(fn):
            qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
            return fn(qq, kk, vv, invalid, H, P_DROP, seed, 0), (qq, kk, vv)

        out, leaves = graph(AT.attention_train)
        grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
        again = torch.autograd.grad(out, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(grads, again)), f"K3b {name}: not bitwise reproducible")
        ref, ref_leaves = graph(AT.attention_train_plain)
        ref_grads = torch.autograd.grad(ref, ref_leaves, g, retain_graph=True)
        ef = max_err_checked(out.detach(), ref.detach(), K3_TOL, f"K3f {name}")
        eb = grads_checked(grads, ref_grads, ("dq", "dk", "dv"), K3_GRAD_RTOL, f"K3b {name}")
        if full:
            require(bool((out[0, 1] == 0).all()) and bool((grads[0][0, 1] == 0).all()), "K3: an all-masked row must be 0")
        err_f, err_b = max(err_f, ef), max(err_b, eb)
        with torch.no_grad():
            ms_f = time_ms(lambda: AT.attention_train(q, k, v, invalid, H, P_DROP, seed, 0))
            plain_f = time_ms(lambda: AT.attention_train_plain(q, k, v, invalid, H, P_DROP, seed, 0), n=5)
        ms_b = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
        plain_b = time_ms(lambda: torch.autograd.grad(ref, ref_leaves, g, retain_graph=True), n=5)
        o, rmax, rsum = AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0)
        o2, rmax2, rsum2 = AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0)
        torch.cuda.synchronize()
        require(torch.equal(o, o2) and torch.equal(rmax, rmax2) and torch.equal(rsum, rsum2),
                f"K3f {name}: out, rmax or rsum not bitwise reproducible")
        dev_f = graph_ms(lambda: AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0))
        dev_b = graph_ms(lambda: AT._launch_bwd(q, k, v, invalid, o, rmax, rsum, g, H, P_DROP, seed, 0))
        lib_fwd, lib_leaves = sdpa_train(q, k, v, invalid, H)
        with torch.no_grad():
            lib_f = time_ms(lib_fwd)
            lib_f_dev = graph_ms(lib_fwd)
        lib_out = lib_fwd()
        gh = g.view(B, S, H, -1).transpose(1, 2)
        lib_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, gh, retain_graph=True)  # noqa: E731
        lib_b = time_ms(lib_bwd)
        lib_b_dev = profiled_ms(lib_bwd)
        allowed = int((~invalid).sum().item())
        io = (2 * q.numel() + 2 * k.numel()) * 4 + mask_bytes + 2 * B * H * S * 4  # q, k, v, out, mask, row stats
        bf, bf_by = bound_ms(io, 4 * 128 * allowed)
        # backward: also reads g and writes dq, dk, dv; dv, dA, dq, dk are 2 D operations each per allowed pair
        bb, bb_by = bound_ms(io + (2 * q.numel() + 2 * k.numel()) * 4, 8 * 128 * allowed)
        log(f"K3 {name}: B={B} S={S} T={T} fwd max_abs_err={ef} ms={ms_f} device_ms={dev_f} plain_ms={plain_f} "
            f"library_ms={lib_f} library_device_ms={lib_f_dev} bound_ms={bf} ({bf_by}); bwd grad rel err={eb} "
            f"ms={ms_b} device_ms={dev_b} plain_ms={plain_b} library_ms={lib_b} library_device_ms={lib_b_dev} "
            f"bound_ms={bb} ({bb_by}); fwd (out, rmax, rsum) and bwd bitwise reproducible [{card_line()}]")
        shape = f"B={B} S={S} T={T} D=128 H=4 fp32 K/V p=0.1, {name}"
        fwd = dict(ms=ms_f, device_ms=dev_f, plain_ms=plain_f, bound_ms=bf, bound_by=bf_by, library_ms=lib_f,
                   library_device_ms=lib_f_dev, shape=shape)
        bwd = dict(ms=ms_b, device_ms=dev_b, plain_ms=plain_b, bound_ms=bb, bound_by=bb_by, library_ms=lib_b,
                   library_device_ms=lib_b_dev, shape=shape)
        per_site.append(dict(site=name, fwd=fwd, bwd=bwd))
        if fwd_entry is None:
            fwd_entry, bwd_entry = dict(fwd), dict(bwd)
    fwd_entry["max_abs_err"] = err_f
    bwd_entry["max_abs_err"] = err_b  # the largest relative norm error of dq, dk, dv
    fwd_entry["sites"] = [dict(site=x["site"], **x["fwd"]) for x in per_site]
    bwd_entry["sites"] = per_site
    return fwd_entry, bwd_entry


def replayed_generator(upto, n_scene, batch, b48=False):
    """A seed-0 generator advanced by the draws that the checks before
    `upto` ("K2", "K4" or "K6") make from the shared generator in a full run
    (K1's sites but the B=48 one; then K2's and K3's inputs; then K4's usual
    draw), made on the CPU and thrown away. With b48 the B=48 K1 site draws
    from it too (the "B=48 draw", the K4 inputs on which K4b's 1e-3 hold
    against the plain version once failed: a reading, not a hold, on that
    draw)."""
    gen = torch.Generator().manual_seed(0)
    for name, B, S, T, bf16, pad, full in k1_sites(n_scene):
        if name != K1_B48 or b48:
            k1_case(gen, B, S, T, bf16, pad, full, "cpu")
    if upto in ("K4", "K6"):
        node_encoder_case(gen, "cpu", batch)
        for name, B, S, T, pad, full in k3_sites(n_scene):
            k3_inputs(gen, B, S, T, pad, full, "cpu")
    if upto == "K6":
        x = node_encoder_case(gen, "cpu", batch)[1]
        torch.randn(x.shape[0], 128, generator=gen)
    return gen


def near_ties(nodes, valid, nodes64, ulps=4, rel=1e-5):
    """Max-pool near-ties of the node stack's fp32 output [BP, N, D]: the
    (polyline, column) pairs whose two largest valid-node values are equal
    (`exact`), within `ulps` ulp of the largest (`near`, exact included) or
    within `rel` of it (`near_rel`); and `flips`, the pairs whose largest
    valid node differs from the fp64 output's (a flip moves the column's
    whole cotangent to another node)."""
    masked = torch.where(valid[..., None], nodes, torch.full_like(nodes, -math.inf))
    top = masked.topk(2, dim=1).values
    gap = top[:, 0] - top[:, 1]
    ulp = torch.nextafter(top[:, 0].abs(), torch.full_like(top[:, 0], math.inf)) - top[:, 0].abs()
    two = valid.sum(dim=1)[:, None] >= 2
    arg64 = torch.where(valid[..., None], nodes64, torch.full_like(nodes64, -math.inf)).argmax(dim=1)
    return dict(exact=int((two & (gap == 0)).sum().item()), near=int((two & (gap <= ulps * ulp)).sum().item()),
                near_rel=int((two & (gap <= rel * top[:, 0].abs())).sum().item()),
                flips=int((two & (masked.argmax(dim=1) != arg64)).sum().item()), ulps=ulps, rel=rel)


def k4_case(gen, dev, batch, draw, hold_vs_plain):
    """K4 forward and backward on one draw of inputs, dropout live: the
    backward twice, bitwise equal; the forward against the plain version;
    the gradients against the plain version's (held to K4_GRAD_RTOL with
    hold_vs_plain, else a reading) and both against an fp64 plain run (the
    kernel held to twice the plain version's gap); the max-pool near-ties of
    the plain forward's node outputs counted."""
    enc, x, valid = node_encoder_case(gen, dev, batch)
    pl = valid.any(-1)
    g = torch.where(pl[:, None], torch.randn(x.shape[0], 128, generator=gen).to(dev), torch.zeros((), device=dev))
    seed = 2**50 + 9
    weights = [getattr(enc, n) for n in NE.W_NAMES]
    names = ("dx",) + NE.W_NAMES

    def graph(fn):
        xx = x.clone().requires_grad_()
        return fn(enc, xx, valid, P_DROP, seed), [xx] + weights

    out, leaves = graph(NT.node_encoder_train)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
    again = torch.autograd.grad(out, leaves, g, retain_graph=True)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(grads, again)), f"K4b ({draw}): not bitwise reproducible")
    ref, ref_leaves = graph(NT.node_encoder_train_plain)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g, retain_graph=True)
    ef = max_err_checked(out.detach()[pl], ref.detach()[pl], K4_TOL, f"K4f ({draw})")
    require(bool((out[~pl] == NE.NEG).all()), "K4f: a polyline without a valid node must pool to -1e30")
    if hold_vs_plain:
        eb = grads_checked(grads, ref_grads, names, K4_GRAD_RTOL, f"K4b ({draw})")
    else:
        eb = grads_checked(grads, ref_grads, names, math.inf, f"K4b ({draw})")
    per_leaf = {n: rel_err(a, b) for n, a, b in zip(names, grads, ref_grads)}
    # both sides' rounding: fp32 against fp64 on the same inputs
    enc64 = NE.FusedNodeEncoder(128, 4, 3, 128).to(dev, torch.float64)
    enc64.load_state_dict({k: v.double() for k, v in enc.state_dict().items()})
    with torch.no_grad():
        ties = near_ties(enc(x, valid, P_DROP, seed), valid, enc64(x.double(), valid, P_DROP, seed))
    x64 = x.double().requires_grad_()
    out64 = NT.node_encoder_train_plain(enc64, x64, valid, P_DROP, seed)
    g64 = torch.autograd.grad(out64, [x64] + [getattr(enc64, n) for n in NE.W_NAMES], g.double())
    fp64_gap = grads_checked([r.double() for r in ref_grads], g64, names, 1.0, "K4 plain fp32 vs fp64")
    kernel_fp64_gap = grads_checked([r.double() for r in grads], g64, names, 1.0, "K4 kernel vs fp64")
    plain64 = {n: rel_err(r.double(), b) for n, r, b in zip(names, ref_grads, g64)}
    kernel64 = {n: rel_err(r.double(), b) for n, r, b in zip(names, grads, g64)}
    del enc64, x64, out64, g64
    log(f"K4 ({draw}): fwd max_abs_err={ef}; bwd grad rel err vs plain {eb} "
        f"({'held to ' + str(K4_GRAD_RTOL) if hold_vs_plain else 'a reading'}); against fp64: plain {fp64_gap}, "
        f"kernel {kernel_fp64_gap} (held to twice the plain's); max-pool near-ties of the plain forward "
        f"(exact / within {ties['ulps']} ulp / within {ties['rel']} relative): {ties['exact']} / {ties['near']} / "
        f"{ties['near_rel']}, argmax flips against fp64 {ties['flips']}, of {int(pl.sum()) * 128} columns; "
        f"per leaf, kernel vs plain {per_leaf}; plain vs fp64 {plain64}; kernel vs fp64 {kernel64}")
    require(kernel_fp64_gap <= 2 * fp64_gap + 1e-6,
            f"K4b ({draw}): further from fp64 ({kernel_fp64_gap}) than twice the plain version ({fp64_gap})")
    reading = dict(draw=draw, fwd_max_abs_err=ef, grad_rel_vs_plain=eb, held_vs_plain=hold_vs_plain,
                   plain_vs_fp64=fp64_gap, kernel_vs_fp64=kernel_fp64_gap, near_ties=ties)
    return enc, x, valid, g, seed, (out, leaves, ref, ref_leaves), reading


def check_k4(gen, n_scene, dev, batch):
    """K4 forward and backward on [n_scene * 1024, 20, 128] with the batch's
    node validity (768 valid polylines a scene) plus an all-invalid and a
    partly valid polyline, dropout live, on two draws of inputs: the usual
    one (`gen` as the full run leaves it), held against the plain version
    and fp64 and timed, and the B=48 draw (replayed_generator), held against
    fp64, its kernel-vs-plain gap a reading beside its near-tie count."""
    enc, x, valid, g, seed, (out, leaves, ref, ref_leaves), usual = k4_case(gen, dev, batch, "usual draw", True)
    b48 = k4_case(replayed_generator("K4", n_scene, batch, b48=True), dev, batch, "B=48 draw", False)[-1]
    pl = valid.any(-1)
    weights = [getattr(enc, n) for n in NE.W_NAMES]
    with torch.no_grad():
        ms_f = time_ms(lambda: NT.node_encoder_train(enc, x, valid, P_DROP, seed), n=10)
        plain_f = time_ms(lambda: NT.node_encoder_train_plain(enc, x, valid, P_DROP, seed), n=3)
    L, H = enc.n_layer, enc.n_head
    with torch.no_grad():  # the same node_layer.cuh code, every dropout factor exactly 1.0
        require(torch.equal(NT._launch_fwd(x, valid, 0.0, seed, L, H, weights), enc.encode_pooled(x, valid)),
                "K4f at p = 0 must be K2 to the bit")
    dev_f = graph_ms(lambda: NT._launch_fwd(x, valid, P_DROP, seed, L, H, weights), n=3)
    dev_b = graph_ms(lambda: NT._launch_bwd(x, valid, g, P_DROP, seed, L, H, weights), n=3)
    ms_b = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), n=5)
    plain_b = time_ms(lambda: torch.autograd.grad(ref, ref_leaves, g, retain_graph=True), n=3)
    n_valid = valid.sum(dim=1).double()
    D = enc.d_model
    fwd_flop = L * (12 * D * D * n_valid.sum() + 4 * D * (n_valid * n_valid).sum()).item()
    w_bytes = sum(w.numel() * 4 for w in weights)
    io = x.numel() * 4 + valid.numel() + w_bytes + x.shape[0] * D * 4
    bf, bf_by = bound_ms(io, fwd_flop)
    # backward: reads x, valid, weights, g; writes dx and the 18 dW; each
    # dense product and attention product of the forward costs two
    bb, bb_by = bound_ms(io + x.numel() * 4 + w_bytes, 2 * fwd_flop)
    log(f"K4 node encoder train: BP={x.shape[0]} N={x.shape[1]} valid polylines={int(pl.sum())} fwd max_abs_err="
        f"{usual['fwd_max_abs_err']} ms={ms_f} device_ms={dev_f} plain_ms={plain_f} library_ms=None bound_ms={bf} "
        f"({bf_by}); bwd grad rel err={usual['grad_rel_vs_plain']} (against fp64: plain {usual['plain_vs_fp64']}, "
        f"kernel {usual['kernel_vs_fp64']}) ms={ms_b} device_ms={dev_b} plain_ms={plain_b} library_ms=None "
        f"bound_ms={bb} ({bb_by}); bwd bitwise reproducible; fwd at p = 0 is K2 to the bit; fwd out sha1="
        f"{digest(out)} [{card_line()}]")
    shape = f"BP={x.shape[0]} N={x.shape[1]} D=F=128 H=4 L=3 p=0.1, {n_scene} scenes at 768/1024 fill"
    return (dict(ms=ms_f, device_ms=dev_f, plain_ms=plain_f, bound_ms=bf, bound_by=bf_by, library_ms=None,
                 max_abs_err=usual["fwd_max_abs_err"], out_sha1=digest(out), shape=shape),
            dict(ms=ms_b, device_ms=dev_b, plain_ms=plain_b, bound_ms=bb, bound_by=bb_by, library_ms=None,
                 max_abs_err=usual["grad_rel_vs_plain"], shape=shape, draws=[usual, b48]))


# ------------------------------------------------------------------ main path


def nudged(batch):
    """The batch with every map position moved by one ulp."""
    return dict(batch, **{"map/pos": np.nextafter(batch["map/pos"], np.float32(np.inf))})


def first_step_over(diff: torch.Tensor) -> dict:
    """For each threshold, the first step whose max |diff| exceeds it (None
    if none does); diff [B, A, S, 4]."""
    per_step = diff.amax(dim=(0, 1, 3)).tolist()
    return {str(t): next((s for s, e in enumerate(per_step) if e > t), None) for t in READING_THRESHOLDS}


def compare_rollouts(out, ref, ref_nudged, what, hold: bool = True) -> dict:
    """Holds preds over the first HELD_STEPS to ROLLOUT_ATOL and validity
    equal there (with `hold`; else they are readings too); returns the
    whole horizon's readings beside the one-ulp map nudge's."""
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
    if hold:
        require(held <= ROLLOUT_ATOL, f"{what}: preds differ by {held} m > {ROLLOUT_ATOL} m in the first {HELD_STEPS} steps")
        require(held_flips == 0, f"{what}: validity differs in the first {HELD_STEPS} steps")
    return reading


def profile_run(run, wall_s, what):
    """One run() under torch.profiler: the device's busy time (the sum of its
    kernels and copies, one stream), the number of device operations, the
    host's syncs with the device, and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
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
    log(f"profile: {len(ops_)} device operations {what}, device busy {busy_ms} ms of the unprofiled "
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

    prof = profile_run(lambda: O.eval_rollout(cfg, model, batch, device=dev), median, "a rollout")

    with ops.plain_versions():
        ref = O.eval_rollout(cfg, model, batch, device=dev)
        ref_nudged = O.eval_rollout(cfg, model, nudged(batch), device=dev)
    vs_plain = compare_rollouts(out, ref, ref_nudged, "main path, kernels vs plain versions on the card")
    key = str(ROLLOUT_ATOL)
    first, first_nudge = vs_plain["first_step_over"][key], vs_plain["nudge_first_step_over"][key]
    log(f"main path: the kernels-vs-plain gap first passes {ROLLOUT_ATOL} m at step {first}, a one-ulp map "
        f"nudge's at step {first_nudge}")
    require(first is None or (first_nudge is not None and first >= first_nudge),
            f"main path: the kernels-vs-plain gap passes {ROLLOUT_ATOL} m at step {first}, before a one-ulp nudge's "
            f"({first_nudge})")
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


# ------------------------------------------------------------------ training main path

TRAIN_COUNTERS = {
    "K3f": (AT, "LAUNCHES_FWD"), "K3b": (AT, "LAUNCHES_BWD"),
    "K4f": (NT, "LAUNCHES_FWD"), "K4b": (NT, "LAUNCHES_BWD"), "K5": (DO, "LAUNCHES"),
}


def zero_train_counters():
    for mod, attr in TRAIN_COUNTERS.values():
        setattr(mod, attr, 0)


def read_train_counters():
    return {k: getattr(mod, attr) for k, (mod, attr) in TRAIN_COUNTERS.items()}


def train_path(cfg, batch, n_iter, dev):
    """make_train_step at full width: one warm-up step, then n_iter timed
    steps, each with the training kernels' counts set to 0 just before and
    read just after."""
    n_scene = batch["map/valid"].shape[0]
    model = O.make_model(cfg, device=dev, seed=0)
    step = TT.make_train_step(cfg, model, TT.make_optimizer(cfg, model))
    step(batch, seed=100)
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    secs, per_step, losses, norms = [], [], [], []
    for i in range(n_iter):
        zero_train_counters()
        t0 = time.perf_counter()
        m = step(batch, seed=101 + i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(read_train_counters())
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        log(f"train step {i}: {secs[-1]} s, loss {losses[-1]}, grad_norm {norms[-1]}, launches {per_step[-1]}")
        require(math.isfinite(losses[-1]) and math.isfinite(norms[-1]) and norms[-1] > 0, "non-finite loss or grad norm")
        for k, n in per_step[-1].items():
            require(n > 0, f"the training step did not launch {k}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # every parameter with a gradient moved (the action head's log_std has
    # none: the deterministic action's log-prob is not in the loss)
    trained = [n for n, p in model.named_parameters() if p.grad is not None and bool(p.grad.ne(0).any())]
    moved = sum(not torch.equal(before[n], dict(model.named_parameters())[n]) for n in trained)
    require(moved == len(trained) > 0, f"only {moved} of the {len(trained)} parameters with a gradient moved")
    median = statistics.median(secs)
    n_steps = cfg.time_step_end - cfg.time_step_sim_start + 1
    asps = n_scene * cfg.data.n_agent * n_steps / median
    log(f"training path: {n_scene} scenes, train-step seconds {secs}, median {median} s ({1e3 * median} ms), "
        f"{asps} agent-steps/s, peak device memory {peak_gib} GiB, {moved} of {len(before)} parameters had a "
        f"gradient and all of them moved [{card_line()}]")
    prof = profile_run(lambda: step(batch, seed=200), median, "a training step")
    return per_step[0], dict(n_scene=n_scene, seconds=secs, train_step_ms=1e3 * median, agent_steps_per_s=asps,
                             losses=losses, grad_norms=norms, launches_per_step=per_step, peak_gib=peak_gib,
                             profile=prof)


def loss_and_grads(cfg, batch, dev, plain):
    """One training step's loss and gradients (no update), seed-0 weights,
    the step's draws from a generator seeded 7."""
    model = O.make_model(cfg, device=dev, seed=0)
    with ops.plain_versions() if plain else contextlib.nullcontext():
        loss, _ = O.training_step(cfg, model, to_torch(batch, dev), torch.Generator().manual_seed(7))
        loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.detach() for n, p in model.named_parameters() if p.grad is not None}


def grad_gap(got, ref):
    """The largest per-parameter relative norm error (against each norm or
    1e-3 of the largest), the parameter it is at, and the median."""
    scale = max(r.norm().item() for r in ref.values())
    gaps = {n: (got[n] - r).norm().item() / max(r.norm().item(), 1e-3 * scale) for n, r in ref.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, statistics.median(gaps.values())


def train_vs_plain(cfg, batch, dev):
    """One training step with the kernels against the plain versions, same
    seeds: held over time_step_end = HELD_STEPS; over the whole horizon a
    reading beside a one-ulp map nudge of the plain run."""
    held = dataclasses.replace(cfg, time_step_end=HELD_STEPS)
    lk, gk = loss_and_grads(held, batch, dev, plain=False)
    lp, gp = loss_and_grads(held, batch, dev, plain=True)
    ln, gn = loss_and_grads(held, nudged(batch), dev, plain=True)
    require(gk.keys() == gp.keys(), "kernels and plain versions train different parameters")
    loss_gap = abs(lk - lp) / abs(lp)
    gap, worst, median = grad_gap(gk, gp)
    nudge_gap, nudge_worst, nudge_median = grad_gap(gn, gp)
    log(f"training step, kernels vs plain versions, steps 1..{HELD_STEPS}: loss {lk} vs {lp} (rel {loss_gap}, "
        f"tolerance {TRAIN_LOSS_RTOL}), largest gradient rel norm error {gap} at {worst}, median over leaves "
        f"{median} (tolerance {TRAIN_GRAD_RTOL}); a one-ulp map nudge of the plain run: loss rel "
        f"{abs(ln - lp) / abs(lp)}, largest gradient gap {nudge_gap} at {nudge_worst}, median {nudge_median}")
    require(loss_gap <= TRAIN_LOSS_RTOL, f"training loss differs by rel {loss_gap}")
    require(gap <= TRAIN_GRAD_RTOL, f"training gradient {worst} differs by rel {gap}")
    reading = dict(held_steps=HELD_STEPS, held_loss_rel=loss_gap, held_grad_rel=gap, held_grad_rel_median=median,
                   held_nudge_grad_rel=nudge_gap, held_nudge_grad_rel_median=nudge_median)
    del gk, gp, gn
    lk, gk = loss_and_grads(cfg, batch, dev, plain=False)
    lp, gp = loss_and_grads(cfg, batch, dev, plain=True)
    ln, gn = loss_and_grads(cfg, nudged(batch), dev, plain=True)
    reading.update(loss_rel_all=abs(lk - lp) / abs(lp), grad_rel_all=grad_gap(gk, gp)[0],
                   nudge_loss_rel_all=abs(ln - lp) / abs(lp), nudge_grad_rel_all=grad_gap(gn, gp)[0])
    log(f"training step over all {cfg.time_step_end} steps (readings): kernels vs plain loss rel {reading['loss_rel_all']}, "
        f"gradient rel {reading['grad_rel_all']}; a one-ulp map nudge moves the plain run's loss by rel "
        f"{reading['nudge_loss_rel_all']}, its gradients by rel {reading['nudge_grad_rel_all']}")
    return reading


# ------------------------------------------------------------------ validation main path


def hybrid_config(cfg: ExperimentConfig) -> ExperimentConfig:
    me = dataclasses.replace(cfg.model.map_encoder, node_encoder_impl="hybrid")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, map_encoder=me))


VAL_COUNTERS = {"K1": (FA, "LAUNCHES"), "K2": (NE, "LAUNCHES"), "K6": (BA, "LAUNCHES")}


def validation_path(cfg, batch, n_iter, dev):
    """Validator.step at full width under the hybrid node encoder: one
    warm-up, then n_iter timed steps with the launch counts set to 0 just
    before each and read just after, then epoch_end over the timed steps."""
    n_scene = batch["map/valid"].shape[0]
    model = O.make_model(cfg, device=dev, seed=0)
    val = EL.Validator(cfg, model, device=dev)
    val.step(batch, torch.Generator().manual_seed(300))
    torch.cuda.synchronize()
    val.reset()
    torch.cuda.reset_peak_memory_stats()
    secs, per_step = [], []
    for i in range(n_iter):
        for mod, attr in VAL_COUNTERS.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        val.step(batch, torch.Generator().manual_seed(301 + i))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append({k: getattr(mod, attr) for k, (mod, attr) in VAL_COUNTERS.items()})
        log(f"validation step {i}: {secs[-1]} s, launches {per_step[-1]}")
        require(per_step[-1]["K1"] > 0 and per_step[-1]["K6"] > 0, "the validation step did not launch K1 and K6")
        require(per_step[-1]["K2"] == 0, "the hybrid node encoder launched the fused kernel K2")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    metrics = val.epoch_end()
    for k in ("val/loss", "joint_future_pred/mean_average_precision", "reactive_replay/err/pos_meter",
              "joint_future_pred/err/pos_meter", "reactive_replay/min_ade", "joint_future_pred/min_ade"):
        require(k in metrics and math.isfinite(metrics[k]), f"validation metric {k} missing or not finite")
    median = statistics.median(secs)
    n_steps = cfg.time_step_end - cfg.time_step_sim_start + 1
    asps = n_scene * cfg.data.n_agent * n_steps * (1 + cfg.n_joint_future) / median
    log(f"validation path: {n_scene} scenes, Validator.step seconds {secs}, median {median} s, {asps} validation "
        f"agent-steps/s (reactive replay + {cfg.n_joint_future} joint futures), peak device memory {peak_gib} GiB "
        f"[{card_line()}]")
    log(f"validation metrics over {n_iter} steps (random weights: readings): val/loss {metrics['val/loss']}, mAP "
        f"{metrics['joint_future_pred/mean_average_precision']}, reactive_replay/err/pos_meter "
        f"{metrics['reactive_replay/err/pos_meter']}, joint_future_pred/err/pos_meter "
        f"{metrics['joint_future_pred/err/pos_meter']}")
    prof = profile_run(lambda: val.step(batch, torch.Generator().manual_seed(400)), median, "a validation step")
    keep = ("val/loss", "joint_future_pred/mean_average_precision", "reactive_replay/mean_average_precision",
            "reactive_replay/err/pos_meter", "joint_future_pred/err/pos_meter", "reactive_replay/min_ade",
            "joint_future_pred/min_ade", "reactive_replay/vae_kl", "reactive_replay/goal_loss")
    return per_step[0], dict(n_scene=n_scene, seconds=secs, step_s=median, agent_steps_per_s=asps,
                             launches_per_step=per_step, peak_gib=peak_gib, profile=prof,
                             metrics={k: metrics[k] for k in keep})


def _futures(out, ks):
    """The joint futures ks of a validation step's output, agents and
    futures flattened ([B, A * len(ks), S, ...]), for compare_rollouts."""
    p, v = out["buf_jf_preds"][:, :, ks], out["buf_jf_valid"][:, :, ks]
    return SimpleNamespace(preds=p.reshape(p.shape[0], -1, *p.shape[3:]), valid=v.reshape(v.shape[0], -1, v.shape[-1]))


def validation_vs_plain(cfg, batch, dev):
    """One validation step with the kernels against the plain versions, the
    same generator seed: the reactive replay's and the deterministic joint
    future's preds held over HELD_STEPS, the whole horizon and the sampled
    futures (whose goals are argmaxes over logits that may move by an ulp)
    readings beside a one-ulp map nudge of the plain run."""
    model = O.make_model(cfg, device=dev, seed=0)
    secs = {}

    def run(b, plain):
        t0 = time.perf_counter()
        with ops.plain_versions() if plain else contextlib.nullcontext():
            out = EL.validation_device_step(cfg, model, to_torch(b, dev), torch.Generator().manual_seed(500))
        torch.cuda.synchronize()
        secs["plain" if plain else "kernels"] = time.perf_counter() - t0
        return out

    out, ref, ref_n = run(batch, False), run(batch, True), run(nudged(batch), True)
    log(f"validation_device_step alone (no WOMD packing; the first call of a fresh model): {secs['kernels']} s "
        f"with the kernels, {secs['plain']} s with the plain versions")
    rr = [SimpleNamespace(preds=o["buf_rr_preds"], valid=o["buf_rr_valid"]) for o in (out, ref, ref_n)]
    k0 = [_futures(o, slice(0, 1)) for o in (out, ref, ref_n)]
    kn = [_futures(o, slice(1, None)) for o in (out, ref, ref_n)]
    goal_flips = int((out["goal_sample"] != ref["goal_sample"]).sum().item())
    log(f"validation step, kernels vs plain: sampled goals differing {goal_flips} of {out['goal_sample'].numel()}")
    return dict(
        reactive_replay=compare_rollouts(*rr, "validation reactive replay, kernels vs plain versions"),
        joint_future_k0=compare_rollouts(*k0, "validation joint future K=0, kernels vs plain versions"),
        joint_futures_sampled=compare_rollouts(*kn, "validation joint futures K>0 (readings), kernels vs plain",
                                               hold=False),
        goal_sample_flips=goal_flips, device_step_s=secs,
    )


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this smoke run needs one NVIDIA GPU")
    dev = O.resolve_device("cuda")  # also turns TF32 off
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    modes = {(): KERNEL_SOURCES, ("--attention",): ("fused_attention", "attention_train"),
             ("--node",): ("node_encoder", "node_encoder_train", "block_attn")}
    mode = tuple(sys.argv[1:])
    if mode not in modes:
        sys.exit(f"chip_smoke.py: unknown arguments {sys.argv[1:]} (none, --attention or --node)")
    t0 = time.perf_counter()
    build_s = cuda_build.build_all(modes[mode])
    log(f"build: {build_s} (wall {time.perf_counter() - t0:.1f} s)")

    gen = torch.Generator().manual_seed(0)
    if mode == ("--attention",):  # K1 and K3 at their sites alone: a quick check, or code against code in one call
        phase("attention kernel checks")
        k1 = check_k1(gen, N_SCENE, dev)
        k3f, k3b = check_k3(gen, N_SCENE, dev)
        log(json.dumps({"attention": {"K1": k1, "K3f": k3f, "K3b": k3b}}))
        phase("done")
        return
    cfg = ExperimentConfig()
    batch = synthetic_episode_batch(cfg.data, n_scene=N_SCENE, seed=0, n_valid_pl=768, n_valid_agent=40)
    if mode == ("--node",):  # K2, K4 and K6 on the inputs a full run gives them
        phase("node kernel checks")
        k2 = check_k2(replayed_generator("K2", N_SCENE, batch), N_SCENE, dev, batch)
        k4f, k4b = check_k4(replayed_generator("K4", N_SCENE, batch), N_SCENE, dev, batch)
        k6, hybrid = check_k6(replayed_generator("K6", N_SCENE, batch), N_SCENE, dev, batch)
        log(json.dumps({"node": {"K2": k2, "K4f": k4f, "K4b": k4b, "K6": k6, "hybrid": hybrid}}))
        phase("done")
        return
    phase("kernel checks")
    k1 = check_k1(gen, N_SCENE, dev)
    require(torch.equal(gen.get_state(), replayed_generator("K2", N_SCENE, batch).get_state()),
            "replayed_generator does not replay K1's draws")
    k2 = check_k2(gen, N_SCENE, dev, batch)
    k5 = check_k5(dev)
    k3f, k3b = check_k3(gen, N_SCENE, dev)
    require(torch.equal(gen.get_state(), replayed_generator("K4", N_SCENE, batch).get_state()),
            "replayed_generator does not replay the draws before K4's")
    k4f, k4b = check_k4(gen, N_SCENE, dev, batch)
    require(torch.equal(gen.get_state(), replayed_generator("K6", N_SCENE, batch).get_state()),
            "replayed_generator does not replay the draws before K6's")
    k6, hybrid = check_k6(gen, N_SCENE, dev, batch)

    phase("eval main path")
    launches, path = main_path(cfg, batch, N_ITER, dev)
    path["small_config_vs_cpu"] = small_reference(cfg, dev)
    phase("training main path")
    train_launches, train = train_path(cfg, batch, N_TRAIN_ITER, dev)
    phase("training kernels vs plain")
    train["vs_plain"] = train_vs_plain(cfg, batch, dev)
    phase("validation main path")
    val_cfg = hybrid_config(cfg)
    val_launches, val = validation_path(val_cfg, batch, N_ITER, dev)
    val["hybrid_node_encoder"] = hybrid
    phase("validation kernels vs plain")
    val["vs_plain"] = validation_vs_plain(val_cfg, batch, dev)
    phase("done")

    kernels = [
        dict(name="K1 fused_attention_core (masked multi-head attention core)", route="cuda",
             source="trafficbots_tpu_torch/csrc/fused_attention.cu",
             replaces="trafficbots_tpu/ops/fused_attention.py:123", launches=launches["K1"], **k1),
        dict(name="K2 FusedNodeEncoder.encode_pooled (DenseTNT node stack + max-pool)", route="cuda",
             source="trafficbots_tpu_torch/csrc/node_encoder.cu",
             replaces="trafficbots_tpu/ops/node_encoder.py:245", launches=launches["K2"], **k2),
        dict(name="K3f attention_train forward (training attention core, weight dropout)", route="cuda",
             source="trafficbots_tpu_torch/csrc/attention_train.cu",
             replaces="trafficbots_tpu/ops/attention_train.py:317", launches=train_launches["K3f"], **k3f),
        dict(name="K3b attention_train backward (dq kernel + dk/dv kernel)", route="cuda",
             source="trafficbots_tpu_torch/csrc/attention_train.cu",
             replaces="trafficbots_tpu/ops/attention_train.py:397", launches=train_launches["K3b"], **k3b),
        dict(name="K4f node_encoder_train forward (node_layer.cuh group body shared with K4b's save, dropout, pool)",
             route="cuda",
             source="trafficbots_tpu_torch/csrc/node_encoder_train.cu",
             replaces="trafficbots_tpu/ops/node_encoder_train.py:468", launches=train_launches["K4f"], **k4f),
        dict(name="K4b node_encoder_train backward (forward saved once, walk down, fixed-order split-K dW)", route="cuda",
             source="trafficbots_tpu_torch/csrc/node_encoder_train.cu",
             replaces="trafficbots_tpu/ops/node_encoder_train.py:521", launches=train_launches["K4b"], **k4b),
        dict(name="K5 dropout (counter-based Philox4x32-10)", route="cuda",
             source="trafficbots_tpu_torch/csrc/dropout.cu",
             replaces="trafficbots_tpu/ops/kernel_common.py:50", launches=train_launches["K5"], **k5),
        dict(name="K6 block_attn_core (hybrid node encoder's per-polyline attention core, persistent, "
                  "double-buffered cp.async)", route="cuda",
             source="trafficbots_tpu_torch/csrc/block_attn.cu",
             replaces="trafficbots_tpu/ops/node_encoder.py:163", launches=val_launches["K6"], **k6),
    ]
    for k in kernels:
        require(all(math.isfinite(k[f]) for f in ("ms", "device_ms", "plain_ms", "bound_ms", "max_abs_err")), str(k))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"main_path": path}))
    log(json.dumps({"training_path": train}))
    log(json.dumps({"validation_path": val}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
