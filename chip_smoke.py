#!/usr/bin/env python3
"""Smoke run of the PyTorch port (trafficbots_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Written for an H100 (the kernels are built for sm_90a). Phases, each printing
its own lines:

  1. the card: nvidia-smi's name and power limit, torch and CUDA versions,
     the TF32 flags (both off);
  2. the build: every CUDA kernel from trafficbots_tpu_torch/csrc, one nvcc
     per source, all started together, and the node kernels' sources once
     more for each other width pair that 3b and 6e run (WIDE_BUILDS); K4's
     sources, the longest to compile, build on while K1, K2, K5 and K3 are
     checked (phase 3), phase 3a runs, and phase 6f's kernels and eval
     runs, the main path's small config against the CPU run, phase 6c's
     kernel checks and validation step and phase 6a run; K4's checks wait
     for them (K2's other widths start once the first batch is built);
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
     valid node; K2's, K4f's and K6's outputs' and K4b's gradients' SHA-1
     digests (two commits' runs in one call that print the same digest gave
     the same bits);
  3a. K1 and K3 at d_head 128 (d_model 256, 2 heads): K1 at its four
     main-path sites, K1-bf16, K1-skip and K3f / K3b (dropout live) at the
     rollout as2pl and the map self-attention, each against its plain
     version at phase 3's holds, its device time, bound and SDPA's device
     time beside the same kernel's and SDPA's at 4 heads (d_head 64) on
     the same inputs; then the same at d_head 8 and 4 (d_model 128, 16 and
     32 heads), each row beside SDPA's with the same heads, its bound
     counting the softmax's exps (attn_bound);
  3b. the node kernels at the other widths they take (NODE_WIDTHS:
     (d_model, d_ff, n_head) = (256, 128, 4), (256, 256, 4), (128, 128, 2),
     at d_head 128 (256, 128, 2) and (128, 128, 1), and at hidden 64
     (64, 128, 4) and (64, 64, 2), for K2, K2-bf16 and K4, and
     (128, 128, 16) for K4) on the main fill's
     8 x 1024 x 20 polylines, each width its own draw: K2 within K2_TOL,
     K2-bf16 within its one-ulp nudge's gap, K4f within K4_TOL and K4b's
     gradients within K4_GRAD_RTOL of the plain version on the cotangent
     with the max-pool's near-tie columns set to 0 (K4_TOL's comment), the
     whole cotangent's gaps beside them, each timed beside its plain
     version and its bound, K4b's peak memory;
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
     held over the first HELD_STEPS steps beside a one-ulp map nudge;
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
 6a. the validation media's device side on the same scenes and config
     (the default fused node encoder): the reactive replay with attention
     collection (`orchestration.reactive_replay(collect_attention=True)`,
     whose as2pl runs the plain core, as in JAX) against the
     non-collecting kernel replay and against itself with the plain
     versions, held over HELD_STEPS; K1 and K2 counted over the encode and
     over the loop apart (0 K1 launches in the collecting loop); every
     valid agent-step's `attn_pl` row summing to 1 over the valid targets
     and 0 elsewhere; the collected `attn_pl`, `attn_tl` and `attn_agent`
     held kernels against plain over HELD_STEPS (`attn_pl` beside a one-ulp
     map nudge's gap); `evaluation_loop._vis_device_step` (the collecting
     replay, the destination probabilities, the K joint futures and their
     scores) timed once with its launch counts and peak memory; and
     `run.main` `validate` rendering one scene over 31 steps: the JAX
     package's file names under run_dir/videos when `cv2` is present, no
     `videos` directory when it is absent;
 6b. the training-input augmentations: one training step's loss and
     gradients over HELD_STEPS with history dropout (p = 0.2) and the
     SE(2) latent-input perturbation, kernels against the plain versions
     (phase 5's holds), K4f and K4b launched 3 times each (the map encoded
     once a view), the step's seconds beside the default step's;
  6c. the bf16 configurations (precision="bf16", map_encoder.
     kernel_matmul_bf16): (a) the SASS of the built K1, K2 and K6 libraries
     (`cuobjdump -sass`): HMMA instructions in every tensor-core kernel of
     K1-bf16, K2-bf16 and K6-bf16, none in fp32 K1's, K2's or K6's, the
     counts printed;
     K1's bf16 variant at the rollout as2pl (B = 8 and the joint futures'
     48), the map self-attention and the latent as2pl, K2's and K6's on
     phase 3's shapes, each against its plain version (held within the relative norm
     gap a one-bf16-ulp nudge of the input makes in the plain version, in
     this run; the largest gap over the largest magnitude and the count of
     differing elements printed), its ms and device_ms beside its fp32
     kernel's, SDPA on bf16 q/k/v where one call computes the function, its
     bound (bytes at 3.35 TB/s or products at 989 TFLOP/s bf16); (b) the
     eval rollout under precision="bf16" with and without
     kernel_matmul_bf16, launch counts (every K1 site on the bf16 variant,
     no fp32 K1; K2 or its bf16 variant once), against the plain versions
     beside a one-ulp map nudge (validity equal before the nudge's first
     flip; the gap passing 1e-2 m and 1e-1 m no more than
     BF16_PASSAGE_SLACK steps before the nudge's), agent-steps/s and peak
     memory beside the fp32 rollout's;
     (c) one Validator.step under "hybrid" and kernel_matmul_bf16 (K6's and
     K1's bf16 variants only) and one validation step kernels vs plain,
     held as (b); (d) one training step over HELD_STEPS, kernels vs plain,
     the loss and gradient gaps within BF16_TRAIN_NUDGE_FACTOR x a one-ulp
     map nudge's (bf16's rounding puts phase 5's limits below that floor),
     the training kernels' launch counts;
  6d. the dead-query-row skip (model.attn_row_block >= 0 in eval; every K3
     site in training): (a) K1-skip at the rollout as2pl (B = 8 and 48) and
     the latent as2pl, on fp32 q and on bf16 q/k/v, at the main path's fill
     (agents 40.. dead) and a sparse one (8 live): dead rows exactly 0, live
     rows bitwise K1's without src_invalid, against the plain version with
     the same src_invalid (K1's tolerance; bf16 within a one-bf16-ulp
     nudge's gap), ms and device_ms beside K1's own, SDPA's with the live
     rows' mask, the bound (4 D operations per allowed pair of a live row);
     (b) K3-skip at the training sites with their dead rows (the map
     self-attention's last 256 polylines, the as2pl's and the latent
     as2pl's agents 40..), dropout live: K3f's live rows and row statistics
     bitwise the unskipped kernel's, dead rows 0, K3b's dq/dk/dv bitwise
     the unskipped ones with the cotangent 0 on dead rows, both against the
     plain version, device ms beside the unskipped kernels'; (c) the eval
     rollout at attn_row_block 0 and 16 bitwise the rollout at -1 over all
     90 steps, in fp32 and under precision="bf16", K1-skip counted at every
     as2pl and latent as2pl launch and never at -1, agent-steps/s beside
     -1 (readings); (d) one Validator.step at 0 bitwise the step at -1;
     (e) a 30-step training step, kernels vs plain at phase 5's holds,
     every K3 launch a K3-skip one (phase 5 counts them beside K3f / K3b);
  6e. the options the port once refused, at full width over HELD_STEPS
     steps: (a) other widths, the default fused node stack: at hidden 256
     (model.hidden_dim=256: d_model 256, d_ff 128, 4 heads), at 2 heads
     of width 128, at hidden 256 with 2 heads (d_head 128), at hidden
     128 with 16 and 32 heads (d_head 8 and 4), at hidden 64
     (model.hidden_dim=64: d_ff 128, 4 heads) and at the tests/tiny.py
     widths (d_model = d_ff = 64, 2 heads) each kernel site's route
     printed (the kernel, "raises" with the kernel's shape predicate's
     reason, or the plain version where the JAX package runs XLA; every
     K1, K3, K2 and K4 site must read "kernel"), an eval rollout (K1, K2 once) and a training step (K3,
     K4f and K4b once, K5), each beside its kernels' launches
     and held against the plain versions: the map features within K2's
     tolerance and the preds within 1e-3 m over the 20 steps each run
     takes (WIDTHS_HELD_STEPS), the 20-step training step at phase 5's
     holds; at hidden 256 (4
     and 2 heads) one map encode with the hybrid node encoder (K6 at
     d_model 256, 3 launches) against the plain versions, each width's
     seconds; (b) the structure options: post-norm layers with
     n_layer_final_mlp=2 under each action-head variant (unbranched,
     LayerNorm'd branches, a log_std MLP), an eval rollout each against
     the plain versions with its K1 launches (the post-norm node stack is
     the generic one: no K2), and one map encode each for VectorNet, the
     mean pool and the generic node stack (one K1 launch each) against the
     plain versions; (c) one training step under each remat_policy
     ("none", "save_attn", "save_core", which runs save_attn's path): the
     loss and the largest gradient gap against "save_attn" (phase 5's
     holds), whether they are bitwise equal, the forward's and backward's seconds, the memory the forward
     leaves for the backward and the peak, the training kernels' launches;
  6f. the long map, data.n_pl = 2048 at full width (1,536 of 2,048
     polylines and 40 of 64 agents valid, seed 0; all but its training
     step run after phase 3a, beside K4's build): (a) the kernels alone
     past 1,024 keys, the last quarter of the keys masked: K1 (the site's
     K/V type: fp32 q with bf16 K/V at the as2pl; path G), K1-bf16
     (rounds of key tiles), K1-skip (agents 40.. dead), K3f and K3b
     (dropout live) at T = 2,048 at the rollout as2pl, the map
     self-attention and the latent as2pl, K1 and K1-bf16 at the joint
     futures' B = 48, K1 and K3 at the rollout as2pl at T = 4,096: each
     held against its plain version at phase 3's tolerances (K1-bf16
     within a one-bf16-ulp nudge's gap, K1-skip's live rows bitwise K1's,
     K3b twice bitwise), its device ms, bound, plain ms, SDPA's device ms
     and its own device ms at T = 1,024 on the same site; (b) over
     HELD_STEPS steps (the depth cut), an eval rollout against the plain
     versions beside a one-ulp map nudge (the main path's hold), one
     training step (phase 5's holds) and one bf16 eval (held by its order
     of passage), each attention site's route printed from spies on the
     model's attention cores (every site over the map on its kernel, none
     plain) beside the launch counts;
  7. the CLI runner, `trafficbots_tpu_torch.run.main` in-process at full
     width (batch 8, synthetic data, 1 step an epoch, 1 validation batch,
     the default fused node encoder; the default n_video_batch without cv2,
     with it 0 but in run B's first fit, which renders one full-width batch
     at n_video_batch=1 under videos/epoch0, its seconds printed): run A
     fits 2 epochs with the launch
     counts set to 0 just before and read just after (K3f, K3b, K4f, K4b,
     K5, K1 and K2 each launched); run B fits 1 epoch, then resumes from
     `last` to 2, and B's `last` checkpoint equals A's bitwise (every
     parameter, Adam's state, the schedule, epoch, global step, the
     generator); `validate` from `best` on the native WOMD engine (finite
     val/loss, the metric keys of phase 6, the native metrics equal the
     numpy engine's on the same accumulated inputs within rtol 1e-4 / atol
     1e-5, both engines' epoch_end seconds printed); `test` from `best`
     (one scenario prediction per scene in each of the K submission
     files); one `cli_path` line with the launch counts, the Profiler's
     step means, the checkpoint's save and restore ms and its size;
  8. the paper's ablation models and the interactive sim at full width
     (`config.ablation` on the same config and scenes, each count set to 0
     just before its run and read just after): the goal_xy GoalPredictor
     alone (its as2pl launches K1 once in eval, K3f and K3b once in
     training); ablation("trafficsim"), one timed make_train_step (the
     first of a fresh model; K3f/K3b/K4f/K4b/K5 launched, finite, every trained
     parameter moved), then its loss and gradients with the kernels
     against the plain versions over HELD_STEPS as phase 5 holds them;
     ablation("latent_cat"), the eval rollout against the plain versions
     (phase 4's hold) and one Validator.step + epoch_end (K1 launched,
     finite val/loss); ablation("goal_xy"), one Validator.step (K1
     launched at the GoalPredictor's as2pl too), then one validation step
     against the plain versions (held over GOAL_XY_HELD_STEPS, the gap no
     earlier past ROLLOUT_ATOL than a one-ulp nudge's); the DestPredictor
     heads "transformer", "transformer_aggr" and "attn", each one pred_goal
     against its plain run, its probabilities and exclusions, its peak
     memory and one training step over HELD_STEPS;
     `orchestration.interactive_replay` run
     to the end against reactive_replay bitwise, a 20-step prefix, two
     agents forced at one step, the host's ms a step; one `ablations` line;
  9. data parallelism (`parallel/mesh.py`) at full width on the same 8
     scenes, a global batch of 8, 4 scenes a rank: (a) an NCCL group of one
     rank in this process (init, an all-reduce of a CUDA tensor, destroy)
     and the backend each layout gets; two ranks sharing the card, started
     as OS processes by `parallel.launch` and joining through
     `parallel.mesh.init_from_env` (gloo, printed by each), each running
     (b) one data-parallel `make_train_step` with K3f/K3b/K4f/K4b/K5
     counted (set to 0 just before, read just after): both ranks' updated
     parameters and Adam states equal to the bit, and equal to the bit to
     this process taking each half alone with that rank's `rank_seed`,
     summing the two gradients and halving them, then the clip and Adam;
     (c) one `Validator.step` (K1 and K2 counted) and `epoch_end`: the
     reactive replay and the K = 0 joint future held against this
     process's step on the 8 scenes over HELD_STEPS (the one-ulp nudge
     beside them), each rank's noise its rows of this process's draws to
     the bit, the metrics readings; (d) `run.main` on both ranks: fit A (2
     epochs), fit B (1 epoch, then a resume to 2) with B's `last` equal to
     A's to the bit, `test` (one prediction per scene, each scene id once,
     in each of the K files); only rank 0 wrote under the run directories
     (every rank's writes are recorded) and printed the epoch lines; one
     `data_parallel` line with the launch counts per rank, the backend,
     each rank's step times and peak memory beside this process's (two
     ranks on one card: readings, not a scaling figure) and the phase's
     seconds. The ranks start before phase 7 and run beside phases 7 and 8
     and this process's references for b and c (the readings of 7, 8 and 9
     share the host and the card); the holds are joined after phase 8;
 10. the kernels line (K2's, K2-bf16's, K4f's and K4b's rows carry their
     3b readings under other_widths), the card line, and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero before the last line. Without CUDA the
script exits non-zero at once. It imports nothing of JAX.

    python3 chip_smoke.py --attention
    python3 chip_smoke.py --node

build K1 and K3 (--attention), or K2, K4 and K6 (--node, with the other
widths' builds), alone and run only their checks and timings (phase 3's
lines for them and one JSON line, no last line; --attention then runs
phase 3a, K1 and K3 at d_head 128, 8 and 4; --node replays the shared
generator's earlier draws on the CPU, so K2, K4 and K6 see the inputs a
full run gives them, then runs K2-bf16 at phase 6c's shapes and phase 3b):
a quick check after an edit of their sources, or, copied into an unpacked
older commit and run there, that commit's numbers beside this one's in the
same call.

    python3 chip_smoke.py --cli

builds every kernel and runs only phase 7 (its metric keys not held
against phase 6's), with its JSON line and no last line.

    python3 chip_smoke.py --ablations

builds every kernel and runs only phase 8, with its JSON line and no last
line.

    python3 chip_smoke.py --dp

builds the kernels of the training and validation paths (K1-K5) and runs
only phase 9, with its JSON line and no last line.

    python3 chip_smoke.py --media
    python3 chip_smoke.py --augment

build K1 and K2 (--media), or K1-K5 (--augment), and run only phase 6a
or 6b, with its JSON line and no last line.

    python3 chip_smoke.py --bf16

builds every kernel and runs only phase 6c, with its JSON line and no last
line.

    python3 chip_smoke.py --row-skip

builds K1-K5 and runs only phase 6d, with its JSON line and no last line.

    python3 chip_smoke.py --options

builds K1-K6 (the node kernels also at the (d_model, d_ff) pairs (256,
128), (64, 128) and (64, 64)) and runs only phase 6e, with its JSON line,
the card line and the last line.

    python3 chip_smoke.py --long-map

builds K1-K5 and runs only phase 6f, with its JSON line, the card line
and the last line.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from trafficbots_tpu_torch import evaluation_loop as EL
from trafficbots_tpu_torch import ops
from trafficbots_tpu_torch import orchestration as O
from trafficbots_tpu_torch.config import ExperimentConfig, ablation
from trafficbots_tpu_torch.data.preprocessing import pre_processing, to_torch
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch
from trafficbots_tpu_torch.ops import attention_train as AT
from trafficbots_tpu_torch.ops import block_attn as BA
from trafficbots_tpu_torch.ops import cuda_build
from trafficbots_tpu_torch.ops import dropout as DO
from trafficbots_tpu_torch.ops import fused_attention as FA
from trafficbots_tpu_torch.ops import node_encoder as NE
from trafficbots_tpu_torch.ops import node_encoder_train as NT
from trafficbots_tpu_torch.models import goal_manager as GM
from trafficbots_tpu_torch.models import modules as MM
from trafficbots_tpu_torch.ops.dropout import DropoutSeeds
from trafficbots_tpu_torch.sim.teacher_forcing import teacher_forcing_mask
from trafficbots_tpu_torch.training import train as TT
from trafficbots_tpu_torch.utils import vis as VIS
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
N_TRAIN_ITER = 2  # timed training steps
KERNEL_SOURCES = ("fused_attention", "node_encoder", "dropout", "attention_train", "node_encoder_train", "block_attn")
# the node kernels' builds at the other width pairs that NODE_WIDTHS and
# the options phase run (ops.node_encoder.build_defines: a library a width
# pair)
WIDE_PAIRS = ((256, 128), (64, 128), (64, 64), (256, 256))
WIDE_BUILDS = tuple((name, NE.build_defines(D, Fd)) for D, Fd in WIDE_PAIRS
                    for name in ("node_encoder", "node_encoder_train"))
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
# At the other widths (NODE_WIDTHS) K4's gradients are held on the
# cotangent with the max-pool's near-tie columns set to 0: the columns
# whose two largest valid-node values (fp64) lie within K4_TOL of each
# other, the forward's own tolerance. There the kernel's in-order sums and
# cuBLAS's blocked ones may pick different nodes, and each pick moves a
# whole column's cotangent (on the H100 at 256 x 128, 4 heads: the kernel
# 2.1e-3 from fp64 on the whole cotangent, the plain version 4.4e-4, all
# of dx's gap in 10 of 6,143 polylines); the gaps on the whole cotangent
# are printed beside the holds.
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


def k1_case(gen, B, S, T, kv_bf16, pad_frac, full_mask, dev, D=128, H=4):
    """Inputs at one call site: a [B, T] padding mask read through a
    stride-0 expand (as the model passes it), or a full [B, S, T] mask with
    one all-masked row."""
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


# ------------------------------------------------------------------ K1 and K3 at other head widths (phase 3a)

WIDE_D = 256  # hidden 256 with 2 heads: d_head 128; its d_head-64 row at 4 heads beside it
NARROW_HEADS = (16, 32)  # hidden 128 with 16 and 32 heads: d_head 8 and 4
# the special-function units' exps (16 a clock an SM, where the fp32 pipes
# make 256 FLOP: the H100 SXM data sheet's 67 TFLOP/s over 16)
EXP_PER_S = FP32_FLOP_PER_S / 16


def attn_bound(n_bytes: float, n_flop: float, n_exp: float, bf16: bool = False):
    """The bound of an attention core: its bytes at 3.35 TB/s, its products
    (fp32 at 67 TFLOP/s, or bf16 operands at 989) and its softmax's exps
    (one a head for each allowed pair, at EXP_PER_S), whichever takes
    longest: at d_head 4 the exps take as long as the products."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_flop / (BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S), n_exp / EXP_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def attention_sites():
    """K1's main-path sites: (name, B, S, bf16 K/V), T = 1024."""
    return (("rollout as2pl", N_SCENE, 64, True), (K1_B48, 6 * N_SCENE, 64, True),
            ("map polyline self-attention", N_SCENE, 1024, False), ("latent as2pl", N_SCENE, 19 * 64, False))


def sdpa_device_ms(q, k, v, allowed, H):
    """SDPA's device ms (a CUDA graph) on q, k, v split into H heads, the
    mask `allowed` [B, S, T]: the yardstick (a flash kernel exists at
    d_head 128 for bf16; fp32 takes the efficient or math kernel)."""
    qh, kh, vh = (t.view(t.shape[0], t.shape[1], H, -1).transpose(1, 2) for t in (q, k, v))
    return graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed[:, None]))


def check_attention_heads(dev, D, H, base_H=None, seed=128) -> dict:
    """K1 (fp32 q, the site's K/V type) at the four main-path K1 sites,
    K1-bf16 and K1-skip at the rollout as2pl and the map self-attention,
    K3f / K3b (dropout live) at the rollout as2pl and the map self-attention,
    all at d_model D with H heads, each against its plain version at the
    default width's holds (K1-bf16 within a one-bf16-ulp input nudge's
    gap); each row's device ms, bound (attn_bound) and SDPA's device ms
    with the same heads, and with base_H the same kernel's and SDPA's at
    base_H heads on the same inputs beside them (`d_head_<D / base_H>`)."""
    out = {"K1": [], "K1-bf16": [], "K1-skip": [], "K3f": [], "K3b": []}
    dh = D // H
    heads = (base_H, H) if base_H else (H,)
    base_key = f"d_head_{D // base_H}" if base_H else None
    tag = f"d_head {dh}"

    def beside(row, by_heads, **extra):
        if base_H:
            row[base_key] = dict(by_heads[base_H], **extra)
        return row

    for i, (name, B, S, kv_bf16) in enumerate(attention_sites()):
        gen = torch.Generator().manual_seed(seed + i)
        (q, k, v, invalid, _), mask_bytes = k1_case(gen, B, S, 1024, kv_bf16, 0.25, False, dev, D=D)
        allowed = ~invalid
        n_pairs = int(allowed.sum().item())
        by_heads = {}
        for h in heads:
            args = (q, k, v, invalid, h)
            by_heads[h] = dict(device_ms=graph_ms(lambda: FA.fused_attention_core(*args)),
                               library_device_ms=sdpa_device_ms(q, k.float(), v.float(), allowed, h))
        args = (q, k, v, invalid, H)
        got, again = FA.fused_attention_core(*args), FA.fused_attention_core(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"K1 {tag} {name}: not bitwise reproducible")
        err = max_err_checked(got, FA.attention_core_plain(*args), K1_TOL, f"K1 {tag} {name}")
        b_ms, b_by = attn_bound(2 * q.numel() * 4 + 2 * k.numel() * k.element_size() + mask_bytes, 4 * D * n_pairs,
                                H * n_pairs)
        row = beside(dict(site=name, max_abs_err=err, ms=time_ms(lambda: FA.fused_attention_core(*args)),
                          device_ms=by_heads[H]["device_ms"], plain_ms=time_ms(lambda: FA.attention_core_plain(*args), n=5),
                          library_device_ms=by_heads[H]["library_device_ms"], bound_ms=b_ms, bound_by=b_by), by_heads)
        out["K1"].append(row)
        log(f"K1 {tag} {name}: B={B} S={S} T=1024 D={D} H={H} kv={'bf16' if kv_bf16 else 'fp32'} {row} "
            f"[{card_line()}]")
        if name not in ("rollout as2pl", "map polyline self-attention"):
            continue
        # K1-bf16 on bf16 q/k/v, within a one-bf16-ulp input nudge's gap
        b16 = (q.bfloat16(), k.bfloat16(), v.bfloat16(), invalid)
        by_heads = {h: dict(device_ms=graph_ms(lambda: FA.fused_attention_core(*b16, h)),
                            library_device_ms=sdpa_device_ms(*b16[:3], allowed, h)) for h in heads}
        got, again = FA.fused_attention_core(*b16, H), FA.fused_attention_core(*b16, H)
        torch.cuda.synchronize()
        require(got.dtype == torch.bfloat16 and torch.equal(got, again), f"K1-bf16 {tag} {name}: not reproducible")
        held = bf16_held(f"K1-bf16 {tag} {name}", got, FA.attention_core_plain(*b16, H),
                         FA.attention_core_plain(bf16_up(b16[0]), *b16[1:], H))
        b_ms, b_by = attn_bound(2 * q.numel() * 2 + 2 * k.numel() * 2 + mask_bytes, 4 * D * n_pairs, H * n_pairs,
                                bf16=True)
        row = beside(dict(site=name, max_abs_err=held["vs_plain"]["max_abs"], **held,
                          ms=time_ms(lambda: FA.fused_attention_core(*b16, H)), device_ms=by_heads[H]["device_ms"],
                          plain_ms=time_ms(lambda: FA.attention_core_plain(*b16, H), n=5),
                          library_device_ms=by_heads[H]["library_device_ms"], bound_ms=b_ms, bound_by=b_by), by_heads)
        out["K1-bf16"].append(row)
        log(f"K1-bf16 {tag} {name}: {row} [{card_line()}]")
        # K1-skip at the main fill: agents (rows) 40.. of each 64 dead
        src = dead_agents(B, S, FILL_AGENTS, dev)
        live = FA.row_live(invalid, src)
        by_heads = {h: dict(device_ms=graph_ms(lambda: FA.fused_attention_core(*args[:4], h, src_invalid=src)))
                    for h in heads}
        got = FA.fused_attention_core(*args, src_invalid=src)
        base = FA.fused_attention_core(*args)
        torch.cuda.synchronize()
        require(bool((got[~live] == 0).all()) and torch.equal(got[live], base[live]),
                f"K1-skip {tag} {name}: dead rows not 0 or live rows not K1's")
        err = max_err_checked(got, FA.attention_core_plain(*args, src_invalid=src), K1_TOL, f"K1-skip {tag} {name}")
        live_pairs = int((allowed & live[..., None]).sum().item())
        b_ms, b_by = attn_bound(2 * q.numel() * 4 + 2 * k.numel() * k.element_size() + mask_bytes + src.numel(),
                                4 * D * live_pairs, H * live_pairs)
        row = beside(dict(site=name, max_abs_err=err, ms=time_ms(lambda: FA.fused_attention_core(*args, src_invalid=src)),
                          device_ms=by_heads[H]["device_ms"],
                          plain_ms=time_ms(lambda: FA.attention_core_plain(*args, src_invalid=src), n=5),
                          library_device_ms=sdpa_device_ms(q, k.float(), v.float(), allowed & live[..., None], H),
                          bound_ms=b_ms, bound_by=b_by), by_heads)
        out["K1-skip"].append(row)
        log(f"K1-skip {tag} {name}: {row} [{card_line()}]")
        # K3f / K3b, fp32 K/V, dropout live
        q3, k3, v3 = q, k.float(), v.float()
        g = torch.randn(B, S, D, generator=gen).to(dev)
        seed_k3 = 2**41 + S
        rows = {}
        for h in heads:
            o, rmax, rsum = AT._launch_fwd(q3, k3, v3, invalid, h, P_DROP, seed_k3, 0)
            lib_fwd, lib_leaves = sdpa_train(q3, k3, v3, invalid, h)
            with torch.no_grad():
                lib_f = graph_ms(lib_fwd)
            lib_out = lib_fwd()
            gh = g.view(B, S, h, -1).transpose(1, 2)
            rows[h] = dict(fwd_device_ms=graph_ms(lambda: AT._launch_fwd(q3, k3, v3, invalid, h, P_DROP, seed_k3, 0)),
                           bwd_device_ms=graph_ms(lambda: AT._launch_bwd(q3, k3, v3, invalid, o, rmax, rsum, g, h,
                                                                         P_DROP, seed_k3, 0)),
                           library_fwd_device_ms=lib_f,
                           library_bwd_device_ms=profiled_ms(
                               lambda: torch.autograd.grad(lib_out, lib_leaves, gh, retain_graph=True)))

        def run(fn):
            qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q3, k3, v3))
            o_ = fn(qq, kk, vv, invalid, H, P_DROP, seed_k3, 0)
            return o_, torch.autograd.grad(o_, (qq, kk, vv), g)

        got, grads = run(AT.attention_train)
        _, grads2 = run(AT.attention_train)
        ref, ref_grads = run(AT.attention_train_plain)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(grads, grads2)), f"K3b {tag} {name}: not reproducible")
        ef = max_err_checked(got.detach(), ref.detach(), K3_TOL, f"K3f {tag} {name}")
        eb = grads_checked(grads, ref_grads, ("dq", "dk", "dv"), K3_GRAD_RTOL, f"K3b {tag} {name}")
        io = (2 * q.numel() + 2 * k.numel()) * 4 + mask_bytes + 2 * B * H * S * 4
        bf, bf_by = attn_bound(io, 4 * D * n_pairs, H * n_pairs)
        bb, bb_by = attn_bound(io + (2 * q.numel() + 2 * k.numel()) * 4, 8 * D * n_pairs, H * n_pairs)
        with torch.no_grad():
            plain_f = time_ms(lambda: AT.attention_train_plain(q3, k3, v3, invalid, H, P_DROP, seed_k3, 0), n=5)
            ms_f = time_ms(lambda: AT.attention_train(q3, k3, v3, invalid, H, P_DROP, seed_k3, 0))
        out["K3f"].append(beside(dict(site=name, max_abs_err=ef, ms=ms_f, device_ms=rows[H]["fwd_device_ms"],
                                      plain_ms=plain_f, library_device_ms=rows[H]["library_fwd_device_ms"],
                                      bound_ms=bf, bound_by=bf_by),
                                 {h: dict(device_ms=r["fwd_device_ms"], library_device_ms=r["library_fwd_device_ms"])
                                  for h, r in rows.items()}))
        out["K3b"].append(beside(dict(site=name, max_abs_err=eb, device_ms=rows[H]["bwd_device_ms"],
                                      library_device_ms=rows[H]["library_bwd_device_ms"], bound_ms=bb, bound_by=bb_by),
                                 {h: dict(device_ms=r["bwd_device_ms"], library_device_ms=r["library_bwd_device_ms"])
                                  for h, r in rows.items()}))
        log(f"K3 {tag} {name}: fwd {out['K3f'][-1]} bwd {out['K3b'][-1]} [{card_line()}]")
    return out


def check_attention_d_head_128(dev) -> dict:
    """Phase 3a at d_head 128 (D = WIDE_D with 2 heads), beside d_head 64."""
    return check_attention_heads(dev, WIDE_D, 2, base_H=4, seed=128)


def check_attention_narrow(dev) -> dict:
    """Phase 3a at d_head 8 and 4 (hidden 128 with NARROW_HEADS heads):
    {"d_head_8": ..., "d_head_4": ...}, each check_attention_heads'."""
    return {f"d_head_{128 // H}": check_attention_heads(dev, 128, H, seed=1000 + H) for H in NARROW_HEADS}


# ------------------------------------------------------------------ K2


def node_flop(enc, valid) -> float:
    """The node stack's operations on this data: L x ((8 D^2 + 4 D F) a
    valid node (the q, k, v and out projections, the two FFN products) +
    4 D n^2 a polyline of n valid nodes (q k^T and the weighted sum over
    every head))."""
    n_valid = valid.sum(dim=1).double()
    D, Fd = enc.d_model, enc.d_feedforward
    return enc.n_layer * ((8 * D * D + 4 * D * Fd) * n_valid.sum() + 4 * D * (n_valid * n_valid).sum()).item()


def node_widths(enc) -> str:
    return f"D={enc.d_model} F={enc.d_feedforward} H={enc.n_head} L={enc.n_layer}"


def check_k2(gen, n_scene, dev, batch):
    """K2 on [n_scene * 1024, 20, 128] with the batch's node validity (768
    valid polylines a scene of 5-20 nodes, the rest all padding), plus an
    all-invalid and a partly valid polyline among the valid ones."""
    return k2_reading(*node_encoder_case(gen, dev, batch), n_scene)


def k2_reading(enc, x, valid, n_scene):
    """K2 held against its plain version at K2_TOL, timed, its bound."""
    with torch.no_grad():
        out = enc.encode_pooled(x, valid)
        torch.cuda.synchronize()
        ref = enc.pooled_plain(x, valid)
        err = max_err_checked(out, ref, K2_TOL, f"K2 ({node_widths(enc)})")
        ms = time_ms(lambda: enc.encode_pooled(x, valid), n=10)
        dev_ms = graph_ms(lambda: enc.encode_pooled(x, valid), n=5)
        plain_ms = time_ms(lambda: enc.pooled_plain(x, valid), n=5)
    D = enc.d_model
    n_weight_bytes = sum(getattr(enc, n).numel() * 4 for n in NE.W_NAMES)
    n_bytes = x.numel() * 4 + valid.numel() + n_weight_bytes + x.shape[0] * D * 4
    b_ms, b_by = bound_ms(n_bytes, node_flop(enc, valid))
    log(f"K2 node encoder + pool: BP={x.shape[0]} N={x.shape[1]} {node_widths(enc)} valid polylines="
        f"{int(valid.any(dim=1).sum())} max_abs_err={err} ms={ms} device_ms={dev_ms} plain_ms={plain_ms} "
        f"library_ms=None bound_ms={b_ms} ({b_by}) out sha1={digest(out)} [{card_line()}]")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err, out_sha1=digest(out),
                shape=f"BP={x.shape[0]} N={x.shape[1]} {node_widths(enc)}, {n_scene} scenes at 768/1024 fill")


# ------------------------------------------------------------------ K6 (hybrid node encoder)


def node_encoder_case(gen, dev, batch, widths=(128, 128, 4)):
    """A full-width node encoder (d_model, d_ff, n_head = widths, 3 layers)
    with non-trivial LayerNorm scales and biases, and [n_scene * 1024, 20,
    d_model] inputs with the batch's node validity (768 valid polylines a
    scene of 5-20 nodes, the rest all padding) plus an all-invalid and a
    partly valid polyline among the valid ones."""
    D, Fd, H = widths
    enc = NE.FusedNodeEncoder(D, H, 3, Fd)
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
    x = torch.randn(*valid.shape, D, generator=gen) * valid[..., None]
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


def k3_inputs(gen, B, S, T, pad_frac, full_mask, dev, D=128):
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


def tie_columns(nodes64, valid, tol):
    """[BP, D] True where a polyline's column has its two largest valid-node
    values (fp64) within tol (atol + rtol |largest|) of each other: the
    max-pool near-ties, where the forward's gap from the plain version may
    swap the two and move the column's whole cotangent to another node."""
    masked = torch.where(valid[..., None], nodes64, torch.full_like(nodes64, -math.inf))
    top = masked.topk(2, dim=1).values
    return (valid.sum(dim=1)[:, None] >= 2) & (top[:, 0] - top[:, 1] <= tol["atol"] + tol["rtol"] * top[:, 0].abs())


def k4_case(gen, dev, batch, draw, hold_vs_plain, widths=(128, 128, 4), tie_tol=None):
    """K4 forward and backward on one draw of inputs, dropout live: the
    backward twice, bitwise equal; the forward against the plain version;
    the gradients against the plain version's (held to K4_GRAD_RTOL with
    hold_vs_plain, else a reading) and both against an fp64 plain run (the
    kernel held to twice the plain version's gap); the max-pool near-ties of
    the plain forward's node outputs counted. With tie_tol the holds take
    the cotangent with its near-tie columns (tie_columns at tie_tol, from
    the fp64 forward) set to 0, and the gaps on the whole cotangent are
    readings beside them, with the share of dx's gap in its ten worst
    polylines."""
    enc, x, valid = node_encoder_case(gen, dev, batch, widths)
    D, Fd, H = widths
    pl = valid.any(-1)
    g = torch.where(pl[:, None], torch.randn(x.shape[0], D, generator=gen).to(dev), torch.zeros((), device=dev))
    seed = 2**50 + 9
    weights = [getattr(enc, n) for n in NE.W_NAMES]
    names = ("dx",) + NE.W_NAMES

    def graph(fn):
        xx = x.clone().requires_grad_()
        return fn(enc, xx, valid, P_DROP, seed), [xx] + weights

    out, leaves = graph(NT.node_encoder_train)
    ref, ref_leaves = graph(NT.node_encoder_train_plain)
    ef = max_err_checked(out.detach()[pl], ref.detach()[pl], K4_TOL, f"K4f ({draw})")
    require(bool((out[~pl] == NE.NEG).all()), "K4f: a polyline without a valid node must pool to -1e30")
    # both sides' rounding: fp32 against fp64 on the same inputs
    enc64 = NE.FusedNodeEncoder(D, H, 3, Fd).to(dev, torch.float64)
    enc64.load_state_dict({k: v.double() for k, v in enc.state_dict().items()})
    with torch.no_grad():
        nodes64 = enc64(x.double(), valid, P_DROP, seed)
        ties = near_ties(enc(x, valid, P_DROP, seed), valid, nodes64)
    x64 = x.double().requires_grad_()
    out64 = NT.node_encoder_train_plain(enc64, x64, valid, P_DROP, seed)
    leaves64 = [x64] + [getattr(enc64, n) for n in NE.W_NAMES]

    def gaps(gc):
        """The kernel's gradients on cotangent gc (twice, bitwise equal), the
        plain version's and fp64's, and their gaps."""
        grads = torch.autograd.grad(out, leaves, gc, retain_graph=True)
        again = torch.autograd.grad(out, leaves, gc, retain_graph=True)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(grads, again)), f"K4b ({draw}): not bitwise reproducible")
        ref_grads = torch.autograd.grad(ref, ref_leaves, gc, retain_graph=True)
        g64 = torch.autograd.grad(out64, leaves64, gc.double(), retain_graph=True)
        return grads, ref_grads, dict(
            vs_plain=grads_checked(grads, ref_grads, names, math.inf, f"K4b ({draw})"),
            plain_vs_fp64=grads_checked([r.double() for r in ref_grads], g64, names, 1.0, "K4 plain fp32 vs fp64"),
            kernel_vs_fp64=grads_checked([r.double() for r in grads], g64, names, 1.0, "K4 kernel vs fp64"),
            per_leaf={n: rel_err(a, b) for n, a, b in zip(names, grads, ref_grads)},
            plain64={n: rel_err(r.double(), b) for n, r, b in zip(names, ref_grads, g64)},
            kernel64={n: rel_err(r.double(), b) for n, r, b in zip(names, grads, g64)})

    whole = None
    if tie_tol is not None:
        tied = tie_columns(nodes64, valid, tie_tol)
        grads, ref_grads, whole = gaps(g)
        d2 = (grads[0] - ref_grads[0]).pow(2).sum(dim=(1, 2))
        whole.update(tied_columns=int(tied.sum()), tie_tol=tie_tol,
                     dx_gap_share_worst10=(d2.topk(10).values.sum() / d2.sum().clamp(min=1e-30)).item(),
                     worst10_have_tie=int(tied[d2.topk(10).indices].any(dim=1).sum()))
        log(f"K4 ({draw}, {node_widths(enc)}), the whole cotangent (a reading): kernel vs plain {whole['vs_plain']}, "
            f"against fp64: plain {whole['plain_vs_fp64']}, kernel {whole['kernel_vs_fp64']}; dx's gap: "
            f"{whole['dx_gap_share_worst10']} of its square in 10 polylines, {whole['worst10_have_tie']} of them "
            f"with a near-tie column; {whole['tied_columns']} near-tie columns (within {tie_tol}, fp64)")
        g = torch.where(tied, torch.zeros((), device=dev), g)
    grads, ref_grads, held = gaps(g)
    eb, fp64_gap, kernel_fp64_gap = held["vs_plain"], held["plain_vs_fp64"], held["kernel_vs_fp64"]
    del enc64, x64, out64, leaves64, nodes64
    log(f"K4 ({draw}, {node_widths(enc)}{', near-tie columns 0' if tie_tol else ''}): fwd max_abs_err={ef}; bwd "
        f"grad rel err vs plain {eb} ({'held to ' + str(K4_GRAD_RTOL) if hold_vs_plain else 'a reading'}); against "
        f"fp64: plain {fp64_gap}, kernel {kernel_fp64_gap} (held to twice the plain's); max-pool near-ties of the "
        f"plain forward (exact / within {ties['ulps']} ulp / within {ties['rel']} relative): {ties['exact']} / "
        f"{ties['near']} / {ties['near_rel']}, argmax flips against fp64 {ties['flips']}, of {int(pl.sum()) * D} "
        f"columns; per leaf, kernel vs plain {held['per_leaf']}; plain vs fp64 {held['plain64']}; kernel vs fp64 "
        f"{held['kernel64']}")
    require(kernel_fp64_gap <= 2 * fp64_gap + 1e-6,
            f"K4b ({draw}): further from fp64 ({kernel_fp64_gap}) than twice the plain version ({fp64_gap})")
    if hold_vs_plain:
        grads_checked(grads, ref_grads, names, K4_GRAD_RTOL, f"K4b ({draw})")
    reading = dict(draw=draw, fwd_max_abs_err=ef, grad_rel_vs_plain=eb, held_vs_plain=hold_vs_plain,
                   plain_vs_fp64=fp64_gap, kernel_vs_fp64=kernel_fp64_gap, near_ties=ties,
                   grads_sha1=digest(torch.cat([t.flatten() for t in grads])))
    if whole is not None:
        reading["whole_cotangent"] = {k: v for k, v in whole.items() if k not in ("per_leaf", "plain64", "kernel64")}
    return enc, x, valid, g, seed, (out, leaves, ref, ref_leaves), reading


def check_k4(gen, n_scene, dev, batch):
    """K4 forward and backward on [n_scene * 1024, 20, 128] with the batch's
    node validity (768 valid polylines a scene) plus an all-invalid and a
    partly valid polyline, dropout live, on two draws of inputs: the usual
    one (`gen` as the full run leaves it), held against the plain version
    and fp64 and timed, and the B=48 draw (replayed_generator), held against
    fp64, its kernel-vs-plain gap a reading beside its near-tie count."""
    *case, usual = k4_case(gen, dev, batch, "usual draw", True)
    b48 = k4_case(replayed_generator("K4", n_scene, batch, b48=True), dev, batch, "B=48 draw", False)[-1]
    k4f, k4b = k4_reading(*case, usual, n_scene)
    k4b["draws"] = [usual, b48]
    return k4f, k4b


def k4_reading(enc, x, valid, g, seed, graphs, usual, n_scene):
    """K4's times and bounds on k4_case's inputs, K4f at p = 0 against K2
    to the bit, the peak memory of K4b's call (its scratch)."""
    out, leaves, ref, ref_leaves = graphs
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
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    NT._launch_bwd(x, valid, g, P_DROP, seed, L, H, weights)
    torch.cuda.synchronize()
    bwd_peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    D = enc.d_model
    fwd_flop = node_flop(enc, valid)
    w_bytes = sum(w.numel() * 4 for w in weights)
    io = x.numel() * 4 + valid.numel() + w_bytes + x.shape[0] * D * 4
    bf, bf_by = bound_ms(io, fwd_flop)
    # backward: reads x, valid, weights, g; writes dx and the 18 dW; each
    # dense product and attention product of the forward costs two
    bb, bb_by = bound_ms(io + x.numel() * 4 + w_bytes, 2 * fwd_flop)
    log(f"K4 node encoder train: BP={x.shape[0]} N={x.shape[1]} {node_widths(enc)} valid polylines={int(pl.sum())} "
        f"fwd max_abs_err={usual['fwd_max_abs_err']} ms={ms_f} device_ms={dev_f} plain_ms={plain_f} library_ms=None "
        f"bound_ms={bf} ({bf_by}); bwd grad rel err={usual['grad_rel_vs_plain']} (against fp64: plain "
        f"{usual['plain_vs_fp64']}, kernel {usual['kernel_vs_fp64']}) ms={ms_b} device_ms={dev_b} plain_ms={plain_b} "
        f"library_ms=None bound_ms={bb} ({bb_by}) peak {bwd_peak_gib} GiB above its inputs; bwd bitwise "
        f"reproducible; fwd at p = 0 is K2 to the bit; fwd out sha1={digest(out)} grads sha1={usual['grads_sha1']} "
        f"[{card_line()}]")
    shape = f"BP={x.shape[0]} N={x.shape[1]} {node_widths(enc)} p=0.1, {n_scene} scenes at 768/1024 fill"
    return (dict(ms=ms_f, device_ms=dev_f, plain_ms=plain_f, bound_ms=bf, bound_by=bf_by, library_ms=None,
                 max_abs_err=usual["fwd_max_abs_err"], out_sha1=digest(out), shape=shape),
            dict(ms=ms_b, device_ms=dev_b, plain_ms=plain_b, bound_ms=bb, bound_by=bb_by, library_ms=None,
                 max_abs_err=usual["grad_rel_vs_plain"], grads_sha1=usual["grads_sha1"], peak_gib=bwd_peak_gib,
                 shape=shape))


# (d_model, d_ff, n_head) the node kernels take beside the default 128 x
# 128 at 4 heads, on the main fill's inputs: K2, K2-bf16 and K4 at each
# but (128, 128, 16), which runs K4 alone (the first is the single
# override model.hidden_dim=256, the reference's own interpolated width;
# the last two the override model.hidden_dim=64 and the tests/tiny.py
# widths)
NODE_WIDTHS = ((256, 128, 4), (256, 256, 4), (128, 128, 2), (128, 128, 16), (256, 128, 2), (128, 128, 1),
               (64, 128, 4), (64, 64, 2))


def check_node_widths(dev, batch) -> dict:
    """K2, K2-bf16, K4f and K4b at NODE_WIDTHS on [8 x 1024, 20, d_model]
    inputs with the batch's node validity, each width its own draw: K2
    against its plain version at K2_TOL, K2-bf16 within its one-ulp nudge's
    gap, K4 at K4_TOL and K4_GRAD_RTOL (and against fp64, as the default
    width's usual draw), each timed beside its plain version and its bound,
    K4b's peak memory printed."""
    out = {}
    for i, widths in enumerate(NODE_WIDTHS):
        name = "x".join(map(str, widths))
        gen = torch.Generator().manual_seed(300 + i)
        r = out[name] = {}
        if widths[2] != 16:
            case = node_encoder_case(gen, dev, batch, widths)
            r["K2"] = k2_reading(*case, N_SCENE)
            r["K2-bf16"] = k2_bf16_reading(*case)
            del case
        *case, usual = k4_case(gen, dev, batch, f"widths {name}", True, widths, tie_tol=K4_TOL)
        r["K4f"], r["K4b"] = k4_reading(*case, usual, N_SCENE)
        r["K4b"]["draws"] = [usual]
        del case
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ main path


def nudged(batch):
    """The batch with every map position moved by one ulp."""
    return dict(batch, **{"map/pos": np.nextafter(batch["map/pos"], np.float32(np.inf))})


def first_step_over(diff: torch.Tensor) -> dict:
    """For each threshold, the first step whose max |diff| exceeds it (None
    if none does); diff [B, A, S, 4]."""
    per_step = diff.amax(dim=(0, 1, 3)).tolist()
    return {str(t): next((s for s, e in enumerate(per_step) if e > t), None) for t in READING_THRESHOLDS}


def compare_rollouts(out, ref, ref_nudged, what, hold: bool = True, held_steps: int = HELD_STEPS) -> dict:
    """Holds preds over the first `held_steps` to ROLLOUT_ATOL and validity
    equal there (with `hold`; else they are readings too); returns the
    whole horizon's readings beside the one-ulp map nudge's (None without
    `ref_nudged`)."""
    for o in (out, ref):
        require(bool(torch.isfinite(o.preds).all()), f"{what}: non-finite preds")
    r = ref.preds.float().cpu()
    diff = (out.preds.float().cpu() - r).abs()
    diff_nudge = None if ref_nudged is None else (ref_nudged.preds.float().cpu() - r).abs()
    held = diff[:, :, :held_steps].max().item()
    flips = out.valid.cpu() != ref.valid.cpu()
    held_flips = flips[:, :, :held_steps].sum().item()
    reading = dict(
        preds_err_held=held, held_steps=held_steps, preds_err_all=diff.max().item(),
        nudge_err_all=None if diff_nudge is None else diff_nudge.max().item(), valid_flips_all=flips.sum().item(),
        first_step_over=first_step_over(diff),
        nudge_first_step_over=None if diff_nudge is None else first_step_over(diff_nudge),
    )
    log(f"{what}: preds max abs diff over the first {held_steps} steps {held} m (tolerance {ROLLOUT_ATOL} m), "
        f"valid flips there {held_flips}; readings over all {r.shape[2]} steps: preds {reading['preds_err_all']} m, "
        f"first step over each threshold (m) {reading['first_step_over']}, valid flips {reading['valid_flips_all']}; "
        f"a one-ulp map nudge moves the reference {reading['nudge_err_all']} m, first step over each threshold "
        f"{reading['nudge_first_step_over']}")
    if hold:
        require(held <= ROLLOUT_ATOL, f"{what}: preds differ by {held} m > {ROLLOUT_ATOL} m in the first {held_steps} steps")
        require(held_flips == 0, f"{what}: validity differs in the first {held_steps} steps")
    return reading


def profile_run(run, wall_s, what):
    """One run() under torch.profiler: the device's busy time (the sum of its
    kernels and copies, one stream), the number of device operations, the
    host's syncs with the device (CUDA runtime calls), and the top kernels
    by device time. Only the CUDA activity is traced: none of these needs
    the host's operator events, which made up most of a training step's
    ~10^6 events and of the profile's cost. The profiler's raw events are
    read as they are (building its event tree takes minutes); the seconds
    the profiled run and the reading took are printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    ops_ = [(e.name(), e.duration_ns() / 1e6) for e in events
            if e.device_type() == DeviceType.CUDA and not getattr(e, "is_hidden_event", lambda: False)()]
    syncs = sum(1 for e in events if e.name() in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    cost_s = time.perf_counter() - t0
    if not ops_:
        log("profile: the profiler saw no device operations; device busy share not measured")
        return None
    busy_ms = sum(t for _, t in ops_)
    by_name = {}
    for name, t in ops_:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + t, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    # host waits on the device: explicit syncs (copies that block the host
    # are not counted)
    log(f"profile: {len(ops_)} device operations {what}, device busy {busy_ms} ms of the unprofiled "
        f"{1e3 * wall_s} ms wall ({busy_ms / (1e3 * wall_s)} busy share), {syncs} host syncs (profiled run and "
        f"reading {cost_s} s)")
    for name, (t, n) in top:
        log(f"profile:   {t:10.3f} ms  {n:6d}x  {name[:110]}")
    return dict(device_ops=len(ops_), busy_ms=busy_ms, busy_share=busy_ms / (1e3 * wall_s), host_syncs=syncs,
                top=[dict(name=name[:110], ms=t, count=n) for name, (t, n) in top], profile_s=cost_s)


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


def zero_counts(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters):
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


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
    counters = dict(TRAIN_COUNTERS, **K3_SKIP_COUNTERS)  # every K3 site takes its rows' padding mask: K3-skip
    for i in range(n_iter):
        zero_counts(counters)
        t0 = time.perf_counter()
        m = step(batch, seed=101 + i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(read_counts(counters))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        log(f"train step {i}: {secs[-1]} s, loss {losses[-1]}, grad_norm {norms[-1]}, launches {per_step[-1]}")
        require(math.isfinite(losses[-1]) and math.isfinite(norms[-1]) and norms[-1] > 0, "non-finite loss or grad norm")
        for k, n in per_step[-1].items():
            require(n > 0, f"the training step did not launch {k}")
        require(per_step[-1]["K3f-skip"] == per_step[-1]["K3f"] and per_step[-1]["K3b-skip"] == per_step[-1]["K3b"],
                "a training K3 launch did not carry src_invalid")
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
    seeds, held over time_step_end = HELD_STEPS, beside a one-ulp map nudge
    of the plain run."""
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
        zero_counts(VAL_COUNTERS)
        t0 = time.perf_counter()
        val.step(batch, torch.Generator().manual_seed(301 + i))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(read_counts(VAL_COUNTERS))
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
                             metrics={k: metrics[k] for k in keep},
                             metric_keys=sorted(k for k in metrics if k.startswith(WOMD_PREFIXES)))


def _futures(out, ks):
    """The joint futures ks of a validation step's output, agents and
    futures flattened ([B, A * len(ks), S, ...]), for compare_rollouts."""
    p, v = out["buf_jf_preds"][:, :, ks], out["buf_jf_valid"][:, :, ks]
    return SimpleNamespace(preds=p.reshape(p.shape[0], -1, *p.shape[3:]), valid=v.reshape(v.shape[0], -1, v.shape[-1]))


def validation_vs_plain(cfg, batch, dev, held_steps: int = HELD_STEPS):
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
        reactive_replay=compare_rollouts(*rr, "validation reactive replay, kernels vs plain versions",
                                         held_steps=held_steps),
        joint_future_k0=compare_rollouts(*k0, "validation joint future K=0, kernels vs plain versions",
                                         held_steps=held_steps),
        joint_futures_sampled=compare_rollouts(*kn, "validation joint futures K>0 (readings), kernels vs plain",
                                               hold=False),
        goal_sample_flips=goal_flips, device_step_s=secs,
    )


# ------------------------------------------------------------------ validation media

MEDIA_COUNTERS = {"K1": (FA, "LAUNCHES"), "K2": (NE, "LAUNCHES")}
ATTN_SUM_ATOL = 1e-5  # a valid agent-step's attn_pl row: its sum over the valid targets
# the collected weights, kernels vs plain versions, over HELD_STEPS: on an
# H100 at full width attn_tl's gap read 7.6e-5 and attn_agent's 2.7e-5 (the
# closed loop's drift); attn_pl's 3.2e-6, beside a one-ulp map nudge's 6.5e-6
ATTN_ATOL = {"attn_pl": 1e-5, "attn_tl": 1e-4, "attn_agent": 1e-4}
MEDIA_NAMES = ("reactive_replay", *(f"joint_future_K{k}" for k in range(6)), "attn_pl")


def collecting_replay(cfg, model, batch, dev, collect, plain=False):
    """eval_rollout's path with or without attention collection (the media's
    replay), K1 and K2 counted over the encode and over the loop apart.
    -> (the rollout, {"encode": counts, "loop": counts}, map validity [B, P])."""
    with ops.plain_versions() if plain else contextlib.nullcontext(), torch.no_grad():
        zero_counts(MEDIA_COUNTERS)
        pb = pre_processing(to_torch(batch, dev), cfg.model, training=False)
        feats = O.encode_episode_features(model, pb, views=("input", "latent_post"))
        goal, goal_valid = O.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
        latent = model.latent(posterior=True, **feats["latent_post"])
        mask_tf = teacher_forcing_mask(O.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])
        torch.cuda.synchronize()
        counts = {"encode": read_counts(MEDIA_COUNTERS)}
        zero_counts(MEDIA_COUNTERS)
        out = O.reactive_replay(cfg, model, pb, feats["input"], latent, goal, goal_valid, mask_tf,
                                collect_attention=collect)
        torch.cuda.synchronize()
        counts["loop"] = read_counts(MEDIA_COUNTERS)
    return out, counts, feats["input"]["map_feature_valid"]


def check_attention_rows(out, map_valid) -> dict:
    """Every valid agent-step's attn_pl row sums to 1 over the valid map
    targets and is 0 on the invalid ones; an invalid agent-step's row is 0."""
    w = out.attn["attn_pl"]  # [B, A, S, P]
    valid = out.valid  # the validity each step's policy saw
    sums = w.sum(-1)
    row_err = (sums - 1).abs()[valid].max().item()
    on_invalid_targets = w.masked_select(~map_valid[:, None, None, :]).abs().max().item()
    on_invalid_agents = w[~valid].abs().max().item() if bool((~valid).any()) else 0.0
    log(f"media: attn_pl {tuple(w.shape)}: valid rows' sums within {row_err} of 1 (tolerance {ATTN_SUM_ATOL}), "
        f"largest weight on an invalid target {on_invalid_targets}, on an invalid agent-step {on_invalid_agents}")
    require(bool(torch.isfinite(w).all()), "media: non-finite attention weights")
    require(row_err <= ATTN_SUM_ATOL, f"media: a valid attn_pl row sums to 1 +- {row_err}")
    require(on_invalid_targets == 0.0 and on_invalid_agents == 0.0, "media: weight on an invalid target or agent")
    return dict(shape=list(w.shape), mb=w.numel() * w.element_size() / 1e6, valid_rows=int(valid.sum().item()),
                row_sum_err=row_err)


def media_render() -> dict:
    """run.py validate's media at full width for one scene over 31 steps
    (CLI_MEDIA_ARGS; random weights from the run's seed): with cv2 the JAX
    package's file names under run_dir/videos, each non-empty; without cv2
    no `videos` directory."""
    import tempfile

    from trafficbots_tpu_torch import run as RUN

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tb_media_") as run_dir:
        RUN.main(["action=validate", f"run_dir={run_dir}"] + CLI_ARGS + CLI_MEDIA_ARGS)
        videos = os.path.join(run_dir, "videos")
        files = sorted(os.listdir(videos)) if os.path.exists(videos) else []
        sizes = [os.path.getsize(os.path.join(videos, f)) for f in files]
    seconds = time.perf_counter() - t0
    want = sorted(media_files(["0-0"])) if VIS._HAS_CV2 else []
    require(files == want and all(sizes), f"media: validate wrote {files}, expected {want}")
    log(f"media: run.py validate with cv2 {'present' if VIS._HAS_CV2 else 'absent'} wrote {len(files)} media files "
        f"of one scene over 31 steps in {seconds} s")
    return dict(cv2=VIS._HAS_CV2, files=files, seconds=seconds)


def media_path(cfg, batch, dev):
    """The validation media's device side at full width: the collecting
    replay against the non-collecting kernel replay and against the plain
    versions (held over HELD_STEPS), its attention rows, 0 K1 launches in
    its loop; `evaluation_loop._vis_device_step` timed with its launch
    counts and peak memory; run.py validate's render with (or without) cv2."""
    t_phase = time.perf_counter()
    model = O.make_model(cfg, device=dev, seed=0)
    plain_out, counts_n, _ = collecting_replay(cfg, model, batch, dev, collect=False)
    nudged_out, _, _ = collecting_replay(cfg, model, nudged(batch), dev, collect=False)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, counts_c, map_valid = collecting_replay(cfg, model, batch, dev, collect=True)
    replay_peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    ref, _, _ = collecting_replay(cfg, model, batch, dev, collect=True, plain=True)
    log(f"media: K1/K2 launches, encode then loop: collecting {counts_c}, non-collecting {counts_n}")
    require(counts_c["loop"]["K1"] == 0, f"media: the collecting replay's loop launched K1 {counts_c['loop']['K1']} times")
    require(counts_n["loop"]["K1"] > 0 and counts_c["encode"]["K1"] > 0 and counts_c["encode"]["K2"] == 1,
            f"media: launches {counts_c} / {counts_n}")
    vs_replay = compare_rollouts(out, plain_out, nudged_out, "media: collecting replay vs the non-collecting kernel replay")
    vs_plain = compare_rollouts(out, ref, None, "media: collecting replay, kernels vs plain versions")
    del plain_out, nudged_out
    nudged_c, _, _ = collecting_replay(cfg, model, nudged(batch), dev, collect=True)
    attn_gap = {k: (out.attn[k] - ref.attn[k])[:, :, :HELD_STEPS].abs().max().item() for k in out.attn}
    nudge_gap = (out.attn["attn_pl"] - nudged_c.attn["attn_pl"])[:, :, :HELD_STEPS].abs().max().item()
    log(f"media: collected weights, kernels vs plain versions, largest gap over the first {HELD_STEPS} steps "
        f"{attn_gap} (tolerance {ATTN_ATOL}); attn_pl with a one-ulp map nudge {nudge_gap}")
    for k, gap in attn_gap.items():
        require(gap <= ATTN_ATOL[k], f"media: {k} kernels vs plain differ by {gap}")
    attn = dict(check_attention_rows(out, map_valid), kernels_vs_plain=attn_gap, attn_pl_nudge=nudge_gap)
    del out, ref, nudged_c

    tb = to_torch(batch, dev)
    zero_counts(MEDIA_COUNTERS)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    buf, dest_probs, buf_jf, jf_scores = EL._vis_device_step(cfg, model, tb, torch.Generator().manual_seed(600))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts = read_counts(MEDIA_COUNTERS)
    step_peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    n_scene, n_agent = batch["agent/valid"].shape[0], cfg.data.n_agent
    require(buf.attn["attn_pl"].shape[:3] == buf.valid.shape and buf_jf.preds.shape[:3] == (n_scene, n_agent, 6),
            "media: the vis step's shapes")
    require(dest_probs is not None and bool(torch.isfinite(dest_probs).all()), "media: destination probabilities")
    require(bool(torch.isfinite(jf_scores).all()) and bool(torch.isfinite(buf_jf.preds).all()), "media: joint futures")
    require(step_counts["K1"] > 0 and step_counts["K2"] == 1, f"media: the vis step's launches {step_counts}")
    log(f"media: _vis_device_step {step_s} s, launches {step_counts}, peak device memory above the model "
        f"{step_peak_gib} GiB (the collecting replay alone {replay_peak_gib} GiB) [{card_line()}]")
    del buf, dest_probs, buf_jf, jf_scores, model
    render = media_render()
    result = dict(vs_replay=vs_replay, vs_plain=vs_plain, attn_pl=attn, launches_replay=counts_c,
                  launches_plain_replay=counts_n, vis_step_s=step_s, vis_step_launches=step_counts,
                  vis_step_peak_gib=step_peak_gib, replay_peak_gib=replay_peak_gib, render=render,
                  phase_s=time.perf_counter() - t_phase, card=card_line())
    log(f"media: phase in {result['phase_s']} s")
    return result


# ------------------------------------------------------------------ training-input augmentations

AUG_DROPOUT_P = 0.2  # history dropout's rate in the augmented step (JAX's default is off, -1)


def augment_path(cfg, batch, dev):
    """One training step (loss and gradients, over time_step_end =
    HELD_STEPS) with history dropout and the latent-input perturbation:
    kernels against the plain versions (as train_vs_plain holds them), the
    map encoded once a view (K4f = K4b = 3), its seconds beside the default
    step's in this call."""
    t_phase = time.perf_counter()
    held = dataclasses.replace(cfg, time_step_end=HELD_STEPS)
    aug = dataclasses.replace(held, model=dataclasses.replace(
        held.model, dropout_p_history=AUG_DROPOUT_P, perturb_input_to_latent=True))

    def timed(c, plain):
        zero_counts(TRAIN_COUNTERS)
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(c, batch, dev, plain)
        return loss, grads, time.perf_counter() - t0, read_counts(TRAIN_COUNTERS)

    _, _, first_s, _ = timed(held, False)  # warm-up (the first training step of the process in --augment)
    lk, gk, aug_s, counts = timed(aug, False)
    ld, _, default_s, default_counts = timed(held, False)
    lp, gp, plain_s, _ = timed(aug, True)
    loss_gap = abs(lk - lp) / abs(lp)
    gap, worst, median = grad_gap(gk, gp)
    log(f"augment: launches in the augmented step {counts}, in the default step {default_counts}")
    log(f"augment: training step over steps 1..{HELD_STEPS} (forward and backward, no update): augmented {aug_s} s, "
        f"default {default_s} s (the first call {first_s} s), augmented with the plain versions {plain_s} s "
        f"[{card_line()}]")
    log(f"augment: kernels vs plain versions: loss {lk} vs {lp} (rel {loss_gap}, tolerance {TRAIN_LOSS_RTOL}; the "
        f"default step's {ld}), largest gradient rel norm error {gap} at {worst}, median {median} (tolerance "
        f"{TRAIN_GRAD_RTOL})")
    require(counts["K4f"] == counts["K4b"] == 3, f"augment: K4f / K4b launched {counts['K4f']} / {counts['K4b']} times")
    require(default_counts["K4f"] == default_counts["K4b"] == 1, f"augment: the default step's K4 {default_counts}")
    require(all(counts[k] > 0 for k in ("K3f", "K3b", "K5")), f"augment: launches {counts}")
    require(math.isfinite(lk) and lk != ld, f"augment: loss {lk} (default {ld})")
    require(loss_gap <= TRAIN_LOSS_RTOL, f"augment: loss differs by rel {loss_gap}")
    require(gap <= TRAIN_GRAD_RTOL, f"augment: gradient {worst} differs by rel {gap}")
    result = dict(launches=counts, default_launches=default_counts, aug_step_s=aug_s, default_step_s=default_s,
                  first_step_s=first_s, plain_step_s=plain_s, loss=lk, default_loss=ld, loss_rel=loss_gap,
                  grad_rel=gap, grad_rel_median=median, held_steps=HELD_STEPS,
                  phase_s=time.perf_counter() - t_phase, card=card_line())
    log(f"augment: phase in {result['phase_s']} s")
    return result


# ------------------------------------------------------------------ bf16 (precision="bf16", kernel_matmul_bf16)

BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
BF16_COUNTERS = {"K1": (FA, "LAUNCHES"), "K1-bf16": (FA, "LAUNCHES_BF16"), "K2": (NE, "LAUNCHES"),
                 "K2-bf16": (NE, "LAUNCHES_BF16"), "K6": (BA, "LAUNCHES"), "K6-bf16": (BA, "LAUNCHES_BF16")}


def bf16_config(cfg: ExperimentConfig, matmul_bf16: bool) -> ExperimentConfig:
    me = dataclasses.replace(cfg.model.map_encoder, kernel_matmul_bf16=matmul_bf16)
    return dataclasses.replace(cfg, precision="bf16", model=dataclasses.replace(cfg.model, map_encoder=me))


def bound_ms_bf16(n_bytes: float, n_bf16_flop: float):
    """The bound of a bf16 variant: its bytes at 3.35 TB/s or its products
    (every one on bf16 operands) at 989 TFLOP/s, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_bf16_flop / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bf16_up(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 and moved one bf16 ulp up in magnitude (the one-ulp
    input nudge that sets the bf16 variants' limits), in t's dtype."""
    return (t.to(torch.bfloat16).view(torch.int16) + 1).view(torch.bfloat16).to(t.dtype)


def gap_stats(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The largest gap relative to the output's largest magnitude, the
    relative norm gap, the count of elements that differ, the max abs gap."""
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    return dict(max_rel_to_max=(d.max() / r.abs().max()).item(), rel_norm=((o - r).norm() / r.norm()).item(),
                n_differ=int((o != r).sum().item()), n=o.numel(), max_abs=d.max().item())


def bf16_held(name: str, out, ref, ref_nudged) -> dict:
    """A bf16 variant against its plain version: its relative norm gap held
    within the gap that a one-bf16-ulp nudge of the input makes in the plain
    version (measured on the same inputs, in this run)."""
    gap, nudge = gap_stats(out, ref), gap_stats(ref_nudged, ref)
    require(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    require(gap["rel_norm"] <= nudge["rel_norm"], f"{name}: kernel vs plain rel norm {gap['rel_norm']} > the one-ulp "
                                                  f"nudge's {nudge['rel_norm']}")
    log(f"{name}: kernel vs plain: max gap / max |out| {gap['max_rel_to_max']}, rel norm {gap['rel_norm']}, "
        f"{gap['n_differ']} of {gap['n']} elements differ (max abs {gap['max_abs']}); a one-bf16-ulp input nudge "
        f"of the plain version: rel norm {nudge['rel_norm']} (the limit), {nudge['n_differ']} elements differ")
    return dict(vs_plain=gap, nudge=nudge)


# the tensor-core kernels and the fp32 ones of the K1, K2 and K6 libraries,
# by a piece of their mangled names
SASS_KERNELS = {"K1-bf16": ("12fwd_rows_mma", "17fwd_rows_mma_slab", "17fwd_rows_mma_long", "15fwd_cluster_mma"),
                "K2-bf16": ("node_kernelILb1E",),
                "K6-bf16": ("14block_attn_mma",), "K1": ("8fwd_rows", "11fwd_cluster"), "K2": ("node_kernelILb0E",),
                "K6": ("17block_attn_kernel",)}


def sass_hmma_counts() -> dict:
    """The HMMA (tensor-core MMA) instructions of each kernel in the built
    K1, K2 and K6 libraries (`cuobjdump -sass`): every kernel of K1-bf16,
    K2-bf16 and K6-bf16 must hold some, fp32 K1's, K2's and K6's none."""
    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    counts = {}
    for lib in ("fused_attention", "node_encoder", "block_attn"):
        sass = subprocess.run([str(tool), "-sass", str(cuda_build._target(lib))], check=True, capture_output=True,
                              text=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function : " in line:
                fn = line.split("Function : ", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
    by_kind = {kind: {fn: n for fn, n in counts.items() if any(m in fn for m in marks)}
               for kind, marks in SASS_KERNELS.items()}
    log(f"SASS HMMA instructions by kernel: {by_kind}")
    for kind, fns in by_kind.items():
        tensor_cores = kind.endswith("bf16")
        require(bool(fns) and all((n > 0) == tensor_cores for n in fns.values()),
                f"{kind}: HMMA counts {fns} (tensor cores expected: {tensor_cores})")
    return by_kind


def check_k1_bf16(dev):
    """K1's bf16 variant at the main path's four sites under
    precision="bf16" (bf16 q, k, v), against its plain version, two calls
    bitwise equal; its times beside K1's (fp32 q, bf16 K/V) and SDPA's on
    the bf16 q/k/v with the same mask. The kernels-line entry is the
    rollout as2pl's (270 launches a rollout)."""
    gen = torch.Generator().manual_seed(16)
    entry, per_site = None, []
    for name, B, S, T in (("rollout as2pl", N_SCENE, 64, 1024), (K1_B48, N_SCENE * 6, 64, 1024),
                          ("map polyline self-attention", N_SCENE, 1024, 1024), ("latent as2pl", N_SCENE, 19 * 64, 1024)):
        # the joint futures' site draws from a generator of its own, so that
        # the other sites' inputs stay what the shared one gave them before
        site_gen = torch.Generator().manual_seed(1648) if name == K1_B48 else gen
        (q32, k, v, invalid, H), mask_bytes = k1_case(site_gen, B, S, T, True, 0.25, False, dev)
        args = (q32.bfloat16(), k, v, invalid, H)
        out = FA.fused_attention_core(*args)
        again = FA.fused_attention_core(*args)
        torch.cuda.synchronize()
        require(out.dtype == torch.bfloat16 and torch.equal(out, again), f"K1-bf16 {name}: not bitwise reproducible")
        held = bf16_held(f"K1-bf16 {name}", out, FA.attention_core_plain(*args),
                         FA.attention_core_plain(bf16_up(args[0]), k, v, invalid, H))
        ms = time_ms(lambda: FA.fused_attention_core(*args))
        dev_ms = graph_ms(lambda: FA.fused_attention_core(*args))
        fp32_ms = time_ms(lambda: FA.fused_attention_core(q32, k, v, invalid, H))
        fp32_dev = graph_ms(lambda: FA.fused_attention_core(q32, k, v, invalid, H))
        plain_ms = time_ms(lambda: FA.attention_core_plain(*args))
        lib = sdpa_call((q32, k, v, invalid, H))  # fp32 SDPA (K/V widened) beside SDPA on the bf16 q/k/v
        qh, kh, vh = (t.view(t.shape[0], t.shape[1], H, -1).transpose(1, 2) for t in args[:3])
        lib16 = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=(~invalid)[:, None])
        lib_ms, lib_dev = time_ms(lib16), graph_ms(lib16)
        n_bytes = 2 * q32.numel() * 2 + 2 * k.numel() * 2 + mask_bytes
        b_ms, b_by = bound_ms_bf16(n_bytes, 4 * q32.shape[-1] * int((~invalid).sum().item()))
        log(f"K1-bf16 {name}: B={B} S={S} T={T} ms={ms} device_ms={dev_ms} (fp32 K1 on fp32 q: ms={fp32_ms} "
            f"device_ms={fp32_dev}) plain_ms={plain_ms} library_ms={lib_ms} library_device_ms={lib_dev} (SDPA bf16; "
            f"fp32 SDPA ms={time_ms(lib)}) bound_ms={b_ms} ({b_by}) [{card_line()}]")
        site = dict(site=name, ms=ms, device_ms=dev_ms, fp32_ms=fp32_ms, fp32_device_ms=fp32_dev, plain_ms=plain_ms,
                    library_ms=lib_ms, library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by, **held)
        per_site.append(site)
        if entry is None:
            entry = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         library_device_ms=lib_dev, shape=f"B={B} S={S} T={T} D=128 H=4 bf16 q/k/v, {name}")
    entry["max_abs_err"] = max(s["vs_plain"]["max_abs"] for s in per_site)
    entry["sites"] = per_site
    return entry


def check_k2_bf16(dev, batch):
    """K2's bf16 variant on phase 3's K2 shapes (its own draw of inputs):
    against its plain version over the live polylines, its times beside
    K2's on the same inputs."""
    return k2_bf16_reading(*node_encoder_case(torch.Generator().manual_seed(17), dev, batch))


def k2_bf16_reading(enc, x, valid):
    """K2-bf16 held within the gap a one-bf16-ulp input nudge makes in its
    plain version, timed beside fp32 K2, its bound."""
    what = f"K2-bf16 ({node_widths(enc)})"
    live = valid.any(dim=-1)
    with torch.no_grad():
        out = enc.encode_pooled(x, valid, bf16=True)
        torch.cuda.synchronize()
        ref = enc.pooled_plain(x, valid, bf16=True)
        ref_n = enc.pooled_plain(torch.where(valid[..., None], bf16_up(x), x), valid, bf16=True)
        held = bf16_held(what, out[live], ref[live], ref_n[live])
        require(bool((out[~live] == NE.NEG).all()), f"{what}: a polyline without a valid node must pool to -1e30")
        ms = time_ms(lambda: enc.encode_pooled(x, valid, bf16=True), n=10)
        dev_ms = graph_ms(lambda: enc.encode_pooled(x, valid, bf16=True), n=5)
        fp32_ms = time_ms(lambda: enc.encode_pooled(x, valid), n=10)
        fp32_dev = graph_ms(lambda: enc.encode_pooled(x, valid), n=5)
        plain_ms = time_ms(lambda: enc.pooled_plain(x, valid, bf16=True), n=5)
    D = enc.d_model
    n_bytes = x.numel() * 4 + valid.numel() + sum(getattr(enc, n).numel() * 4 for n in NE.W_NAMES) + x.shape[0] * D * 4
    b_ms, b_by = bound_ms_bf16(n_bytes, node_flop(enc, valid))
    log(f"{what} node encoder + pool: BP={x.shape[0]} N={x.shape[1]} ms={ms} device_ms={dev_ms} (fp32 K2: ms={fp32_ms} "
        f"device_ms={fp32_dev}) plain_ms={plain_ms} library_ms=None bound_ms={b_ms} ({b_by}) out sha1={digest(out)} "
        f"[{card_line()}]")
    return dict(ms=ms, device_ms=dev_ms, fp32_ms=fp32_ms, fp32_device_ms=fp32_dev, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, max_abs_err=held["vs_plain"]["max_abs"], **held,
                out_sha1=digest(out),
                shape=f"BP={x.shape[0]} N={x.shape[1]} {node_widths(enc)}, {N_SCENE} scenes at 768/1024 fill")


def check_k6_bf16(dev, batch):
    """K6's bf16 variant on phase 3's K6 shapes (its own draw): against its
    plain version over the live rows, its times beside K6's and SDPA's on
    bf16 q/k/v with the same mask."""
    H = 4
    gen = torch.Generator().manual_seed(18)
    _, x, valid = node_encoder_case(gen, dev, batch)
    BP, N, D = x.shape
    q, k, v = (torch.randn(BP, N, D, generator=gen).to(dev) for _ in range(3))
    live = valid.any(dim=-1)
    out = BA.block_attn_core(q, k, v, valid, H, bf16=True)
    torch.cuda.synchronize()
    held = bf16_held("K6-bf16", out[live], BA.block_attn_core_plain(q, k, v, valid, H, bf16=True)[live],
                     BA.block_attn_core_plain(bf16_up(q), k, v, valid, H, bf16=True)[live])
    ms = time_ms(lambda: BA.block_attn_core(q, k, v, valid, H, bf16=True))
    dev_ms = graph_ms(lambda: BA.block_attn_core(q, k, v, valid, H, bf16=True))
    fp32_ms = time_ms(lambda: BA.block_attn_core(q, k, v, valid, H))
    fp32_dev = graph_ms(lambda: BA.block_attn_core(q, k, v, valid, H))
    plain_ms = time_ms(lambda: BA.block_attn_core_plain(q, k, v, valid, H, bf16=True), n=5)
    lib = k6_sdpa_call(q.bfloat16(), k.bfloat16(), v.bfloat16(), valid, H)
    lib_ms, lib_dev = time_ms(lib), graph_ms(lib)
    n_valid = valid.sum(dim=-1)
    pairs = int((N * torch.where(n_valid > 0, n_valid, torch.full_like(n_valid, N))).sum().item())
    b_ms, b_by = bound_ms_bf16(4 * q.numel() * 4 + valid.numel(), 4 * D * pairs)
    log(f"K6-bf16 block attention core: BP={BP} N={N} D={D} H={H} ms={ms} device_ms={dev_ms} (fp32 K6: ms={fp32_ms} "
        f"device_ms={fp32_dev}) plain_ms={plain_ms} library_ms={lib_ms} library_device_ms={lib_dev} (SDPA bf16) "
        f"bound_ms={b_ms} ({b_by}) [{card_line()}]")
    return dict(ms=ms, device_ms=dev_ms, fp32_ms=fp32_ms, fp32_device_ms=fp32_dev, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev, max_abs_err=held["vs_plain"]["max_abs"],
                **held, shape=f"BP={BP} N={N} D=128 H=4, {N_SCENE} scenes at 768/1024 fill")


# bf16 rollouts, kernels vs plain: the passage slack in steps. Under bf16
# the kernels-vs-plain gap and a one-ulp map nudge's are both a first bf16
# rounding flip at step 0 (on the H100 at full width: 1.5e-3 m and ~1e-3 m
# at steps 0-1), and from there they grow together (1e-2 m at steps 12-13
# and 1e-1 m at 20-21 on both sides), so the hold compares when the two
# gaps pass 1e-2 m and 1e-1 m.
BF16_PASSAGE_SLACK = 2


def held_beside_nudge(out, ref, ref_nudged, what) -> dict:
    """Kernels vs plain under bf16, beside a one-ulp map nudge of the plain
    run: validity equal over the steps before the nudge's validity first
    differs, and the kernels-vs-plain gap passing 10 x and 100 x
    ROLLOUT_ATOL no more than BF16_PASSAGE_SLACK steps before the nudge's
    does; the preds over the steps before the nudge passes ROLLOUT_ATOL
    (none or one step under bf16) are a reading."""
    reading = compare_rollouts(out, ref, ref_nudged, what, hold=False)
    r = ref.preds.float().cpu()
    diff = (out.preds.float().cpu() - r).abs()
    first_n = reading["nudge_first_step_over"][str(ROLLOUT_ATOL)]
    steps = diff.shape[2] if first_n is None else first_n
    flips_n = (ref_nudged.valid.cpu() != ref.valid.cpu()).flatten(0, 1).any(dim=0)
    vsteps = int(flips_n.float().argmax().item()) if bool(flips_n.any()) else diff.shape[2]
    flips = int((out.valid.cpu() != ref.valid.cpu())[:, :, :vsteps].sum().item())
    passage = {}
    for t in (10 * ROLLOUT_ATOL, 100 * ROLLOUT_ATOL):
        k, n = reading["first_step_over"][str(t)], reading["nudge_first_step_over"][str(t)]
        passage[str(t)] = (k, n)
        require(k is None or (n is not None and k >= n - BF16_PASSAGE_SLACK),
                f"{what}: the kernels-vs-plain gap passes {t} m at step {k}, more than {BF16_PASSAGE_SLACK} steps "
                f"before the one-ulp nudge's ({n})")
    require(flips == 0, f"{what}: validity differs in the first {vsteps} steps")
    log(f"{what}: validity flips over the {vsteps} steps before the nudge's first: {flips}; first step over "
        f"(kernels vs plain, nudge): {passage}; preds over the {steps} steps before the nudge passes "
        f"{ROLLOUT_ATOL} m (a reading): {diff[:, :, :steps].max().item() if steps else None} m")
    reading.update(nudge_steps_under_atol=steps, valid_held_steps=vsteps, passage=passage)
    return reading


def eval_bf16(cfg, batch, dev, matmul_bf16: bool, n_iter: int) -> dict:
    """The eval rollout under precision="bf16" (and kernel_matmul_bf16 or
    not): the launch counts of one rollout (every K1 site on the bf16
    variant, the node pool on K2 or its bf16 variant), n_iter timed runs,
    peak memory, and the rollout against the plain versions beside a
    one-ulp map nudge (held_beside_nudge)."""
    c16 = bf16_config(cfg, matmul_bf16)
    n_scene = batch["map/valid"].shape[0]
    model = O.make_model(c16, device=dev, seed=0)
    O.eval_rollout(c16, model, batch, device=dev)
    torch.cuda.synchronize()
    zero_counts(BF16_COUNTERS)
    torch.cuda.reset_peak_memory_stats()
    out = O.eval_rollout(c16, model, batch, device=dev)
    torch.cuda.synchronize()
    launches = read_counts(BF16_COUNTERS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    what = f"bf16 eval rollout ({'with' if matmul_bf16 else 'without'} kernel_matmul_bf16)"
    log(f"{what}: launches {launches}")
    node = ("K2-bf16", "K2") if matmul_bf16 else ("K2", "K2-bf16")
    require(launches["K1-bf16"] > 0 and launches["K1"] == 0 and launches[node[0]] == 1 and launches[node[1]] == 0,
            f"{what}: launches {launches}")
    secs = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        O.eval_rollout(c16, model, batch, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    n_steps = c16.time_step_end - c16.time_step_sim_start + 1
    asps = n_scene * c16.data.n_agent * n_steps / statistics.median(secs) if secs else None
    with ops.plain_versions():
        ref = O.eval_rollout(c16, model, batch, device=dev)
        ref_n = O.eval_rollout(c16, model, nudged(batch), device=dev)
    held = held_beside_nudge(out, ref, ref_n, f"{what}, kernels vs plain versions")
    log(f"{what}: seconds {secs}, {asps} agent-steps/s, peak device memory {peak_gib} GiB [{card_line()}]")
    return dict(launches=launches, seconds=secs, agent_steps_per_s=asps, peak_gib=peak_gib, vs_plain=held)


def fp32_eval_reading(cfg, batch, dev, n_iter: int) -> dict:
    """The fp32 eval rollout's agent-steps/s and peak memory, beside bf16's."""
    n_scene = batch["map/valid"].shape[0]
    model = O.make_model(cfg, device=dev, seed=0)
    O.eval_rollout(cfg, model, batch, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        O.eval_rollout(cfg, model, batch, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    n_steps = cfg.time_step_end - cfg.time_step_sim_start + 1
    return dict(seconds=secs, agent_steps_per_s=n_scene * cfg.data.n_agent * n_steps / statistics.median(secs),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def validation_bf16(cfg, batch, dev) -> dict:
    """One Validator.step under precision="bf16", "hybrid" and
    kernel_matmul_bf16 (K6's and K1's bf16 variants, no fp32 K1/K2/K6),
    epoch_end finite; then one validation step kernels vs plain, the
    reactive replay and the K = 0 future held as the eval rollout."""
    c16 = hybrid_config(bf16_config(cfg, True))
    model = O.make_model(c16, device=dev, seed=0)
    val = EL.Validator(c16, model, device=dev)
    zero_counts(BF16_COUNTERS)
    t0 = time.perf_counter()
    val.step(batch, torch.Generator().manual_seed(301))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = read_counts(BF16_COUNTERS)
    log(f"bf16 validation step ({step_s} s, the model's first): launches {launches}")
    require(launches["K6-bf16"] > 0 and launches["K1-bf16"] > 0 and launches["K1"] == launches["K2"] == launches["K6"]
            == launches["K2-bf16"] == 0, f"bf16 validation step: launches {launches}")
    metrics = val.epoch_end()
    require(math.isfinite(metrics["val/loss"]), f"bf16 validation: val/loss {metrics['val/loss']}")

    def run(b, plain):
        with ops.plain_versions() if plain else contextlib.nullcontext():
            out = EL.validation_device_step(c16, model, to_torch(b, dev), torch.Generator().manual_seed(500))
        torch.cuda.synchronize()
        return out

    out, ref, ref_n = run(batch, False), run(batch, True), run(nudged(batch), True)
    rr = [SimpleNamespace(preds=o["buf_rr_preds"], valid=o["buf_rr_valid"]) for o in (out, ref, ref_n)]
    k0 = [_futures(o, slice(0, 1)) for o in (out, ref, ref_n)]
    return dict(launches=launches, step_s=step_s, val_loss=metrics["val/loss"],
                reactive_replay=held_beside_nudge(*rr, "bf16 validation reactive replay, kernels vs plain"),
                joint_future_k0=held_beside_nudge(*k0, "bf16 validation joint future K=0, kernels vs plain"))


# bf16 training step, kernels vs plain: K3 and K4 run fp32 on widened
# inputs, but the products after them round to bf16, so an ulp of theirs
# that crosses a rounding boundary is a bf16 ulp downstream, and the step
# turns it into what a one-ulp map nudge does to the plain run. On the H100
# at full width (run B2) the kernels-vs-plain loss gap was 8.5e-5 (the
# nudge's 4.3e-5) and the largest gradient gap 6.0e-2 (5.8e-2; medians
# 2.2e-2 and 1.6e-2): phase 5's 1e-5 and 1e-2 are below that floor. The
# gaps are held to BF16_TRAIN_NUDGE_FACTOR x the nudge's in the same run:
# a draw of the bf16 rounding chaos varies, and a wrong kernel moves the
# leaves above it by O(1), two orders of magnitude beyond.
BF16_TRAIN_NUDGE_FACTOR = 4.0


def train_bf16(cfg, batch, dev) -> dict:
    """One training step under precision="bf16" over HELD_STEPS, kernels
    (K3 and K4 on the widened inputs, fp32) vs plain versions, the loss and
    the largest and median gradient gaps held within
    BF16_TRAIN_NUDGE_FACTOR x a one-ulp map nudge's in this run; the
    training kernels' launch counts."""
    held = dataclasses.replace(bf16_config(cfg, False), time_step_end=HELD_STEPS)
    zero_counts(TRAIN_COUNTERS)
    lk, gk = loss_and_grads(held, batch, dev, plain=False)
    counts = read_counts(TRAIN_COUNTERS)
    lp, gp = loss_and_grads(held, batch, dev, plain=True)
    ln, gn = loss_and_grads(held, nudged(batch), dev, plain=True)
    loss_gap = abs(lk - lp) / abs(lp)
    gap, worst, median = grad_gap(gk, gp)
    nudge_gap, nudge_worst, nudge_median = grad_gap(gn, gp)
    log(f"bf16 training step over steps 1..{HELD_STEPS}: launches {counts}; kernels vs plain loss {lk} vs {lp} (rel "
        f"{loss_gap}), largest gradient rel norm error {gap} at {worst}, median {median}; a one-ulp map nudge of the "
        f"plain run: loss rel {abs(ln - lp) / abs(lp)}, largest gradient gap {nudge_gap} at {nudge_worst}, median "
        f"{nudge_median} (the limits: {BF16_TRAIN_NUDGE_FACTOR} x the nudge's)")
    nudge_loss = abs(ln - lp) / abs(lp)
    f = BF16_TRAIN_NUDGE_FACTOR
    require(all(counts[k] > 0 for k in ("K3f", "K3b", "K4f", "K4b", "K5")), f"bf16 training step: launches {counts}")
    require(math.isfinite(lk) and loss_gap <= f * nudge_loss,
            f"bf16 training loss differs by rel {loss_gap} > {f} x the nudge's {nudge_loss}")
    require(gap <= f * nudge_gap and median <= f * nudge_median,
            f"bf16 training gradient {worst} differs by rel {gap} (median {median}) > {f} x the nudge's {nudge_gap} "
            f"({nudge_median})")
    return dict(launches=counts, loss=lk, loss_rel=loss_gap, nudge_loss_rel=nudge_loss, grad_rel=gap,
                grad_rel_median=median, nudge_grad_rel=nudge_gap, nudge_grad_rel_median=nudge_median,
                held_steps=HELD_STEPS)


def bf16_early(cfg, batch, dev) -> dict:
    """Phase 6c's parts that need no K4 (the full run runs them while K4's
    sources compile): (a) and (c) of bf16_path."""
    t0 = time.perf_counter()
    out = dict(sass_hmma=sass_hmma_counts(), K1_bf16=check_k1_bf16(dev), K2_bf16=check_k2_bf16(dev, batch),
               K6_bf16=check_k6_bf16(dev, batch), validation=validation_bf16(cfg, batch, dev))
    out["early_s"] = time.perf_counter() - t0
    return out


def bf16_path(cfg, batch, dev, fp32_eval=None, early=None) -> dict:
    """Phase 6c: the bf16 configurations. (a) the tensor-core kernels' SASS,
    the three bf16 variants against
    their plain versions at full width with their readings; (b) the eval
    rollout under precision="bf16" with and without kernel_matmul_bf16,
    beside the fp32 rollout's agent-steps/s and peak memory (phase 4's in
    the full run, `fp32_eval`; measured here in --bf16); (c) one
    validation step under "hybrid" and kernel_matmul_bf16; (d) one
    training step. `early`: bf16_early's result, when the run made it
    already."""
    t_phase = time.perf_counter()
    result = dict(early or bf16_early(cfg, batch, dev))
    result["eval"] = eval_bf16(cfg, batch, dev, True, N_ITER)
    result["eval_without_matmul_bf16"] = eval_bf16(cfg, batch, dev, False, 0)
    result["eval_fp32"] = fp32_eval or fp32_eval_reading(cfg, batch, dev, N_ITER)
    log(f"bf16 eval rollout: {result['eval']['agent_steps_per_s']} agent-steps/s, peak {result['eval']['peak_gib']} GiB; "
        f"fp32: {result['eval_fp32']['agent_steps_per_s']} agent-steps/s, peak {result['eval_fp32']['peak_gib']} GiB "
        f"(readings) [{card_line()}]")
    result["training"] = train_bf16(cfg, batch, dev)
    result["phase_s"] = time.perf_counter() - t_phase + (result["early_s"] if early else 0.0)
    result["card"] = card_line()
    log(f"bf16: phase in {result['phase_s']} s")
    return result


# ------------------------------------------------------------------ the dead-query-row skip (phase 6d)

SKIP_COUNTERS = {"K1": (FA, "LAUNCHES"), "K1-bf16": (FA, "LAUNCHES_BF16"), "K1-skip": (FA, "LAUNCHES_SKIP")}
K3_SKIP_COUNTERS = {"K3f-skip": (AT, "LAUNCHES_FWD_SKIP"), "K3b-skip": (AT, "LAUNCHES_BWD_SKIP")}
SKIP_ROW_BLOCKS = (0, 16)  # attn_row_block values held against -1 (every value >= 0 turns the skip on)
FILL_AGENTS = 40  # the main path's valid agents of 64
SPARSE_AGENTS = 8  # a sparse scene's


def dead_agents(B, S, n_live, dev, n_agent=64):
    """[B, S] src_invalid of query rows that are agents (step-major: row r is
    agent r % n_agent) with agents n_live .. dead."""
    return (torch.arange(S) % n_agent >= n_live)[None].expand(B, S).contiguous().to(dev)


def skip_bound(q, k, invalid, src, mask_bytes, bf16):
    """The bound of a skipping call: its inputs read once (src_invalid one
    byte a row) and its output written once; 4 D operations for each allowed
    pair of a live row (fp32 at 67 TFLOP/s, or bf16 products at 989)."""
    live = FA.row_live(invalid, src)
    pairs = int((~invalid & live[..., None]).sum().item())
    n_bytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + mask_bytes + src.numel()
    return (bound_ms_bf16 if bf16 else bound_ms)(n_bytes, 4 * q.shape[-1] * pairs)


def check_k1_skip(dev):
    """(a) K1's dead-query-row skip at the rollout as2pl (B = 8 and the
    joint futures' 48, bf16 K/V) and the latent as2pl, on fp32 q and on
    bf16 q/k/v (K1-bf16), with the main path's fill (agents 40.. dead) and
    a sparse one (8 live): dead rows exactly 0, live rows bitwise K1's
    without src_invalid, against the plain version with the same
    src_invalid (K1_TOL; bf16 within a one-bf16-ulp nudge's gap), two calls
    bitwise equal; ms and device_ms beside K1's own on the same inputs,
    SDPA's with the live rows' mask, the bound. The kernels-line entry is
    the rollout as2pl's at the main fill in fp32."""
    gen = torch.Generator().manual_seed(13)
    entry, per_site, max_err = None, [], 0.0
    for name, B, S in (("rollout as2pl", N_SCENE, 64), (K1_B48, 6 * N_SCENE, 64), ("latent as2pl", N_SCENE, 19 * 64)):
        (q, k, v, invalid, H), mask_bytes = k1_case(gen, B, S, 1024, S == 64, 0.25, False, dev)
        for prec in ("fp32", "bf16"):
            bf16 = prec == "bf16"
            args = (q.bfloat16(), k.bfloat16(), v.bfloat16(), invalid, H) if bf16 else (q, k, v, invalid, H)
            base = FA.fused_attention_core(*args)
            k1_dev = graph_ms(lambda: FA.fused_attention_core(*args))
            for fill in (FILL_AGENTS, SPARSE_AGENTS):
                src = dead_agents(B, S, fill, dev)
                out = FA.fused_attention_core(*args, src_invalid=src)
                again = FA.fused_attention_core(*args, src_invalid=src)
                torch.cuda.synchronize()
                what = f"K1-skip {name} {prec} {fill} live agents"
                live = FA.row_live(invalid, src)
                require(torch.equal(out, again), f"{what}: not bitwise reproducible")
                require(bool((out[~live] == 0).all()), f"{what}: a dead row is not 0")
                require(torch.equal(out[live], base[live]), f"{what}: live rows differ from K1's without src_invalid")
                ref = FA.attention_core_plain(*args, src_invalid=src)
                if bf16:
                    held = bf16_held(what, out, ref, FA.attention_core_plain(bf16_up(args[0]), *args[1:],
                                                                              src_invalid=src))
                    err = held["vs_plain"]["max_abs"]
                else:
                    err = max_err_checked(out, ref, K1_TOL, what)
                max_err = max(max_err, err)
                ms = time_ms(lambda: FA.fused_attention_core(*args, src_invalid=src))
                dev_ms = graph_ms(lambda: FA.fused_attention_core(*args, src_invalid=src))
                plain_ms = time_ms(lambda: FA.attention_core_plain(*args, src_invalid=src), n=5)
                qh, kh, vh = (t.view(t.shape[0], t.shape[1], H, -1).transpose(1, 2).to(args[0].dtype)
                              for t in args[:3])
                allowed = (~invalid & live[..., None])[:, None]
                lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, attn_mask=allowed)
                lib_ms, lib_dev = time_ms(lib), graph_ms(lib)
                b_ms, b_by = skip_bound(args[0], args[1], invalid, src, mask_bytes, bf16)
                log(f"{what}: B={B} S={S} T=1024 live rows {int(live.sum().item())} of {live.numel()} "
                    f"max_abs_err={err} ms={ms} device_ms={dev_ms} (K1 without src_invalid: device_ms={k1_dev}) "
                    f"plain_ms={plain_ms} library_ms={lib_ms} library_device_ms={lib_dev} (SDPA, the live rows' "
                    f"mask) bound_ms={b_ms} ({b_by}); live rows bitwise K1's, dead rows 0 [{card_line()}]")
                site = dict(site=name, precision=prec, live_agents=fill, ms=ms, device_ms=dev_ms,
                            k1_device_ms=k1_dev, plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev,
                            bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
                per_site.append(site)
                if entry is None:
                    entry = dict(ms=ms, device_ms=dev_ms, k1_device_ms=k1_dev, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev,
                                 shape=f"B={B} S={S} T=1024 D=128 H=4 fp32 q bf16 K/V, {name}, {fill} of 64 agents")
    entry["max_abs_err"] = max_err
    entry["sites"] = per_site
    return entry


def check_k3_skip(dev):
    """(b) K3's skip at the main path's training sites with their dead rows
    (the map self-attention's last 256 polylines, the as2pl's and the
    posterior latent as2pl's agents 40..), dropout live: K3f's live rows and
    row statistics bitwise those without src_invalid, dead rows 0 with max
    -inf and sum 0; K3b on that forward, the cotangent 0 on dead rows, bitwise
    the unskipped forward's dq, dk, dv (up to the sign of a zero); both
    against the plain version through autograd (K3_TOL, K3_GRAD_RTOL); the
    device ms of both kernels beside the unskipped ones'. Returns the
    kernels-line entries of K3f-skip and K3b-skip (the map self-attention)."""
    gen, H = torch.Generator().manual_seed(14), 4
    per_site, err_f, err_b = [], 0.0, 0.0
    for name, B, S, T, pad, full in k3_sites(N_SCENE):
        if full:
            continue
        q, k, v, invalid, g, mask_bytes = k3_inputs(gen, B, S, T, pad, full, dev)
        src = (torch.arange(S) >= 768)[None].expand(B, S).contiguous().to(dev) if S == T else \
            dead_agents(B, S, FILL_AGENTS, dev)
        live = FA.row_live(invalid, src)
        g = g * live[..., None]  # the callers zero dead rows
        seed, what = 2**41 + S, f"K3-skip {name}"
        fwd = AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0, src)
        fwd0 = AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0)
        (o, rmax, rsum), (o0, rmax0, rsum0) = fwd, fwd0
        hl = live[:, None, :].expand_as(rmax)
        require(torch.equal(o[live], o0[live]) and bool((o[~live] == 0).all()),
                f"{what}: K3f live rows differ from the unskipped ones, or a dead row is not 0")
        require(torch.equal(rmax[hl], rmax0[hl]) and torch.equal(rsum[hl], rsum0[hl])
                and bool((rmax[~hl] == float("-inf")).all()) and bool((rsum[~hl] == 0).all()),
                f"{what}: K3f row statistics")
        d = AT._launch_bwd(q, k, v, invalid, *fwd, g, H, P_DROP, seed, 0, skip=True)
        d0 = AT._launch_bwd(q, k, v, invalid, *fwd0, g, H, P_DROP, seed, 0)
        torch.cuda.synchronize()
        require(all(torch.equal(a + 0.0, b + 0.0) for a, b in zip(d, d0)),
                f"{what}: K3b's dq, dk, dv differ from the unskipped forward's")

        def run(fn):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, invalid, H, P_DROP, seed, 0, src_invalid=src)
            return out, torch.autograd.grad(out, leaves, g)

        out, grads = run(AT.attention_train)
        ref, ref_grads = run(AT.attention_train_plain)
        ef = max_err_checked(out.detach(), ref.detach(), K3_TOL, f"{what} forward")
        eb = grads_checked(grads, ref_grads, ("dq", "dk", "dv"), K3_GRAD_RTOL, f"{what} backward")
        err_f, err_b = max(err_f, ef), max(err_b, eb)
        with torch.no_grad():
            ms_f = time_ms(lambda: AT.attention_train(q, k, v, invalid, H, P_DROP, seed, 0, src_invalid=src))
            plain_f = time_ms(lambda: AT.attention_train_plain(q, k, v, invalid, H, P_DROP, seed, 0, src_invalid=src),
                              n=5)
        dev_f = graph_ms(lambda: AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0, src))
        dev_f0 = graph_ms(lambda: AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0))
        dev_b = graph_ms(lambda: AT._launch_bwd(q, k, v, invalid, *fwd, g, H, P_DROP, seed, 0, skip=True))
        dev_b0 = graph_ms(lambda: AT._launch_bwd(q, k, v, invalid, *fwd0, g, H, P_DROP, seed, 0))
        ms_b = time_ms(lambda: run(AT.attention_train))
        plain_b = time_ms(lambda: run(AT.attention_train_plain), n=5)
        lib_fwd, lib_leaves = sdpa_train(q, k, v, invalid | ~live[..., None], H)
        with torch.no_grad():
            lib_f = time_ms(lib_fwd)
        lib_out = lib_fwd()
        gh = g.view(B, S, H, -1).transpose(1, 2)
        lib_b = time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, gh, retain_graph=True))
        pairs = int((~invalid & live[..., None]).sum().item())
        io = (2 * q.numel() + 2 * k.numel()) * 4 + mask_bytes + src.numel() + 2 * B * H * S * 4
        bf, bf_by = bound_ms(io, 4 * 128 * pairs)
        bb, bb_by = bound_ms(io + (2 * q.numel() + 2 * k.numel()) * 4, 8 * 128 * pairs)
        log(f"{what}: B={B} S={S} T={T} live rows {int(live.sum().item())} of {live.numel()}; fwd max_abs_err={ef} "
            f"ms={ms_f} device_ms={dev_f} (without src_invalid {dev_f0}) plain_ms={plain_f} library_ms={lib_f} "
            f"bound_ms={bf} ({bf_by}); bwd grad rel err={eb} ms={ms_b} device_ms={dev_b} (after the unskipped "
            f"forward {dev_b0}) plain_ms={plain_b} library_ms={lib_b} bound_ms={bb} ({bb_by}); live rows and stats "
            f"bitwise, dead rows 0, dq/dk/dv bitwise the unskipped ones [{card_line()}]")
        per_site.append(dict(site=name, live_rows=int(live.sum().item()), fwd=dict(
            ms=ms_f, device_ms=dev_f, unskipped_device_ms=dev_f0, plain_ms=plain_f, library_ms=lib_f, bound_ms=bf,
            bound_by=bf_by), bwd=dict(ms=ms_b, device_ms=dev_b, unskipped_device_ms=dev_b0, plain_ms=plain_b,
                                      library_ms=lib_b, bound_ms=bb, bound_by=bb_by)))
    site = next(x for x in per_site if x["site"] == "map polyline self-attention")
    shape = "B=8 S=T=1024 D=128 H=4 fp32 p=0.1, map polyline self-attention, polylines 768.. dead"
    fwd = dict(site["fwd"], max_abs_err=err_f, shape=shape, sites=[dict(site=x["site"], **x["fwd"]) for x in per_site])
    bwd = dict(site["bwd"], max_abs_err=err_b, shape=shape, sites=[dict(site=x["site"], **x["bwd"]) for x in per_site])
    return fwd, bwd


def skip_config(cfg: ExperimentConfig, row_block: int) -> ExperimentConfig:
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attn_row_block=row_block))


def eval_skip(cfg, batch, dev, precision: str) -> dict:
    """(c) The eval rollout at attn_row_block 0 and 16 against -1 (one set of
    weights), each with the launch counts set to 0 just before and read
    just after: preds and valid bitwise equal over every step; K1-skip at
    every as2pl and latent as2pl launch, none at -1; agent-steps/s of
    each (readings)."""
    base = cfg if precision == "fp32" else bf16_config(cfg, False)
    n_scene, n_steps = batch["map/valid"].shape[0], base.time_step_end - base.time_step_sim_start + 1
    models = {-1: O.make_model(base, device=dev, seed=0)}
    for rb in SKIP_ROW_BLOCKS:
        models[rb] = O.make_model(skip_config(base, rb), device=dev, seed=0)
        models[rb].load_state_dict(models[-1].state_dict())
    O.eval_rollout(base, models[-1], batch, device=dev)  # warm-up
    torch.cuda.synchronize()
    outs, launches, secs = {}, {}, {rb: [] for rb in models}
    for rb, model in models.items():
        zero_counts(SKIP_COUNTERS)
        t0 = time.perf_counter()
        outs[rb] = O.eval_rollout(skip_config(base, rb), model, batch, device=dev)
        torch.cuda.synchronize()
        secs[rb].append(time.perf_counter() - t0)
        launches[rb] = read_counts(SKIP_COUNTERS)
    what = f"{precision} eval rollout with the skip"
    core = "K1" if precision == "fp32" else "K1-bf16"
    log(f"{what}: launches by attn_row_block {launches}")
    require(launches[-1]["K1-skip"] == 0, f"{what}: K1-skip launched at attn_row_block=-1")
    for rb in SKIP_ROW_BLOCKS:
        # every K1 launch but the map self-attention's carries src_invalid
        require(launches[rb]["K1-skip"] == launches[rb][core] - 1 > 0 and launches[rb][core] == launches[-1][core],
                f"{what}: launches at attn_row_block={rb}: {launches[rb]}")
        require(torch.equal(outs[rb].preds, outs[-1].preds) and torch.equal(outs[rb].valid, outs[-1].valid),
                f"{what}: attn_row_block={rb} is not bitwise the rollout at -1")
    asps = {rb: n_scene * base.data.n_agent * n_steps / statistics.median(t) for rb, t in secs.items()}
    log(f"{what}: preds and valid bitwise equal to attn_row_block=-1 over all {n_steps} steps at "
        f"{list(SKIP_ROW_BLOCKS)}; seconds {secs}; agent-steps/s {asps} (readings) [{card_line()}]")
    return dict(launches=launches, seconds=secs, agent_steps_per_s=asps, bitwise_steps=n_steps)


def tensors(x) -> list:
    """Every tensor of a nested output, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for key in sorted(x) for t in tensors(x[key])]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in tensors(y)]
    return []


def validation_skip(cfg, batch, dev) -> dict:
    """(d) One Validator.step at attn_row_block = 0 against -1, the same
    weights and generator seed: every tensor of its output (the reactive
    replay, all K joint futures, their scores) bitwise equal."""
    outs, launches = {}, {}
    for rb in (-1, 0):
        model = O.make_model(skip_config(cfg, rb), device=dev, seed=0)
        zero_counts(SKIP_COUNTERS)
        outs[rb] = EL.Validator(skip_config(cfg, rb), model, device=dev).step(batch, torch.Generator().manual_seed(302))
        torch.cuda.synchronize()
        launches[rb] = read_counts(SKIP_COUNTERS)
    for key in ("buf_rr_preds", "buf_rr_valid", "buf_jf_preds", "buf_jf_valid"):
        require(torch.equal(outs[0][key], outs[-1][key]), f"Validator.step at attn_row_block=0: {key} differs")
    a, b = tensors(outs[0]), tensors(outs[-1])
    n = len(b)
    require(n == len(a) and all(torch.equal(x, y) for x, y in zip(a, b)),
            "Validator.step at attn_row_block=0 is not bitwise the step at -1")
    require(launches[0]["K1-skip"] > 0 and launches[-1]["K1-skip"] == 0, f"Validator.step launches {launches}")
    log(f"validation with the skip: Validator.step at attn_row_block=0 bitwise the step at -1 ({n} output "
        f"tensors: the reactive replay, the {cfg.n_joint_future} joint futures, their scores); launches {launches}")
    return dict(launches=launches, n_tensors=n)


def train_skip(cfg, batch, dev) -> dict:
    """(e) Phase 5's training step over HELD_STEPS, kernels vs plain versions
    (both skipping, as every K3 site takes the rows' padding mask) at phase
    5's holds, with the K3 and K3-skip launch counts."""
    held = dataclasses.replace(cfg, time_step_end=HELD_STEPS)
    counters = dict(TRAIN_COUNTERS, **K3_SKIP_COUNTERS)
    zero_counts(counters)
    lk, gk = loss_and_grads(held, batch, dev, plain=False)
    counts = read_counts(counters)
    lp, gp = loss_and_grads(held, batch, dev, plain=True)
    loss_gap = abs(lk - lp) / abs(lp)
    gap, worst, median = grad_gap(gk, gp)
    log(f"training step with the skip, steps 1..{HELD_STEPS}: launches {counts}; kernels vs plain loss rel {loss_gap} "
        f"(tolerance {TRAIN_LOSS_RTOL}), largest gradient rel norm error {gap} at {worst}, median {median} "
        f"(tolerance {TRAIN_GRAD_RTOL})")
    require(counts["K3f-skip"] == counts["K3f"] > 0 and counts["K3b-skip"] == counts["K3b"] > 0,
            f"training step: not every K3 launch carried src_invalid: {counts}")
    require(loss_gap <= TRAIN_LOSS_RTOL and gap <= TRAIN_GRAD_RTOL,
            f"training step with the skip: loss rel {loss_gap}, gradient {worst} rel {gap}")
    return dict(launches=counts, loss_rel=loss_gap, grad_rel=gap, grad_rel_median=median, held_steps=HELD_STEPS)


def row_skip_path(cfg, batch, dev) -> dict:
    """Phase 6d: the dead-query-row skip. (a) K1-skip and (b) K3-skip at
    their main-path sites against their plain versions and the unskipped
    kernels; (c) the eval rollout at attn_row_block 0 and 16 against -1 in
    fp32 and under precision="bf16"; (d) one Validator.step at 0 against
    -1; (e) a training step's K3-skip counts and holds."""
    t_phase = time.perf_counter()
    result = dict(K1_skip=check_k1_skip(dev))
    result["K3f_skip"], result["K3b_skip"] = check_k3_skip(dev)
    result["eval"] = eval_skip(cfg, batch, dev, "fp32")
    result["eval_bf16"] = eval_skip(cfg, batch, dev, "bf16")
    result["validation"] = validation_skip(cfg, batch, dev)
    result["training"] = train_skip(cfg, batch, dev)
    result["phase_s"] = time.perf_counter() - t_phase
    result["card"] = card_line()
    log(f"row skip: phase in {result['phase_s']} s")
    return result


# ------------------------------------------------------------------ CLI runner

# `python -m trafficbots_tpu_torch.run` in-process at full width
# (ExperimentConfig defaults), synthetic data (the h5 path needs h5py).
# Without cv2 the default n_video_batch (3) stands: the runner says it
# renders nothing. With cv2 a full-width render of one 8-scene batch
# writes 64 videos of up to 91 frames and 8 images (seconds a video to
# encode on the host), every epoch: the runs pass n_video_batch=0 (the
# media seed is drawn all the same) but run B's first fit, which renders
# one batch (CLI_FIT_MEDIA_ARGS), and phase 6a's validate renders one
# scene over 31 steps (CLI_MEDIA_ARGS).
CLI_ARGS = ["device=cuda", "synthetic=true", "data.batch_size=8", "steps_per_epoch=1", "val_batches=1"] + (
    ["n_video_batch=0"] if VIS._HAS_CV2 else [])
CLI_FIT_MEDIA_ARGS = ["n_video_batch=1"] if VIS._HAS_CV2 else []
CLI_MEDIA_ARGS = ["n_video_batch=1", "data.batch_size=1", "data.n_step=31", "time_step_end=30", "time_step_gt=30"]
CLI_KERNELS = ("K3f", "K3b", "K4f", "K4b", "K5", "K1", "K2")
CLI_COUNTERS = dict(TRAIN_COUNTERS, K1=(FA, "LAUNCHES"), K2=(NE, "LAUNCHES"), K6=(BA, "LAUNCHES"))
# the native WOMD engine against the numpy one on the same accumulated
# inputs: tests/test_native_metrics.py's and tests/test_torch_eval.py's
# tolerance (fp32 sums in C++ against numpy's)
NATIVE_TOL = dict(rtol=1e-4, atol=1e-5)
WOMD_PREFIXES = ("waymo_metrics/", "joint_future_pred/")


def _varint(buf: bytes, pos: int):
    out, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def wire_fields(buf: bytes):
    """The protobuf wire format's top-level fields of a message: a list of
    (field number, value), a varint's value an int, a 32-bit field's 4
    bytes, a length-delimited field's bytes."""
    out, pos = [], 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _varint(buf, pos)
        elif wire == 5:
            v, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _varint(buf, pos)
            v, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"wire type {wire}")
        out.append((field, v))
    return out


def submission_scenarios(tar_path: str):
    """The ScenarioPredictions (field 6) of a submission's .bin file."""
    import tarfile

    with tarfile.open(tar_path) as tar:
        name = next(n for n in tar.getnames() if n.endswith(".bin"))
        return [v for f, v in wire_fields(tar.extractfile(name).read()) if f == 6]


def _state(run_dir: str, name: str = "last"):
    from trafficbots_tpu_torch.training.checkpoint import STATE_FILE

    path = os.path.join(run_dir, "ckpt", name, STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True), os.path.getsize(path)


def _records(run_dir: str, phase_name: str):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["phase"] == phase_name]


def params_gap(sa, sb):
    """The parameters that differ between two checkpoints, and the largest
    absolute difference."""
    diff = [k for k in sa["params"] if not torch.equal(sa["params"][k], sb["params"][k])]
    gap = max(((sa["params"][k] - sb["params"][k]).abs().max().item() for k in diff), default=0.0)
    return diff, gap


def media_files(scene_tags, with_dest=True):
    """The JAX package's media file names for the scenes `scene_tags`
    ("<batch>-<scene>") of the first batch."""
    return [f"{n}_{tag}.mp4" for tag in scene_tags for n in MEDIA_NAMES] + (
        [f"dest_prob_{tag}.png" for tag in scene_tags] if with_dest else [])


def cli_fit_media(run_dir, n_scene):
    """Run B's first fit's media: with cv2 one full-width batch under
    videos/epoch0 with the JAX package's file names (every K of the joint
    futures: the first batch), its seconds from the fit's Profiler; without
    cv2 no `videos` directory."""
    videos = os.path.join(run_dir, "videos", "epoch0")
    files = sorted(os.listdir(videos)) if os.path.exists(videos) else []
    want = sorted(media_files([f"0-{i}" for i in range(n_scene)])) if VIS._HAS_CV2 else []
    require(files == want and all(os.path.getsize(os.path.join(videos, f)) for f in files),
            f"cli: the fit's media {files[:5]}..., expected {want[:5]}...")
    seconds = _records(run_dir, "profile")[-1].get("time/media_mean_s")
    log(f"cli: run B's first fit rendered {len(files)} media files of {n_scene} scenes at full width in {seconds} s "
        f"(cv2 {'present' if VIS._HAS_CV2 else 'absent'})")
    return dict(cv2=VIS._HAS_CV2, files=len(files), seconds=seconds)


def cli_path(batch, dev, val_keys):
    """run.py fit, resume, validate and test at full width through the
    kernels; the resumed fit held bitwise against the uninterrupted one."""
    import tempfile

    from trafficbots_tpu_torch import run as RUN
    from trafficbots_tpu_torch.eval.motion_metrics import MotionMetrics

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="tb_cli_")
    a, b = os.path.join(tmp.name, "a"), os.path.join(tmp.name, "b")
    zero_counts(CLI_COUNTERS)
    RUN.main(["action=fit", f"run_dir={a}", "n_epochs=2"] + CLI_ARGS)
    torch.cuda.synchronize()
    launches = read_counts(CLI_COUNTERS)
    log(f"cli: launches in run A's fit (2 epochs x 1 step, 2 validations): {launches}")
    for k in CLI_KERNELS:
        require(launches[k] > 0, f"the CLI's fit did not launch {k}")
    RUN.main(["action=fit", f"run_dir={b}", "n_epochs=1"] + CLI_ARGS + CLI_FIT_MEDIA_ARGS)
    n_scene = batch["map/valid"].shape[0]
    media = cli_fit_media(b, n_scene)
    require(not os.path.exists(os.path.join(a, "videos")), "cli: run A wrote media at n_video_batch=0 or without cv2")
    RUN.main(["action=fit", f"run_dir={b}", "n_epochs=2", "resume=last"] + CLI_ARGS)

    (sa, size), (sb, _) = _state(a), _state(b)
    require(sa["epoch"] == sb["epoch"] == 2 and sa["global_step"] == sb["global_step"] == 2,
            f"epoch / global_step: A {sa['epoch']} / {sa['global_step']}, B {sb['epoch']} / {sb['global_step']}")
    require(torch.equal(sa["rng"], sb["rng"]), "the generator states of A and B differ")
    steps = {r: [s["step"].item() for s in st["opt_state"]["adam"]["state"].values()] for r, st in (("A", sa), ("B", sb))}
    require(steps["A"] == steps["B"] and set(steps["A"]) == {2.0}, f"Adam's step counts differ: {steps}")
    require(sa["opt_state"]["schedule"] == sb["opt_state"]["schedule"], "the LR schedules' states differ")
    adam_a, adam_b = sa["opt_state"]["adam"]["state"], sb["opt_state"]["adam"]["state"]
    moments = [(i, k) for i, st in adam_a.items() for k, v in st.items() if not torch.equal(v, adam_b[i][k])]
    require(not moments, f"Adam's state differs between A and B at {moments[:5]}")
    diff, gap = params_gap(sa, sb)
    resume = dict(bitwise=not diff, params=len(sa["params"]), params_differing=len(diff), max_abs_gap=gap)
    log(f"cli: resumed fit (B) vs uninterrupted fit (A): {len(diff)} of {len(sa['params'])} parameters differ, "
        f"largest gap {gap}")
    # every kernel and every PyTorch operation of the step is deterministic
    # on the card (no float atomics), so a resume leaves no gap at all
    require(not diff, f"the resumed fit differs from the uninterrupted one in {len(diff)} parameters (largest "
                      f"gap {gap}): {diff[:5]}")

    prof_a, prof_b = _records(a, "profile")[-1], _records(b, "profile")[-1]
    val_a = _records(a, "val")
    require(len(val_a) == 2 and all(math.isfinite(v["val/loss"]) for v in val_a), "fit's validation val/loss")

    out = RUN.main(["action=validate", f"run_dir={b}", "resume=best"] + CLI_ARGS)
    metrics, validator = out["val_metrics"], out["validator"]
    require(math.isfinite(metrics["val/loss"]), f"validate: val/loss {metrics['val/loss']}")
    keys = sorted(k for k in metrics if k.startswith(WOMD_PREFIXES))
    if val_keys is not None:
        require(keys == val_keys, f"validate's metric keys differ from the validation phase's: "
                                  f"{sorted(set(keys) ^ set(val_keys))[:10]}")
    engines = {}
    for w in (validator.womd_rr, validator.womd_jf):
        native = w.engine
        require(type(native).__name__ == "NativeMotionMetrics", f"validate's {w.prefix} engine: {type(native)}")
        numpy_engine = MotionMetrics(native.config)
        for kw in native._batches:
            numpy_engine.update(**kw)
        t1 = time.perf_counter()
        ours = native.compute()
        t2 = time.perf_counter()
        ref = numpy_engine.compute()
        t3 = time.perf_counter()
        require(ours.keys() == ref.keys(), f"{w.prefix}: native and numpy metric keys differ")
        for k, v in ref.items():
            ok = (math.isnan(v) and math.isnan(ours[k])) or abs(ours[k] - v) <= NATIVE_TOL["atol"] + NATIVE_TOL["rtol"] * abs(v)
            require(ok, f"{w.prefix} {k}: native {ours[k]} vs numpy {v}")
        engines[w.prefix] = dict(native_s=t2 - t1, numpy_s=t3 - t2, scenes=sum(len(x["object_type"]) for x in native._batches),
                                 max_abs_diff=max(abs(ours[k] - v) for k, v in ref.items() if not math.isnan(v)))
        log(f"cli: {w.prefix} epoch_end compute: native {t2 - t1} s, numpy {t3 - t2} s, metrics agree within {NATIVE_TOL}")
    prof_v = _records(b, "profile")[-1]

    out = RUN.main(["action=test", f"run_dir={b}", "resume=best"] + CLI_ARGS)
    cfg = ExperimentConfig()
    require(len(out["submission"]) == cfg.n_joint_future, f"test wrote {out['submission']}")
    for path in out["submission"]:
        scenarios = submission_scenarios(path)
        require(len(scenarios) == n_scene, f"{path}: {len(scenarios)} scenario predictions for {n_scene} scenes")
        for sc in scenarios:
            fields = wire_fields(sc)
            require(fields[0][0] == 1 and len(fields[0][1]) > 0 and any(f == 2 for f, _ in fields),
                    f"{path}: a scenario prediction without its id or predictions")
    prof_t = _records(b, "profile")[-1]
    wall = time.perf_counter() - t0
    tmp.cleanup()
    result = dict(
        launches=launches, resume=resume,
        train_step_mean_s=prof_a["time/train_step_mean_s"], val_step_mean_s=prof_a["time/val_step_mean_s"],
        test_step_mean_s=prof_t["time/test_step_mean_s"],
        ckpt_save_ms=1e3 * prof_a["time/ckpt_save_mean_s"], ckpt_restore_ms=1e3 * prof_b["time/ckpt_restore_mean_s"],
        ckpt_restore_params_ms=1e3 * prof_v["time/ckpt_restore_mean_s"], ckpt_mb=size / 1e6,
        womd_epoch_end=engines, val_loss=metrics["val/loss"], media=media,
        map=metrics.get("joint_future_pred/mean_average_precision"), wall_s=wall, card=card_line(),
    )
    return result


# ------------------------------------------------------------------ ablations and interactive

ABL_COUNTERS = dict(TRAIN_COUNTERS, K1=(FA, "LAUNCHES"), K2=(NE, "LAUNCHES"))
HEAD_TOL = 1e-5  # a goal head's output, kernels vs plain versions, relative to its largest magnitude
# goal_xy re-localises each agent's goal in its own frame every step, and
# its closed loop leaves the ulp level sooner: on an H100 at full width a
# one-ulp map nudge moves its validation replay past 1e-3 m at step 23
# (the default model's at 25). Its kernels-vs-plain preds are held to
# ROLLOUT_ATOL over the first GOAL_XY_HELD_STEPS steps, and the gap must
# pass ROLLOUT_ATOL no earlier than the nudge's.
GOAL_XY_HELD_STEPS = 20
DEST_HEADS = ("transformer", "transformer_aggr", "attn")


def head_inputs(cfg, model, batch, dev, training):
    """The goal head's inputs from the episode encode (no gradient)."""
    pb = pre_processing(to_torch(batch, dev), cfg.model, n_step_hist=cfg.time_step_current + 1, training=training)
    with torch.no_grad():
        feats = O.encode_episode_features(model, pb, views=("input",))["input"]
    return dict(agent_type=pb["ref/agent_type"], map_type=pb["ref/map_type"], agent_state=pb["ref/agent_state"],
                **feats)


def goal_predictor_sites(cfg, batch, dev):
    """The goal_xy GoalPredictor's as2pl (S = 64 agents, T = 1024
    polylines) alone: one eval call launches K1 once, one training call
    and its backward K3f and K3b once each."""
    model = O.make_model(cfg, device=dev, seed=0)
    inp = head_inputs(cfg, model, batch, dev, training=False)
    zero_counts(ABL_COUNTERS)
    with torch.no_grad():
        model.pred_goal(**inp)
    torch.cuda.synchronize()
    eval_counts = read_counts(ABL_COUNTERS)
    inp = head_inputs(cfg, model, batch, dev, training=True)
    zero_counts(ABL_COUNTERS)
    d = model.pred_goal(rng=DropoutSeeds(1), **inp)
    d.mean.sum().backward()
    torch.cuda.synchronize()
    train_counts = read_counts(ABL_COUNTERS)
    log(f"ablations: the GoalPredictor alone launches {eval_counts} in eval and {train_counts} in training")
    require(eval_counts["K1"] == 1, "the GoalPredictor's as2pl did not launch K1 in eval")
    require(train_counts["K3f"] == 1 and train_counts["K3b"] == 1, "the GoalPredictor's as2pl did not launch K3")
    return dict(eval=eval_counts, train=train_counts)


def trafficsim_training(cfg, batch, dev):
    """ablation("trafficsim") (goal_xy GoalPredictor, a latent resampled
    every step, the unmasked GRU, state-integrator dynamics):
    make_train_step, one timed step (the first of a fresh model) with the
    counts set to 0 just before and read just after; then the loss and
    gradients with the kernels against the plain versions over HELD_STEPS,
    beside a one-ulp map nudge of the plain run."""
    model = O.make_model(cfg, device=dev, seed=0)
    step = TT.make_train_step(cfg, model, TT.make_optimizer(cfg, model))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ABL_COUNTERS)
    t0 = time.perf_counter()
    m = step(batch, seed=101)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(ABL_COUNTERS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss, norm = m["loss"].item(), m["grad_norm"].item()
    trained = [n for n, p in model.named_parameters() if p.grad is not None and bool(p.grad.ne(0).any())]
    moved = sum(not torch.equal(before[n], dict(model.named_parameters())[n]) for n in trained)
    log(f"ablations: trafficsim train step (the first call) {secs} s ({1e3 * secs} ms), loss {loss}, grad_norm {norm}, launches "
        f"{launches}, peak device memory {peak} GiB, {moved} of {len(trained)} parameters with a gradient moved "
        f"[{card_line()}]")
    require(math.isfinite(loss) and math.isfinite(norm) and norm > 0, "trafficsim: non-finite loss or grad norm")
    for k in TRAIN_COUNTERS:
        require(launches[k] > 0, f"the trafficsim training step did not launch {k}")
    require(moved == len(trained) > 0, f"trafficsim: only {moved} of the {len(trained)} parameters with a gradient moved")
    del model, step
    held = dataclasses.replace(cfg, time_step_end=HELD_STEPS)
    lk, gk = loss_and_grads(held, batch, dev, plain=False)
    lp, gp = loss_and_grads(held, batch, dev, plain=True)
    ln, gn = loss_and_grads(held, nudged(batch), dev, plain=True)
    loss_gap = abs(lk - lp) / abs(lp)
    gap, worst, median = grad_gap(gk, gp)
    nudge_gap, nudge_worst, _ = grad_gap(gn, gp)
    log(f"ablations: trafficsim training step, kernels vs plain versions, steps 1..{HELD_STEPS}: loss {lk} vs {lp} "
        f"(rel {loss_gap}, tolerance {TRAIN_LOSS_RTOL}), largest gradient rel norm error {gap} at {worst}, median "
        f"{median} (tolerance {TRAIN_GRAD_RTOL}); a one-ulp map nudge of the plain run: loss rel "
        f"{abs(ln - lp) / abs(lp)}, largest gradient gap {nudge_gap} at {nudge_worst}")
    require(gk.keys() == gp.keys(), "trafficsim: kernels and plain versions train different parameters")
    require(loss_gap <= TRAIN_LOSS_RTOL, f"trafficsim training loss differs by rel {loss_gap}")
    require(gap <= TRAIN_GRAD_RTOL, f"trafficsim training gradient {worst} differs by rel {gap}")
    return dict(step_ms=1e3 * secs, loss=loss, grad_norm=norm, launches=launches, peak_gib=peak,
                held_loss_rel=loss_gap, held_grad_rel=gap, held_grad_rel_median=median,
                held_nudge_loss_rel=abs(ln - lp) / abs(lp), held_nudge_grad_rel=nudge_gap)


def validator_step(cfg, batch, dev, what):
    """One Validator.step (counts set to 0 just before, read just after) and
    epoch_end: a finite val/loss."""
    model = O.make_model(cfg, device=dev, seed=0)
    val = EL.Validator(cfg, model, device=dev)
    zero_counts(ABL_COUNTERS)
    t0 = time.perf_counter()
    val.step(batch, torch.Generator().manual_seed(301))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(ABL_COUNTERS)
    metrics = val.epoch_end()
    log(f"ablations: {what} Validator.step {secs} s (the first call of a fresh model), launches {launches}, "
        f"val/loss {metrics['val/loss']}, mAP {metrics.get('joint_future_pred/mean_average_precision')}")
    require(launches["K1"] > 0 and launches["K2"] > 0, f"{what}: the validation step did not launch K1 and K2")
    require(math.isfinite(metrics["val/loss"]), f"{what}: val/loss {metrics['val/loss']}")
    return dict(step_s=secs, launches=launches, val_loss=metrics["val/loss"],
                map=metrics.get("joint_future_pred/mean_average_precision"))


def latent_cat_eval(cfg, batch, dev):
    """ablation("latent_cat"): the eval reactive replay with the kernels
    against the plain versions over HELD_STEPS (phase 4's hold)."""
    model = O.make_model(cfg, device=dev, seed=0)
    zero_counts(ABL_COUNTERS)
    out = O.eval_rollout(cfg, model, batch, device=dev)
    torch.cuda.synchronize()
    launches = read_counts(ABL_COUNTERS)
    require(launches["K1"] > 0 and launches["K2"] > 0, "latent_cat: the eval rollout did not launch K1 and K2")
    with ops.plain_versions():
        ref = O.eval_rollout(cfg, model, batch, device=dev)
        ref_nudged = O.eval_rollout(cfg, model, nudged(batch), device=dev)
    return dict(launches=launches,
                vs_plain=compare_rollouts(out, ref, ref_nudged, "latent_cat eval rollout, kernels vs plain versions"))


def dest_head(cfg, batch, dev, mode):
    """One DestPredictor head at full width: pred_goal with the kernels
    against the plain versions on the same features, the probabilities of
    every valid row summing to 1, no mass on excluded polyline types, the
    head's peak memory; then one training step over HELD_STEPS, finite."""
    gm = cfg.model.goal_manager
    hcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, goal_manager=dataclasses.replace(
        gm, goal_predictor=dataclasses.replace(gm.goal_predictor, mode=mode))))
    model = O.make_model(hcfg, device=dev, seed=0)
    inp = head_inputs(hcfg, model, batch, dev, training=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        d = model.pred_goal(**inp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    with torch.no_grad(), ops.plain_versions():
        ref = model.pred_goal(**inp)
    fin = torch.isfinite(ref.logits)
    require(torch.equal(torch.isfinite(d.logits), fin), f"{mode}: kernels and plain versions mask other polylines")
    rel = ((d.logits - ref.logits)[fin].abs().max() / ref.logits[fin].abs().max()).item()
    map_type_mask, attn_mask = GM.dest_type_masks(inp["agent_type"], inp["map_type"], inp["map_feature_valid"])
    excluded = map_type_mask[:, None] | attn_mask
    rows = d.valid & ~excluded.all(-1)
    probs = d.probs
    sum_err = (probs.sum(-1)[rows] - 1).abs().max().item()
    excluded_mass = probs[rows][excluded[rows]].abs().max().item()
    zero_counts(ABL_COUNTERS)
    held = dataclasses.replace(hcfg, time_step_end=HELD_STEPS)
    tstep = TT.make_train_step(held, model, TT.make_optimizer(held, model))
    torch.cuda.reset_peak_memory_stats()
    m = tstep(batch, seed=102)
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"ablations: DestPredictor {mode!r}: pred_goal {1e3 * secs} ms, kernels vs plain rel {rel} (tolerance "
        f"{HEAD_TOL}), {int(rows.sum())} valid rows' probabilities sum to 1 within {sum_err}, largest mass on an "
        f"excluded polyline {excluded_mass}, the head's peak memory {peak} GiB; training step loss "
        f"{m['loss'].item()}, grad_norm {m['grad_norm'].item()}, peak {train_peak} GiB [{card_line()}]")
    require(rel <= HEAD_TOL, f"{mode}: pred_goal differs from its plain run by rel {rel}")
    require(rows.any() and sum_err <= 1e-5, f"{mode}: probabilities sum to 1 within {sum_err}")
    require(excluded_mass == 0.0, f"{mode}: mass {excluded_mass} on an excluded polyline")
    require(math.isfinite(m["loss"].item()) and math.isfinite(m["grad_norm"].item()), f"{mode}: non-finite training step")
    return dict(pred_goal_ms=1e3 * secs, vs_plain_rel=rel, prob_sum_err=sum_err, peak_gib=peak,
                train_loss=m["loss"].item(), train_peak_gib=train_peak)


ROLLOUT_FIELDS = ("valid", "preds", "override_masks", "diffbar_rewards", "diffbar_rewards_valid", "latent_log_probs",
                  "action_log_probs")


def same_rollout(a, b, n=None) -> bool:
    cut = (lambda t: t[:, :, :n]) if n is not None else (lambda t: t)
    return (all(torch.equal(getattr(a, f), cut(getattr(b, f))) for f in ROLLOUT_FIELDS)
            and a.violations.keys() == b.violations.keys()
            and all(torch.equal(a.violations[k], cut(v)) for k, v in b.violations.items()))


def interactive(cfg, batch, dev):
    """orchestration.interactive_replay run to the end against
    reactive_replay on the same inputs, bitwise; a 20-step prefix against
    the replay's first 20 steps; two agents forced at one step land exactly
    on the given state; the host's ms a step."""
    model = O.make_model(cfg, device=dev, seed=0)
    pb = pre_processing(to_torch(batch, dev), cfg.model, training=False)
    with torch.no_grad():
        feats = O.encode_episode_features(model, pb, views=("input", "latent_post"))
        goal, goal_valid = O.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
        latent = model.latent(posterior=True, **feats["latent_post"])
        mask_tf = teacher_forcing_mask(O.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])
        args = (cfg, model, pb, feats["input"], latent, goal, goal_valid, mask_tf)
        ref = O.reactive_replay(*args)
    zero_counts(ABL_COUNTERS)
    sim = O.interactive_replay(*args, device=dev)
    step_ms = []
    while not sim.done:
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    buf = sim.finish()
    launches = read_counts(ABL_COUNTERS)
    bitwise = same_rollout(buf, ref)
    prefix = O.interactive_replay(*args, device=dev)
    for _ in range(20):
        prefix.step()
    prefix_ok = same_rollout(prefix.finish(), ref, 20)
    forced_sim = O.interactive_replay(*args, device=dev)
    for _ in range(4):
        forced_sim.step()
    B, A = forced_sim.carry.agent.valid.shape
    mask = torch.zeros((B, A), dtype=torch.bool, device=dev)
    mask[:, :2] = True
    state = torch.tensor([12.5, -3.25, 0.5, 4.0], device=dev).expand(B, A, 4).clone()
    state[:, 1] = torch.tensor([-7.0, 20.0, -1.5, 2.0], device=dev)
    over = dict(state=state, vel=torch.zeros(B, A, 2, device=dev), acc=torch.zeros(B, A, 1, device=dev),
                yaw_rate=torch.zeros(B, A, 1, device=dev))
    forced_sim.step(mask_override=mask, state_override=over)
    forced_ok = bool(torch.equal(forced_sim.carry.agent.state[:, :2], state[:, :2])
                     and forced_sim.carry.agent.valid[:, :2].all())
    med = statistics.median(step_ms)
    log(f"ablations: interactive_replay run to the end equals reactive_replay bitwise: {bitwise}; a 20-step prefix "
        f"equals its first 20 steps: {prefix_ok}; two agents forced at step 5 land exactly: {forced_ok}; host ms a "
        f"step (synced) median {med}, min {min(step_ms)}, max {max(step_ms)}; launches {launches} [{card_line()}]")
    require(bitwise, "interactive_replay differs from reactive_replay")
    require(prefix_ok, "the interactive prefix differs from the replay's first steps")
    require(forced_ok, "the forced agents are not at the given state")
    require(launches["K1"] > 0, "the interactive steps did not launch K1")
    return dict(bitwise=bitwise, prefix_bitwise=prefix_ok, forced_exact=forced_ok, step_ms_median=med,
                step_ms_min=min(step_ms), step_ms_max=max(step_ms), launches=launches)


def ablation_path(cfg, batch, dev):
    """The paper's ablation models and the interactive sim at full width."""
    t0 = time.perf_counter()
    out = {}
    gx = ablation("goal_xy", cfg)
    out["goal_predictor_sites"] = goal_predictor_sites(gx, batch, dev)
    out["trafficsim_training"] = trafficsim_training(ablation("trafficsim", cfg), batch, dev)
    lc = ablation("latent_cat", cfg)
    out["latent_cat_eval"] = latent_cat_eval(lc, batch, dev)
    out["latent_cat_validation"] = validator_step(lc, batch, dev, "latent_cat")
    out["goal_xy_validation"] = validator_step(gx, batch, dev, "goal_xy")
    vs_plain = validation_vs_plain(gx, batch, dev, held_steps=GOAL_XY_HELD_STEPS)
    key = str(ROLLOUT_ATOL)
    for name in ("reactive_replay", "joint_future_k0"):
        first, first_nudge = vs_plain[name]["first_step_over"][key], vs_plain[name]["nudge_first_step_over"][key]
        log(f"ablations: goal_xy {name}: the kernels-vs-plain gap first passes {ROLLOUT_ATOL} m at step {first}, a "
            f"one-ulp map nudge's at step {first_nudge}")
        require(first is None or (first_nudge is not None and first >= first_nudge),
                f"goal_xy {name}: the kernels-vs-plain gap passes {ROLLOUT_ATOL} m at step {first}, before a one-ulp "
                f"nudge's ({first_nudge})")
    out["goal_xy_validation"]["vs_plain"] = vs_plain
    out["dest_heads"] = {mode: dest_head(cfg, batch, dev, mode) for mode in DEST_HEADS}
    out["interactive"] = interactive(cfg, batch, dev)
    out["wall_s"] = time.perf_counter() - t0
    out["card"] = card_line()
    return out


# ------------------------------------------------------------------ data parallelism

# two ranks share the one card through gloo (`parallel.mesh.init_from_env`
# picks it: 2 local ranks, 1 card), each with 4 of the 8 scenes; the phase
# holds the data-parallel step to the bit against this process doing the
# same work alone, and the 2-rank CLI's resume to the bit against its
# uninterrupted fit
DP_RANKS = 2
DP_TRAIN_SEED = 700
DP_VAL_SEED = 701
DP_TIMEOUT_S = 420
DP_KERNELS = ("fused_attention", "node_encoder", "dropout", "attention_train", "node_encoder_train")
DP_COUNTERS = dict(TRAIN_COUNTERS, K1=(FA, "LAUNCHES"), K2=(NE, "LAUNCHES"))


def nccl_world_size_1(dev):
    """a: an NCCL group of one rank on the card, in this process: init, an
    all-reduce of a CUDA tensor, destroy; and the backend each layout gets."""
    import datetime

    import torch.distributed as dist
    from trafficbots_tpu_torch.parallel import launch as LA
    from trafficbots_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{LA.free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        x = torch.arange(1024, dtype=torch.float32, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        backend = dist.get_backend()
        require(backend == "nccl" and torch.equal(x, torch.arange(1024, dtype=torch.float32, device=dev)),
                f"NCCL at world size 1: backend {backend}, the all-reduce changed the tensor")
    finally:
        dist.destroy_process_group()
    n_card = torch.cuda.device_count()
    layouts = {f"{n} local ranks on {n_card} card(s)": mesh.choose_backend("cuda", n) for n in (n_card, n_card + 1)}
    require(list(layouts.values()) == ["nccl", "gloo"], f"backend choice: {layouts}")
    log(f"dp: NCCL at world size 1 initialised, all-reduced a CUDA tensor and was destroyed in "
        f"{time.perf_counter() - t0} s; backends by layout {layouts}")
    return dict(nccl_world_size_1=True, seconds=time.perf_counter() - t0, backends=layouts)


def dp_batch(n_rank, r):
    cfg = ExperimentConfig()
    batch = synthetic_episode_batch(cfg.data, n_scene=N_SCENE, seed=0, n_valid_pl=768, n_valid_agent=40)
    per = N_SCENE // n_rank
    return cfg, {k: v[r * per:(r + 1) * per] for k, v in batch.items()}


@contextlib.contextmanager
def recorded_noise(seen):
    """Record every noise tensor `distributions` hands out (the validation
    step's goal Gumbels and latent normals)."""
    from trafficbots_tpu_torch import distributions as DI

    saved = DI.standard_gumbel, DI.standard_normal

    def recorder(fn):
        def draw(*a, **kw):
            x = fn(*a, **kw)
            seen.append(x.detach().cpu())
            return x
        return draw

    DI.standard_gumbel, DI.standard_normal = recorder(saved[0]), recorder(saved[1])
    try:
        yield
    finally:
        DI.standard_gumbel, DI.standard_normal = saved


def _state_cpu(model, opt):
    """Copies of the parameters and Adam's state on the host."""
    adam = opt.adam.state_dict()["state"]
    return dict(params={n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()},
                adam={i: {k: (v.to("cpu", copy=True) if isinstance(v, torch.Tensor) else v) for k, v in st.items()}
                      for i, st in adam.items()})


def dp_rank(cli_dir):
    """One rank of phase 9 (started by `parallel.launch`, joining through
    `parallel.mesh.init_from_env`): b, one data-parallel training step with
    the launch counts set to 0 just before and read just after, then one
    more timed; c, one Validator.step (counted) and epoch_end, then one more
    timed; d, run.main fit A, fit B, B's resume and test on both ranks."""
    from trafficbots_tpu_torch import run as RUN
    from trafficbots_tpu_torch.parallel import launch as LA
    from trafficbots_tpu_torch.parallel import mesh

    created = mesh.init_from_env("cuda")
    try:
        dev = O.resolve_device("cuda")
        n_rank, r = mesh.world_size(), mesh.rank()
        cfg, local = dp_batch(n_rank, r)
        out = dict(rank=r, world=n_rank, backend=torch.distributed.get_backend(), device=torch.cuda.current_device())

        # b: the data-parallel training step
        model = O.make_model(cfg, device=dev, seed=0)
        opt = TT.make_optimizer(cfg, model)
        step = TT.make_train_step(cfg, model, opt)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(TRAIN_COUNTERS)
        t0 = time.perf_counter()
        m = step(local, seed=DP_TRAIN_SEED)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        out["train_launches"] = read_counts(TRAIN_COUNTERS)
        out["train_state"] = _state_cpu(model, opt)
        out["train_metrics"] = {k: v.item() for k, v in m.items()}
        t0 = time.perf_counter()
        step(local, seed=DP_TRAIN_SEED + 1)
        torch.cuda.synchronize()
        out["train_step_ms"] = dict(first=1e3 * first_s, second=1e3 * (time.perf_counter() - t0))
        out["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del model, opt, step
        torch.cuda.empty_cache()

        # c: the sharded Validator
        model = O.make_model(cfg, device=dev, seed=0)
        val = EL.Validator(cfg, model, device=dev)
        torch.cuda.reset_peak_memory_stats()
        seen = []
        zero_counts(DP_COUNTERS)
        t0 = time.perf_counter()
        with recorded_noise(seen):
            res = val.step(local, torch.Generator().manual_seed(DP_VAL_SEED))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        out["val_launches"] = read_counts(DP_COUNTERS)
        out["val_metrics"] = val.epoch_end()
        out["val_out"] = {k: res[k].cpu() for k in ("buf_rr_preds", "buf_rr_valid", "buf_jf_preds", "buf_jf_valid",
                                                     "goal_sample")}
        out["val_noise"] = seen
        t0 = time.perf_counter()
        val.step(local, torch.Generator().manual_seed(DP_VAL_SEED + 1))
        torch.cuda.synchronize()
        out["val_step_s"] = dict(first=first_s, second=time.perf_counter() - t0)
        out["val_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del model, val, res
        torch.cuda.empty_cache()

        # d: the CLI on both ranks
        a, b = os.path.join(cli_dir, "a"), os.path.join(cli_dir, "b")
        with LA.audit_writes(cli_dir) as written:
            zero_counts(CLI_COUNTERS)
            t0 = time.perf_counter()
            RUN.main(["action=fit", f"run_dir={a}", "n_epochs=2"] + CLI_ARGS)
            torch.cuda.synchronize()
            out["cli_fit_s"] = time.perf_counter() - t0
            out["cli_launches"] = read_counts(CLI_COUNTERS)
            RUN.main(["action=fit", f"run_dir={b}", "n_epochs=1"] + CLI_ARGS)
            RUN.main(["action=fit", f"run_dir={b}", "n_epochs=2", "resume=last"] + CLI_ARGS)
            out["cli_test_paths"] = RUN.main(["action=test", f"run_dir={b}", "resume=best"] + CLI_ARGS)["submission"]
        out["cli_written"] = written
        out["cli_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return out
    finally:
        if created:
            mesh.destroy()


def dp_emulation(dev):
    """b's reference: this process alone takes each rank's half with that
    rank's seed (`mesh.rank_seed`), sums the two gradients and halves them,
    then clips and steps Adam, as the ranks do after their all-reduce."""
    from trafficbots_tpu_torch.parallel import mesh

    cfg, _ = dp_batch(1, 0)
    model = O.make_model(cfg, device=dev, seed=0)
    opt = TT.make_optimizer(cfg, model)
    grads, secs, losses = [], [], []
    for r in range(DP_RANKS):
        _, local = dp_batch(DP_RANKS, r)
        opt.adam.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(mesh.rank_seed(DP_TRAIN_SEED, r, DP_RANKS))
        loss, _ = O.training_step(cfg, model, to_torch(local, dev), gen, current_epoch=0)
        loss.backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss.item())
        grads.append({n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in model.named_parameters()})
    for n, p in model.named_parameters():
        p.grad = (grads[0][n] + grads[1][n]) / 2
    opt.step()
    torch.cuda.synchronize()
    return _state_cpu(model, opt), dict(half_step_s=secs, loss=sum(losses) / DP_RANKS)


def state_diff(a, b):
    """The parameters and Adam state entries that differ between two
    states, and the largest absolute gap."""
    diff = [("params", k) for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])]
    gap = max(((a["params"][k] - b["params"][k]).abs().max().item() for _, k in diff), default=0.0)
    require(a["adam"].keys() == b["adam"].keys(), "Adam's states hold other parameters")
    for i, st in a["adam"].items():
        for k, v in st.items():
            w = b["adam"][i][k]
            if not (torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w):
                diff.append(("adam", i, k))
    return diff, gap


def dp_validation_reference(dev):
    """c's reference: one process's Validator.step on the 8 scenes, same
    weights and generator seed, the noise recorded; and its device step on
    the one-ulp map nudge (the readings' yardstick)."""
    cfg, batch = dp_batch(1, 0)
    model = O.make_model(cfg, device=dev, seed=0)
    val = EL.Validator(cfg, model, device=dev)
    seen = []
    t0 = time.perf_counter()
    with recorded_noise(seen):
        out = val.step(batch, torch.Generator().manual_seed(DP_VAL_SEED))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    metrics = val.epoch_end()
    out_nudged = EL.validation_device_step(cfg, model, to_torch(nudged(batch), dev),
                                           torch.Generator().manual_seed(DP_VAL_SEED))
    return out, out_nudged, seen, metrics, secs


def dp_start(dev):
    """Phase 9's start: a in this process, then the ranks (b, c and d) in a
    thread of this process, which goes on with other work (phases 7 and 8
    in a full run) until dp_finish joins them."""
    import tempfile
    import threading

    from trafficbots_tpu_torch.parallel.launch import launch

    run = dict(t_phase=time.perf_counter(), nccl=nccl_world_size_1(dev),
               tmp=tempfile.TemporaryDirectory(prefix="tb_dp_"))

    def ranks():
        t0 = time.perf_counter()
        try:
            run["outs"], run["ranks"] = launch("chip_smoke:dp_rank", DP_RANKS, dict(cli_dir=run["tmp"].name),
                                               timeout_s=DP_TIMEOUT_S)
        except BaseException as e:  # raised again by dp_finish
            run["error"] = e
        run["ranks_s"] = time.perf_counter() - t0

    run["thread"] = threading.Thread(target=ranks, daemon=True)
    run["thread"].start()
    return run


def dp_finish(dev, run, one_process=None, beside=None):
    """Phase 9's end: this process's references, then the ranks joined and
    each held against the others and against this process; `one_process`
    holds phase 5's and 6's timings of this call for the readings, `beside`
    names the phases this process ran while the ranks did."""
    emu_state, emu = dp_emulation(dev)  # b's reference
    ref, ref_nudged, ref_noise, ref_metrics, ref_s = dp_validation_reference(dev)  # c's
    run["thread"].join()
    if "error" in run:
        raise run["error"]
    outs, ranks, ranks_s, tmp = run["outs"], run["ranks"], run["ranks_s"], run["tmp"]
    note = "two ranks share one card through gloo: the times are readings, not a scaling figure"
    if beside:
        note += f"; the ranks ran beside this process's {beside}, sharing the host and the card with them"
    result = dict(note=note, nccl=run["nccl"])
    for r, out in enumerate(outs):
        log(f"dp: rank {r}'s output (tail):\n" + "\n".join(out.strip().splitlines()[-8:]))
    for r, res in enumerate(ranks):
        require(res["rank"] == r and res["world"] == DP_RANKS and res["backend"] == "gloo",
                f"rank {r}: rank {res['rank']} of {res['world']}, backend {res['backend']}")
        require("backend gloo" in outs[r], f"rank {r} did not print its backend")

    # b: bitwise against each other and against the emulation
    diffs = {}
    for r in range(1, DP_RANKS):
        diffs[f"rank {r} vs rank 0"] = state_diff(ranks[r]["train_state"], ranks[0]["train_state"])
    diffs["rank 0 vs one process"] = state_diff(ranks[0]["train_state"], emu_state)
    for what, (d, gap) in diffs.items():
        log(f"dp: train step, {what}: {len(d)} entries differ (parameters and Adam), largest parameter gap {gap}")
        require(not d, f"dp train step, {what}: {len(d)} entries differ, e.g. {d[:5]}, largest gap {gap}")
    for r, res in enumerate(ranks):
        for k, n in res["train_launches"].items():
            require(n > 0, f"rank {r}'s training step did not launch {k}")
    loss = ranks[0]["train_metrics"]["loss"]
    require(all(res["train_metrics"]["loss"] == loss for res in ranks) and math.isfinite(loss),
            f"the ranks' reduced losses {[res['train_metrics']['loss'] for res in ranks]}")
    log(f"dp: reduced loss {loss}, the emulation's mean of the halves {emu['loss']}")

    # c: the sharded Validator against one process's on the 8 scenes
    per = N_SCENE // DP_RANKS
    for r, res in enumerate(ranks):
        require(res["val_launches"]["K1"] > 0 and res["val_launches"]["K2"] > 0,
                f"rank {r}'s validation step did not launch K1 and K2: {res['val_launches']}")
        require(len(res["val_noise"]) == len(ref_noise) > 0, f"rank {r} drew {len(res['val_noise'])} noise tensors")
        for i, (x, y) in enumerate(zip(res["val_noise"], ref_noise)):
            k = y.shape[0] // DP_RANKS
            require(torch.equal(x, y[r * k:(r + 1) * k]), f"rank {r}'s noise draw {i} is not its rows of one process's")
    held = {}
    for what, key_p, key_v, ks in (("reactive replay", "buf_rr_preds", "buf_rr_valid", None),
                                   ("joint future K=0", "buf_jf_preds", "buf_jf_valid", slice(0, 1))):
        got = [ranks[r]["val_out"] for r in range(DP_RANKS)]
        p = torch.cat([g[key_p] for g in got]).to(dev)
        v = torch.cat([g[key_v] for g in got]).to(dev)
        sides = [(p, v), (ref[key_p], ref[key_v]), (ref_nudged[key_p], ref_nudged[key_v])]
        if ks is not None:
            sides = [(x[:, :, ks].reshape(x.shape[0], -1, *x.shape[3:]), y[:, :, ks].reshape(y.shape[0], -1, y.shape[-1]))
                     for x, y in sides]
        held[what] = compare_rollouts(*(SimpleNamespace(preds=x, valid=y) for x, y in sides),
                                      f"dp validation {what}, 2 ranks vs one process")
    keys = ("val/loss", "joint_future_pred/mean_average_precision", "reactive_replay/err/pos_meter")
    for r, res in enumerate(ranks):
        require(res["val_metrics"]["val/loss"] == ranks[0]["val_metrics"]["val/loss"], "the ranks' val/loss differ")
        require(math.isfinite(res["val_metrics"]["val/loss"]), f"rank {r}: val/loss {res['val_metrics']['val/loss']}")
    log(f"dp: validation metrics (readings), 2 ranks {[ranks[0]['val_metrics'][k] for k in keys]}, one process "
        f"{[ref_metrics[k] for k in keys]}; goal samples differing "
        f"{int((torch.cat([res['val_out']['goal_sample'] for res in ranks]) != ref['goal_sample'].cpu()).sum())}"
        f" of {ref['goal_sample'].numel()}")

    # d: the CLI on 2 ranks
    a, b = os.path.join(tmp.name, "a"), os.path.join(tmp.name, "b")
    (sa, _), (sb, _) = _state(a), _state(b)
    require(sa["epoch"] == sb["epoch"] == 2 and sa["global_step"] == sb["global_step"] == 2,
            f"dp cli: epoch / global_step: A {sa['epoch']} / {sa['global_step']}, B {sb['epoch']} / {sb['global_step']}")
    require(torch.equal(sa["rng"], sb["rng"]), "dp cli: the generator states of A and B differ")
    require(sa["opt_state"]["schedule"] == sb["opt_state"]["schedule"], "dp cli: the LR schedules' states differ")
    adam_a, adam_b = sa["opt_state"]["adam"]["state"], sb["opt_state"]["adam"]["state"]
    moments = [(i, k) for i, st in adam_a.items() for k, v in st.items() if not torch.equal(v, adam_b[i][k])]
    diff, gap = params_gap(sa, sb)
    log(f"dp cli: resumed 2-rank fit (B) vs uninterrupted 2-rank fit (A): {len(diff)} of {len(sa['params'])} "
        f"parameters and {len(moments)} Adam entries differ, largest gap {gap}")
    require(not diff and not moments, f"dp cli: the resumed fit differs: {diff[:5]} {moments[:5]}")
    require(ranks[1]["cli_written"] == [], f"rank 1 wrote {ranks[1]['cli_written'][:10]}")
    w0 = set(ranks[0]["cli_written"])
    for name in ("a/config.json", "a/metrics.jsonl", "a/ckpt/last/state.pt", "a/ckpt/best/state.pt",
                 "a/ckpt/meta.json", "b/ckpt/last/state.pt"):
        require(name in w0, f"rank 0 did not write {name}")
    require(any(p.startswith("b/submission/") for p in w0), "rank 0 wrote no submission")
    require("epoch 1 val/loss=" in outs[0] and "epoch 1 val/loss=" not in outs[1], "the epoch line's rank gating")
    require([r["phase"] for r in _records(a, "val")] == ["val", "val"], "A's metrics.jsonl: not one process's records")
    for k in CLI_KERNELS:
        require(all(res["cli_launches"][k] > 0 for res in ranks), f"the 2-rank CLI fit did not launch {k}")
    require(ranks[1]["cli_test_paths"] == [] and len(ranks[0]["cli_test_paths"]) == ExperimentConfig().n_joint_future,
            f"test's submissions: {[res['cli_test_paths'] for res in ranks]}")
    for path in ranks[0]["cli_test_paths"]:
        scenarios = submission_scenarios(path)
        ids = {wire_fields(sc)[0][1] for sc in scenarios}
        require(len(scenarios) == len(ids) == N_SCENE, f"{path}: {len(scenarios)} predictions, {len(ids)} scenario "
                                                       f"ids for {N_SCENE} scenes")
    tmp.cleanup()

    result.update(
        backend="gloo", ranks=DP_RANKS, scenes_per_rank=per, launch_s=ranks_s,
        train_launches=[res["train_launches"] for res in ranks], val_launches=[res["val_launches"] for res in ranks],
        cli_launches=[res["cli_launches"] for res in ranks],
        train_bitwise=dict(ranks_equal=True, equal_to_one_process=True, params=len(emu_state["params"])),
        train_step_ms=[res["train_step_ms"] for res in ranks], val_step_s=[res["val_step_s"] for res in ranks],
        cli_fit_s=[res["cli_fit_s"] for res in ranks],
        one_process=dict(half_step_s=emu["half_step_s"], val_step_s_8_scenes_first_call=ref_s, **(one_process or {})),
        peak_gib=[dict(train=res["train_peak_gib"], val=res["val_peak_gib"], cli=res["cli_peak_gib"]) for res in ranks],
        validation_held=held, cli_resume_bitwise=True, phase_s=time.perf_counter() - run["t_phase"],
        card=card_line(),
    )
    log(f"dp: phase 9 in {result['phase_s']} s (the ranks {ranks_s} s)")
    return result


# ------------------------------------------------------------------ 6e: the options the port once refused

EVAL_COUNTERS = {"K1": (FA, "LAUNCHES"), "K2": (NE, "LAUNCHES"), "K6": (BA, "LAUNCHES")}
# a map encode, kernels vs plain versions: one K1 layer (the polyline
# self-attention) over a node stack (its plain version both times, or K6
# against it); the layers carry the kernels' few-ulp gaps: K2's tolerance
MAP_TOL = K2_TOL
OPTION_HEADS = {"unbranched": dict(branch_type=False), "branch_layernorm": dict(use_layernorm=True),
                "log_std_mlp": dict(log_std=None)}
OPTION_MAPS = {"vectornet": (dict(densetnt_vectornet=False), {}), "mean_pool": (dict(pool_mode="mean"), {}),
               "generic_stack_gelu": ({}, dict(activation="gelu"))}
REMAT_POLICIES = ("none", "save_attn", "save_core")
# the other widths' eval rollouts, kernels vs plain: preds held over the
# first 20 steps (10 warm-up, 10 closed-loop). By step 30 the closed loop
# carries an ulp past 1e-3 m for some model seeds even at the default
# widths, through the kernels and a one-ulp map nudge alike; over 20 steps
# the kernels' gap stayed under 1.4e-4 m in 15 (width, seed) cases on an
# H100 (tools/rollout_gap_ab.py; PERF.md). The widths' runs (the eval
# rollouts and the training steps) end there; the map features are held
# beside it (MAP_TOL).
WIDTHS_HELD_STEPS = 20


def widths_config(cfg: ExperimentConfig, hidden: int, n_head: int, impl: str = "fused",
                  d_ff: Optional[int] = None) -> ExperimentConfig:
    """cfg at other widths, over WIDTHS_HELD_STEPS steps, with the default fused
    node stack (K2 in eval, K4 in training; `impl="hybrid"` for K6): as
    the override `model.hidden_dim=...` does, d_model follows hidden_dim
    and d_feedforward stays 128 (hidden 256: D = 256, F = 128) unless
    `d_ff` sets it. pe_dim is at most hidden - 32 (the input encoders'
    attribute MLP is hidden - pe_dim wide, at least 32 in the JAX package
    too): 32 at hidden 64, as the README's TINY line sets it."""
    tf = dataclasses.replace(cfg.model.tf_cfg, d_model=hidden, n_head=n_head,
                             d_feedforward=cfg.model.tf_cfg.d_feedforward if d_ff is None else d_ff)
    me = dataclasses.replace(cfg.model.map_encoder, node_encoder_impl=impl)
    m = dataclasses.replace(cfg.model, hidden_dim=hidden, pe_dim=min(cfg.model.pe_dim, hidden - 32), tf_cfg=tf,
                            map_encoder=me)
    return dataclasses.replace(cfg, model=m, time_step_end=WIDTHS_HELD_STEPS)


def site_routes(cfg: ExperimentConfig, what: str) -> dict:
    """Each kernel site's route at cfg's widths, printed and returned: the
    kernel where the JAX package runs its Pallas kernel and the port's
    predicate admits the shape, "raises: <reason>" where it refuses it,
    "plain: ..." where the JAX package runs XLA (a VMEM budget, or the
    config's node stack)."""
    d, m = cfg.data, cfg.model
    D, F, H, N = m.hidden_dim, m.tf_cfg.d_feedforward, m.tf_cfg.n_head, d.n_pl_node
    me = m.map_encoder

    def attn(kernel, S, T):
        if kernel == "K1":
            fits, reason = FA.jax_kernel_fits(S, T, D), FA.kernel_refusal(T, D, H)
        else:
            fits, reason = AT.jax_kernel_fits(S, T, D), AT.kernel_refusal(T, D, H)
        return "plain: the JAX package runs XLA here" if not fits else reason and f"raises: {reason}"

    routes = {f"{k} map self-attention ({d.n_pl}, {d.n_pl}, {D}, {H})": attn(k, d.n_pl, d.n_pl) for k in ("K1", "K3")}
    routes.update({f"{k} as2pl ({d.n_agent}, {d.n_pl}, {D}, {H})": attn(k, d.n_agent, d.n_pl) for k in ("K1", "K3")})
    eval_node = ("K6", BA.kernel_refusal(N, D, H)) if me.node_encoder_impl == "hybrid" else (
        "K2", NE.kernel_refusal(N, D, F, H))
    routes[f"{eval_node[0]} node stack ({N}, {D}, {F}, {H})"] = eval_node[1] and f"raises: {eval_node[1]}"
    k4 = NT.kernel_refusal(N, D, F, H)
    routes[f"K4 node stack ({N}, {D}, {F}, {H})"] = (
        (k4 and f"raises: {k4}") if me.fused_train_kernel else "plain: fused_train_kernel off (the JAX XLA stack)")
    out = {site: route or "kernel" for site, route in routes.items()}
    for site, route in out.items():
        log(f"{what}: {site} -> {route}")
    return out


def options_eval(cfg, batch, dev, what, held_steps: int = HELD_STEPS) -> dict:
    """An eval rollout over cfg.time_step_end steps with the eval kernels'
    counts set to 0 just before and read just after, held against the
    plain versions over `held_steps` beside a one-ulp map nudge; the map
    encoding, kernels vs plain versions, held within MAP_TOL."""
    model = O.make_model(cfg, device=dev, seed=0)
    zero_counts(EVAL_COUNTERS)
    out = O.eval_rollout(cfg, model, batch, device=dev)
    torch.cuda.synchronize()
    launches = read_counts(EVAL_COUNTERS)
    with ops.plain_versions():
        ref = O.eval_rollout(cfg, model, batch, device=dev)
        ref_nudged = O.eval_rollout(cfg, model, nudged(batch), device=dev)
    log(f"{what}: launches {launches}")
    held = compare_rollouts(out, ref, ref_nudged, f"{what}, kernels vs plain versions", held_steps=held_steps)
    pb = pre_processing(to_torch(batch, dev), cfg.model, training=False)
    n_scene = batch["map/valid"].shape[0]
    with torch.no_grad():
        feat, _ = O.encode_map_chunked(model, pb, n_scene)
        with ops.plain_versions():
            feat_plain, _ = O.encode_map_chunked(model, pb, n_scene)
    map_err = max_err_checked(feat, feat_plain, MAP_TOL, f"{what}, map features")
    log(f"{what}: map features, kernels vs plain versions, max abs err {map_err} (tolerance {MAP_TOL})")
    return dict(launches=launches, vs_plain=held, map_max_abs_err=map_err)


def options_train(cfg, batch, dev, what) -> dict:
    """One training step over cfg.time_step_end steps with the training
    kernels counted, against the plain versions at phase 5's holds."""
    zero_counts(TRAIN_COUNTERS)
    lk, gk = loss_and_grads(cfg, batch, dev, plain=False)
    launches = read_counts(TRAIN_COUNTERS)
    lp, gp = loss_and_grads(cfg, batch, dev, plain=True)
    loss_gap = abs(lk - lp) / abs(lp)
    gap, worst, median = grad_gap(gk, gp)
    log(f"{what}: launches {launches}; loss {lk} vs plain {lp} (rel {loss_gap}, tolerance {TRAIN_LOSS_RTOL}), "
        f"largest gradient rel norm error {gap} at {worst}, median {median} (tolerance {TRAIN_GRAD_RTOL})")
    require(math.isfinite(lk) and loss_gap <= TRAIN_LOSS_RTOL, f"{what}: loss differs by rel {loss_gap}")
    require(gap <= TRAIN_GRAD_RTOL, f"{what}: gradient {worst} differs by rel {gap}")
    return dict(launches=launches, loss_rel=loss_gap, grad_rel=gap)


def option_map_encode(cfg, batch, dev, what, expect=(("K1", 1), ("K2", 0))) -> dict:
    """One eval map encode of every scene, kernels vs plain versions, its
    launch counts as `expect` says."""
    model = O.make_model(cfg, device=dev, seed=0)
    pb = pre_processing(to_torch(batch, dev), cfg.model, training=False)
    n_scene = batch["map/valid"].shape[0]
    zero_counts(EVAL_COUNTERS)
    with torch.no_grad():
        feat, valid = O.encode_map_chunked(model, pb, n_scene)
    torch.cuda.synchronize()
    launches = read_counts(EVAL_COUNTERS)
    with torch.no_grad(), ops.plain_versions():
        ref, ref_valid = O.encode_map_chunked(model, pb, n_scene)
    require(torch.equal(valid, ref_valid), f"{what}: polyline validity differs")
    err = max_err_checked(feat, ref, MAP_TOL, what)
    log(f"{what}: launches {launches}, map feature max abs err {err} (tolerance {MAP_TOL})")
    require(all(launches[k] == n for k, n in expect), f"{what}: launches {launches}, {dict(expect)} expected")
    return dict(launches=launches, max_abs_err=err)


def remat_step(cfg, batch, dev) -> dict:
    """One training step's forward and backward under cfg.remat_policy:
    seconds of each, the memory the forward leaves for the backward, the
    peak, the training kernels' counts, the loss and gradients."""
    model = O.make_model(cfg, device=dev, seed=0)
    tb = to_torch(batch, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(TRAIN_COUNTERS)
    t0 = time.perf_counter()
    loss, _ = O.training_step(cfg, model, tb, torch.Generator().manual_seed(7))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    residual_gib = (torch.cuda.memory_allocated() - base) / 2**30
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = {n: p.grad.detach() for n, p in model.named_parameters() if p.grad is not None}
    return dict(loss=loss.item(), grads=grads, forward_s=t1 - t0, backward_s=t2 - t1, residual_gib=residual_gib,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=read_counts(TRAIN_COUNTERS))


def remat_policies(cfg, batch, dev) -> dict:
    """(c) One full-width training step over HELD_STEPS steps under each
    remat policy: the loss and the largest gradient gap against
    "save_attn" (held at phase 5's limits), the peak and residual GiB,
    forward and backward seconds, K3f's launches (its recompute)."""
    runs = {p: remat_step(dataclasses.replace(cfg, time_step_end=HELD_STEPS, remat_policy=p), batch, dev)
            for p in REMAT_POLICIES}
    ref = runs["save_attn"]
    out = {}
    for policy, r in runs.items():
        loss_gap = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        gap, worst, _ = grad_gap(r["grads"], ref["grads"])
        bitwise = r["loss"] == ref["loss"] and all(torch.equal(r["grads"][n], g) for n, g in ref["grads"].items())
        out[policy] = dict(loss=r["loss"], loss_rel=loss_gap, grad_rel=gap, bitwise=bitwise,
                           forward_s=r["forward_s"], backward_s=r["backward_s"], residual_gib=r["residual_gib"],
                           peak_gib=r["peak_gib"], launches=r["launches"])
        log(f"remat_policy={policy!r}, {HELD_STEPS} steps: loss {r['loss']} (rel {loss_gap} from save_attn), "
            f"largest gradient gap {gap} at {worst}, bitwise save_attn's {bitwise}; forward {r['forward_s']} s, "
            f"backward {r['backward_s']} s, residual {r['residual_gib']} GiB after the forward, peak "
            f"{r['peak_gib']} GiB, launches {r['launches']} [{card_line()}]")
        require(math.isfinite(r["loss"]) and loss_gap <= TRAIN_LOSS_RTOL, f"{policy}: loss differs by rel {loss_gap}")
        require(gap <= TRAIN_GRAD_RTOL, f"{policy}: gradient {worst} differs by rel {gap}")
    return out


# the options phase's widths: (name, hidden_dim, n_head, d_feedforward)
OPTION_WIDTHS = (("hidden256", 256, 4, 128), ("heads2", 128, 2, 128), ("hidden256_heads2", 256, 2, 128),
                 ("heads16", 128, 16, 128), ("heads32", 128, 32, 128), ("hidden64", 64, 4, 128),
                 ("tiny_widths", 64, 2, 64))
# the node kernels' builds the options phase runs beside the default 128 x 128
OPTION_BUILDS = tuple(dict.fromkeys((name, NE.build_defines(D, Fd)) for _, D, _, Fd in OPTION_WIDTHS
                                    if (D, Fd) != (NE.KERNEL_D, NE.KERNEL_D)
                                    for name in ("node_encoder", "node_encoder_train")))


def options_path(cfg, batch, dev) -> dict:
    """(a) Other widths (OPTION_WIDTHS), the default fused node stack: at
    hidden 256 (the override `model.hidden_dim=256`: D = 256, F = 128, 4
    heads), at 2 heads of width 128, at hidden 256 with 2 heads (d_head
    128), at hidden 128 with 16 and 32 heads (d_head 8 and 4), at hidden
    64 (the override `model.hidden_dim=64`: D = 64, F = 128, 4 heads) and
    at the tests/tiny.py widths (D = F = 64, 2 heads), an eval rollout (K1,
    K2) and a training step (K3, K4, K5), each site's route printed (every
    K1, K3, K2 and K4 site "kernel"), each run held against the plain
    versions (the evals over WIDTHS_HELD_STEPS); at hidden 256 one hybrid
    map encode (K6 at d_model 256). (b) Structure options:
    post-norm layers with the final MLP under each action-head variant, an
    eval rollout each (K1 at its sites, the generic node stack for the
    post-norm layer, no K2); one map encode each for VectorNet, the mean
    pool and the generic node stack. (c) The remat policies."""
    t0 = time.perf_counter()
    out = dict(widths={}, structure={}, map_encodes={})
    for name, hidden, n_head, d_ff in OPTION_WIDTHS:
        t0_width = time.perf_counter()
        c = widths_config(cfg, hidden, n_head, d_ff=d_ff)
        what = f"hidden {hidden}, {n_head} heads, d_ff {d_ff}"
        r = out["widths"][name] = dict(routes=site_routes(c, what))
        # every K1, K3, K2 and K4 site takes its kernel
        require(all(route == "kernel" for route in r["routes"].values()),
                f"{what}: a site does not take its kernel: {r['routes']}")
        e = r["eval"] = options_eval(c, batch, dev, f"{what}, eval", held_steps=WIDTHS_HELD_STEPS)
        require(e["launches"]["K1"] > 0 and e["launches"]["K2"] == 1 and e["launches"]["K6"] == 0,
                f"{what} eval launches {e['launches']}")
        t = r["train"] = options_train(c, batch, dev, f"{what}, training step")
        require(t["launches"]["K3f"] > 0 and t["launches"]["K3b"] > 0 and t["launches"]["K5"] > 0
                and t["launches"]["K4f"] == t["launches"]["K4b"] == 1, f"{what} training launches {t['launches']}")
        if hidden == 256:
            r["hybrid_map_encode"] = option_map_encode(
                widths_config(cfg, hidden, n_head, impl="hybrid"), batch, dev, f"{what}, hybrid map encode",
                expect=(("K1", 1), ("K2", 0), ("K6", 3)))
        r["seconds"] = time.perf_counter() - t0_width
        log(f"{what}: {r['seconds']} s")
    for name, head in OPTION_HEADS.items():
        m = dataclasses.replace(cfg.model, tf_cfg=dataclasses.replace(cfg.model.tf_cfg, norm_first=False),
                                n_layer_final_mlp=2)
        c = dataclasses.replace(cfg, model=m, action_head=dataclasses.replace(cfg.action_head, **head),
                                time_step_end=HELD_STEPS)
        r = out["structure"][name] = options_eval(c, batch, dev, f"post-norm, final MLP, {name} action head, eval")
        require(r["launches"]["K1"] > 0 and r["launches"]["K2"] == 0, f"{name}: launches {r['launches']}")
    for name, (me, tf) in OPTION_MAPS.items():
        m = dataclasses.replace(cfg.model, map_encoder=dataclasses.replace(cfg.model.map_encoder, **me),
                                tf_cfg=dataclasses.replace(cfg.model.tf_cfg, **tf))
        out["map_encodes"][name] = option_map_encode(dataclasses.replace(cfg, model=m), batch, dev,
                                                     f"{name} map encode")
    out["remat"] = remat_policies(cfg, batch, dev)
    out["seconds"] = time.perf_counter() - t0
    log(f"options: {out['seconds']} s [{card_line()}]")
    return out


# ------------------------------------------------------------------ long maps (phase 6f)

LONG_PL = 2048  # data.n_pl of phase 6f: every attention over the map has T = 2,048
LONG_FILL = (1536, FILL_AGENTS)  # valid polylines and agents: bench.py's 3/4 map fill
# the kernels alone: (name, B, S, T, bf16 K/V at the site, the K1 variants it runs, K3 too)
LONG_SITES = (("rollout as2pl", N_SCENE, 64, LONG_PL, True, ("K1", "K1-bf16", "K1-skip"), True),
              (K1_B48, 6 * N_SCENE, 64, LONG_PL, True, ("K1", "K1-bf16"), False),
              ("map polyline self-attention", N_SCENE, LONG_PL, LONG_PL, False, ("K1", "K1-bf16", "K1-skip"), True),
              ("latent as2pl", N_SCENE, 19 * 64, LONG_PL, False, ("K1", "K1-bf16", "K1-skip"), True),
              ("rollout as2pl", N_SCENE, 64, 2 * LONG_PL, True, ("K1",), True))
LONG_COUNTERS = dict(EVAL_COUNTERS, **BF16_COUNTERS, **TRAIN_COUNTERS)
ATTENTION_SITES = ("fused_attention_core", "attention_train", "attention_core_plain", "attention_train_plain")


@contextlib.contextmanager
def recorded_attention_sites(sites: set):
    """Every attention core call of the model (models.modules' K1 and K3
    wrappers and their plain versions) while the kernels are enabled (not
    a reference run under ops.plain_versions) recorded into `sites` as
    (function, S, T, q dtype) while the context is open."""
    saved = {name: getattr(MM, name) for name in ATTENTION_SITES}

    def spy(name, fn):
        def call(q, k, *a, **kw):
            if ops.kernels_enabled():
                sites.add((name, q.shape[1], k.shape[1], str(q.dtype).replace("torch.", "")))
            return fn(q, k, *a, **kw)
        return call

    for name, fn in saved.items():
        setattr(MM, name, spy(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(MM, name, fn)


def long_routes(sites: set, n_pl: int, what: str) -> dict:
    """Each recorded attention site's route: the kernel its wrapper launched
    (K1, K1-bf16, K3), or the plain version; every site over the map (T =
    n_pl) must take its kernel."""
    names = {"fused_attention_core": "K1", "attention_train": "K3"}
    routes = {}
    for name, S, T, dt in sorted(sites):
        kernel = names.get(name)
        route = "plain" if kernel is None else kernel + ("-bf16" if kernel == "K1" and dt == "bfloat16" else "")
        routes[f"S={S} T={T} {dt}"] = route if kernel else f"plain ({name})"
        require(T != n_pl or kernel is not None, f"{what}: the site S={S} T={T} took the plain version")
    for site, route in routes.items():
        log(f"{what}: {site} -> {route}")
    return routes


def k1_long(variant, args, mask_bytes, src):
    """One K1 variant at a long-map site: its output held against its plain
    version (K1-bf16 within a one-bf16-ulp input nudge's gap, K1-skip with
    live rows bitwise K1's), two calls bitwise equal; its device ms, bound,
    plain ms and SDPA's device ms on the same inputs."""
    q, k, v, invalid, H = args
    allowed = ~invalid
    if variant == "K1-bf16":
        args = (q.bfloat16(), k.bfloat16(), v.bfloat16(), invalid, H)
    kw = dict(src_invalid=src) if variant == "K1-skip" else {}
    got, again = FA.fused_attention_core(*args, **kw), FA.fused_attention_core(*args, **kw)
    torch.cuda.synchronize()
    require(torch.equal(got, again), f"{variant}: not bitwise reproducible")
    ref = FA.attention_core_plain(*args, **kw)
    row = {}
    if variant == "K1-bf16":
        held = bf16_held(variant, got, ref, FA.attention_core_plain(bf16_up(args[0]), *args[1:]))
        row.update(max_abs_err=held["vs_plain"]["max_abs"], **held)
        b_ms, b_by = bound_ms_bf16(2 * q.numel() * 2 + 2 * k.numel() * 2 + mask_bytes,
                                   4 * q.shape[-1] * int(allowed.sum().item()))
        lib = sdpa_device_ms(*args[:3], allowed, H)
    elif variant == "K1-skip":
        live = FA.row_live(invalid, src)
        base = FA.fused_attention_core(*args)
        require(bool((got[~live] == 0).all()) and torch.equal(got[live], base[live]),
                f"{variant}: dead rows not 0 or live rows not K1's")
        row["max_abs_err"] = max_err_checked(got, ref, K1_TOL, variant)
        b_ms, b_by = skip_bound(q, k, invalid, src, mask_bytes, False)
        lib = sdpa_device_ms(q, k.float(), v.float(), allowed & live[..., None], H)
    else:
        row["max_abs_err"] = max_err_checked(got, ref, K1_TOL, variant)
        b_ms, b_by = k1_bound(args, mask_bytes)
        lib = sdpa_device_ms(q, k.float(), v.float(), allowed, H)
    row.update(device_ms=graph_ms(lambda: FA.fused_attention_core(*args, **kw), n=5),
               plain_ms=time_ms(lambda: FA.attention_core_plain(*args, **kw), n=3, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_device_ms=lib)
    return row


def k3_long(args, mask_bytes, g, seed):
    """K3f and K3b at a long-map site, dropout live: the forward within
    K3_TOL and the gradients within K3_GRAD_RTOL of the plain version's,
    the backward twice bitwise equal; each one's device ms, bound and
    SDPA's device ms (forward from a graph, backward from the profiler)."""
    q, k, v, invalid, H = args
    B, S, D = q.shape

    def run(fn):
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o_ = fn(qq, kk, vv, invalid, H, P_DROP, seed, 0)
        return o_, torch.autograd.grad(o_, (qq, kk, vv), g)

    got, grads = run(AT.attention_train)
    _, grads2 = run(AT.attention_train)
    ref, ref_grads = run(AT.attention_train_plain)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(grads, grads2)), "K3b: not bitwise reproducible")
    ef = max_err_checked(got.detach(), ref.detach(), K3_TOL, "K3f")
    eb = grads_checked(grads, ref_grads, ("dq", "dk", "dv"), K3_GRAD_RTOL, "K3b")
    o, rmax, rsum = AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0)
    lib_fwd, lib_leaves = sdpa_train(q, k, v, invalid, H)
    with torch.no_grad():
        lib_f = graph_ms(lib_fwd, n=5)
        plain_f = time_ms(lambda: AT.attention_train_plain(q, k, v, invalid, H, P_DROP, seed, 0), n=3, warmup=1)
    lib_out = lib_fwd()
    gh = g.view(B, S, H, -1).transpose(1, 2)
    n_pairs = int((~invalid).sum().item())
    io = (2 * q.numel() + 2 * k.numel()) * 4 + mask_bytes + 2 * B * H * S * 4
    bf, bf_by = bound_ms(io, 4 * D * n_pairs)
    bb, bb_by = bound_ms(io + (2 * q.numel() + 2 * k.numel()) * 4, 8 * D * n_pairs)
    fwd = dict(max_abs_err=ef, device_ms=graph_ms(lambda: AT._launch_fwd(q, k, v, invalid, H, P_DROP, seed, 0), n=5),
               plain_ms=plain_f, bound_ms=bf, bound_by=bf_by, library_device_ms=lib_f)
    bwd = dict(max_abs_err=eb, device_ms=graph_ms(lambda: AT._launch_bwd(q, k, v, invalid, o, rmax, rsum, g, H, P_DROP,
                                                                         seed, 0), n=5),
               bound_ms=bb, bound_by=bb_by,
               library_device_ms=profiled_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, gh, retain_graph=True),
                                             n=3))
    return fwd, bwd


def check_long_keys(dev) -> dict:
    """(a) The kernels alone past 1,024 keys: K1 (the site's K/V type),
    K1-bf16 and K1-skip (agents 40.. dead), K3f and K3b at the rollout
    as2pl, the map self-attention and the latent as2pl at T = 2,048, K1 and
    K1-bf16 at the joint futures' B = 48, K1 and K3 at the rollout as2pl at
    T = 4,096; the last quarter of the keys masked. Each row: held against
    its plain version, device ms, bound, plain ms, SDPA's device ms, and
    the same kernel's device ms at T = 1,024 on the same site."""
    out = {"K1": [], "K1-bf16": [], "K1-skip": [], "K3f": [], "K3b": []}
    for i, (name, B, S, T, kv_bf16, variants, k3) in enumerate(LONG_SITES):
        gen = torch.Generator().manual_seed(2048 + i)
        args, mask_bytes = k1_case(gen, B, S, T, kv_bf16, 0.25, False, dev)
        short, _ = k1_case(torch.Generator().manual_seed(1024 + i), B, 1024 if S == T else S, 1024, kv_bf16, 0.25,
                           False, dev)
        src = dead_agents(B, S, FILL_AGENTS, dev)
        for variant in variants:
            row = dict(site=name, B=B, S=S, T=T, **k1_long(variant, args, mask_bytes, src))
            sq, sk, sv, sinv, sh = short
            sa = (sq.bfloat16(), sk.bfloat16(), sv.bfloat16(), sinv, sh) if variant == "K1-bf16" else short
            skw = dict(src_invalid=dead_agents(B, sq.shape[1], FILL_AGENTS, dev)) if variant == "K1-skip" else {}
            row["device_ms_at_1024"] = graph_ms(lambda: FA.fused_attention_core(*sa, **skw), n=5)
            out[variant].append(row)
            log(f"{variant} long keys, {name}: {row} [{card_line()}]")
        if not k3:
            continue
        g = torch.randn(B, S, 128, generator=gen).to(dev)
        a32 = (args[0], args[1].float(), args[2].float(), args[3], args[4])
        fwd, bwd = k3_long(a32, mask_bytes, g, 2**42 + T)
        s32 = (short[0], short[1].float(), short[2].float(), short[3], short[4])
        o, rmax, rsum = AT._launch_fwd(*s32, P_DROP, 7, 0)
        gs = torch.randn(*s32[0].shape, generator=gen).to(dev)
        fwd["device_ms_at_1024"] = graph_ms(lambda: AT._launch_fwd(*s32, P_DROP, 7, 0), n=5)
        bwd["device_ms_at_1024"] = graph_ms(lambda: AT._launch_bwd(*s32[:4], o, rmax, rsum, gs, s32[4], P_DROP, 7, 0),
                                            n=5)
        out["K3f"].append(dict(site=name, B=B, S=S, T=T, **fwd))
        out["K3b"].append(dict(site=name, B=B, S=S, T=T, **bwd))
        log(f"K3 long keys, {name}: fwd {out['K3f'][-1]} bwd {out['K3b'][-1]} [{card_line()}]")
    return out


def long_map_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """cfg with data.n_pl = LONG_PL over HELD_STEPS steps (the depth cut:
    the runs end where the main paths' holds end)."""
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_pl=LONG_PL), time_step_end=HELD_STEPS)


def long_map_eval(cfg, dev) -> dict:
    """Phase 6f, `data.n_pl = 2048` at full width (1,536 of 2,048
    polylines and 40 of 64 agents valid, seed 0), its parts that need no
    K4 (the full run runs them while K4's sources compile): (a)
    check_long_keys; (b) an eval rollout against the plain versions beside
    a one-ulp map nudge (held as the main path over HELD_STEPS) and one
    bf16 eval (held by its order of passage beside the nudge), each with
    every attention site's route and its kernels' launch counts, set to 0
    just before each run and read just after. long_map_train adds the
    training step."""
    t0 = time.perf_counter()
    out = dict(kernels=check_long_keys(dev))
    c = long_map_config(cfg)
    batch = long_map_batch(c)
    sites = set()
    model = O.make_model(c, device=dev, seed=0)
    zero_counts(LONG_COUNTERS)
    with recorded_attention_sites(sites):
        res = O.eval_rollout(c, model, batch, device=dev)
        torch.cuda.synchronize()
    launches = read_counts(LONG_COUNTERS)
    with ops.plain_versions():
        ref = O.eval_rollout(c, model, batch, device=dev)
        ref_nudged = O.eval_rollout(c, model, nudged(batch), device=dev)
    log(f"long map eval: launches {launches}")
    require(launches["K1"] > 0 and launches["K2"] == 1 and launches["K1-bf16"] == 0, f"long map eval: {launches}")
    out["eval"] = dict(routes=long_routes(sites, LONG_PL, "long map eval"), launches=launches,
                       vs_plain=compare_rollouts(res, ref, ref_nudged, "long map eval, kernels vs plain versions"))
    sites.clear()
    with recorded_attention_sites(sites):
        bf16 = eval_bf16(c, batch, dev, matmul_bf16=False, n_iter=0)
    out["bf16_eval"] = dict(routes=long_routes(sites, LONG_PL, "long map bf16 eval"), **bf16)
    out["seconds"] = time.perf_counter() - t0
    log(f"long map, kernels and eval runs: {out['seconds']} s [{card_line()}]")
    return out


def long_map_batch(c: ExperimentConfig) -> dict:
    return synthetic_episode_batch(c.data, n_scene=N_SCENE, seed=0, n_valid_pl=LONG_FILL[0], n_valid_agent=LONG_FILL[1])


def long_map_train(cfg, dev, out: dict) -> dict:
    """Phase 6f's training step at `data.n_pl = 2048` (loss and gradients
    at phase 5's holds), its attention sites' routes and launch counts,
    into long_map_eval's `out`."""
    t0 = time.perf_counter()
    c = long_map_config(cfg)
    sites = set()
    with recorded_attention_sites(sites):
        train = options_train(c, long_map_batch(c), dev, "long map training step")
    require(train["launches"]["K3f"] > 0 and train["launches"]["K3b"] > 0 and train["launches"]["K4f"] == 1,
            f"long map training launches {train['launches']}")
    out["train"] = dict(routes=long_routes(sites, LONG_PL, "long map training step"), **train)
    out["seconds"] += time.perf_counter() - t0
    log(f"long map: {out['seconds']} s [{card_line()}]")
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this smoke run needs one NVIDIA GPU")
    dev = O.resolve_device("cuda")  # also turns TF32 off
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    modes = {(): KERNEL_SOURCES + WIDE_BUILDS, ("--attention",): ("fused_attention", "attention_train"),
             ("--node",): ("node_encoder", "node_encoder_train", "block_attn") + WIDE_BUILDS,
             ("--cli",): KERNEL_SOURCES, ("--ablations",): KERNEL_SOURCES, ("--dp",): DP_KERNELS,
             ("--media",): ("fused_attention", "node_encoder"), ("--augment",): DP_KERNELS,
             ("--bf16",): KERNEL_SOURCES, ("--row-skip",): DP_KERNELS, ("--options",): KERNEL_SOURCES + OPTION_BUILDS,
             ("--long-map",): DP_KERNELS}
    mode = tuple(sys.argv[1:])
    if mode not in modes:
        sys.exit(f"chip_smoke.py: unknown arguments {sys.argv[1:]} (none, --attention, --node, --cli, --ablations, "
                 "--dp, --media, --augment, --bf16, --row-skip, --options or --long-map)")
    t0 = time.perf_counter()
    # the full run's K4 sources (the longest nvcc) compile beside the checks
    # of K1, K2, K5 and K3, which do not need them
    late = tuple(b for b in modes[mode] if not mode and (b if isinstance(b, str) else b[0]) == "node_encoder_train")
    late_build = concurrent.futures.ThreadPoolExecutor(1).submit(cuda_build.build_all, late) if late else None
    # K2's other widths (phase 3b and 6e) compile once the first batch is
    # built: fewer nvcc processes than cores beside K4's
    wide = tuple(b for b in modes[mode] if not mode and b in WIDE_BUILDS and b not in late)
    build_s = cuda_build.build_all([b for b in modes[mode] if b not in late and b not in wide])
    wide_build = concurrent.futures.ThreadPoolExecutor(1).submit(cuda_build.build_all, wide) if wide else None
    log(f"build: {build_s} (wall {time.perf_counter() - t0:.1f} s)")

    gen = torch.Generator().manual_seed(0)
    if mode == ("--attention",):  # K1 and K3 at their sites alone: a quick check, or code against code in one call
        phase("attention kernel checks")
        k1 = check_k1(gen, N_SCENE, dev)
        k3f, k3b = check_k3(gen, N_SCENE, dev)
        phase("attention kernels at d_head 128")
        wide = check_attention_d_head_128(dev)
        phase("attention kernels at d_head 8 and 4")
        narrow = check_attention_narrow(dev)
        log(json.dumps({"attention": {"K1": k1, "K3f": k3f, "K3b": k3b, "d_head_128": wide, **narrow}}))
        phase("done")
        return
    cfg = ExperimentConfig()
    batch = synthetic_episode_batch(cfg.data, n_scene=N_SCENE, seed=0, n_valid_pl=768, n_valid_agent=40)
    if mode == ("--cli",):  # the CLI runner alone (its metric keys not held against the validation phase's)
        phase("CLI runner")
        log(json.dumps({"cli_path": cli_path(batch, dev, None)}))
        phase("done")
        return
    if mode == ("--dp",):  # data parallelism alone
        phase("data parallelism")
        log(json.dumps({"data_parallel": dp_finish(dev, dp_start(dev))}))
        phase("done")
        return
    if mode == ("--media",):  # the validation media's device side alone
        phase("validation media")
        log(json.dumps({"media": media_path(cfg, batch, dev)}))
        phase("done")
        return
    if mode == ("--augment",):  # the training-input augmentations alone
        phase("training-input augmentations")
        log(json.dumps({"augment": augment_path(cfg, batch, dev)}))
        phase("done")
        return
    if mode == ("--bf16",):  # the bf16 configurations alone
        phase("bf16 configurations")
        log(json.dumps({"bf16": bf16_path(cfg, batch, dev)}))
        phase("done")
        return
    if mode == ("--row-skip",):  # the dead-query-row skip alone
        phase("dead-query-row skip")
        log(json.dumps({"row_skip": row_skip_path(cfg, batch, dev)}))
        phase("done")
        return
    if mode == ("--options",):  # the options the port once refused alone, to the contract's last line
        phase("options: routing by shape, structure options, remat policies")
        log(json.dumps({"options": options_path(cfg, batch, dev)}))
        phase("done")
        log(f"card: {card}")
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return
    if mode == ("--long-map",):  # data.n_pl = 2048 alone, to the contract's last line
        phase("long map: data.n_pl = 2048")
        log(json.dumps({"long_map": long_map_train(cfg, dev, long_map_eval(cfg, dev))}))
        phase("done")
        log(f"card: {card}")
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return
    if mode == ("--ablations",):  # the ablation models and the interactive sim alone
        phase("ablations and interactive")
        log(json.dumps({"ablations": ablation_path(cfg, batch, dev)}))
        phase("done")
        return
    if mode == ("--node",):  # K2, K4 and K6 on the inputs a full run gives them; K2-bf16; the other widths
        phase("node kernel checks")
        k2 = check_k2(replayed_generator("K2", N_SCENE, batch), N_SCENE, dev, batch)
        k4f, k4b = check_k4(replayed_generator("K4", N_SCENE, batch), N_SCENE, dev, batch)
        k6, hybrid = check_k6(replayed_generator("K6", N_SCENE, batch), N_SCENE, dev, batch)
        k2_bf16 = check_k2_bf16(dev, batch)
        phase("node kernels at other widths")
        widths = check_node_widths(dev, batch)
        log(json.dumps({"node": {"K2": k2, "K4f": k4f, "K4b": k4b, "K6": k6, "hybrid": hybrid, "K2-bf16": k2_bf16,
                                 "other_widths": widths}}))
        phase("done")
        log(f"card: {card}")
        return
    phase("kernel checks")
    k1 = check_k1(gen, N_SCENE, dev)
    require(torch.equal(gen.get_state(), replayed_generator("K2", N_SCENE, batch).get_state()),
            "replayed_generator does not replay K1's draws")
    k2 = check_k2(gen, N_SCENE, dev, batch)
    k5 = check_k5(dev)
    k3f, k3b = check_k3(gen, N_SCENE, dev)
    phase("attention kernels at d_head 128")
    wide_attn = {"d_head_128": check_attention_d_head_128(dev)}
    phase("attention kernels at d_head 8 and 4")
    wide_attn.update(check_attention_narrow(dev))
    phase("long map: data.n_pl = 2048, its kernels and eval runs (beside K4's build)")
    long_map = long_map_eval(cfg, dev)
    phase("small config, card vs CPU (beside K4's build)")
    small = small_reference(cfg, dev)
    phase("bf16 configurations: the kernels, the validation step (beside K4's build)")
    bf16_first = bf16_early(cfg, batch, dev)
    phase("validation media (beside K4's build)")
    media = media_path(cfg, batch, dev)
    late_s = dict(late_build.result(), **wide_build.result())
    log(f"build, beside the checks above: {late_s} (wall {time.perf_counter() - t0:.1f} s)")
    phase("kernel checks: K4 and K6")
    require(torch.equal(gen.get_state(), replayed_generator("K4", N_SCENE, batch).get_state()),
            "replayed_generator does not replay the draws before K4's")
    k4f, k4b = check_k4(gen, N_SCENE, dev, batch)
    require(torch.equal(gen.get_state(), replayed_generator("K6", N_SCENE, batch).get_state()),
            "replayed_generator does not replay the draws before K6's")
    k6, hybrid = check_k6(gen, N_SCENE, dev, batch)
    phase("node kernels at other widths")
    widths = check_node_widths(dev, batch)

    phase("eval main path")
    launches, path = main_path(cfg, batch, N_ITER, dev)
    path["small_config_vs_cpu"] = small
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
    phase("training-input augmentations")
    augment = augment_path(cfg, batch, dev)
    phase("bf16 configurations")
    bf16 = bf16_path(cfg, batch, dev, {k: path[k] for k in ("seconds", "agent_steps_per_s", "peak_gib")},
                     bf16_first)
    phase("dead-query-row skip")
    skip = row_skip_path(cfg, batch, dev)
    phase("options: routing by shape, structure options, remat policies")
    options = options_path(cfg, batch, dev)
    phase("long map: data.n_pl = 2048, its training step")
    long_map_train(cfg, dev, long_map)
    phase("data parallelism: the ranks start, and run beside phases 7 and 8")
    dp_run = dp_start(dev)
    phase("CLI runner")
    cli = cli_path(batch, dev, val.pop("metric_keys"))
    phase("ablations and interactive")
    abl = ablation_path(cfg, batch, dev)
    phase("data parallelism: references, the ranks joined")
    dp = dp_finish(dev, dp_run, dict(train_step_ms_8_scenes=train["train_step_ms"], val_step_s_8_scenes_hybrid=val["step_s"]),
                   beside="phases 7 and 8 and its references for b and c")
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
        dict(name="K1-bf16 fused_attention_core on bf16 q/k/v (precision=bf16: bf16 MMAs with fp32 accumulation, "
                  "logits and weights in registers, weights rounded to bf16, bf16 output)",
             route="cuda", source="trafficbots_tpu_torch/csrc/fused_attention.cu",
             replaces="trafficbots_tpu/ops/fused_attention.py:123", launches=bf16["eval"]["launches"]["K1-bf16"],
             **bf16["K1_bf16"]),
        dict(name="K2-bf16 FusedNodeEncoder.encode_pooled with bf16 matmul operands (kernel_matmul_bf16: the dense "
                  "products as bf16 MMAs with fp32 accumulation)",
             route="cuda", source="trafficbots_tpu_torch/csrc/node_encoder.cu",
             replaces="trafficbots_tpu/ops/node_encoder.py:245", launches=bf16["eval"]["launches"]["K2-bf16"],
             **bf16["K2_bf16"]),
        dict(name="K6-bf16 block_attn_core with bf16 operands (kernel_matmul_bf16, hybrid node encoder: both "
                  "products as bf16 MMAs with fp32 accumulation, a warp a polyline's head)",
             route="cuda", source="trafficbots_tpu_torch/csrc/block_attn.cu",
             replaces="trafficbots_tpu/ops/node_encoder.py:163", launches=bf16["validation"]["launches"]["K6-bf16"],
             **bf16["K6_bf16"]),
        dict(name="K1-skip fused_attention_core with src_invalid (attn_row_block >= 0: dead query rows written 0, "
                  "an all-dead block or cluster skipped)", route="cuda",
             source="trafficbots_tpu_torch/csrc/fused_attention.cu",
             replaces="trafficbots_tpu/ops/fused_attention.py:73", launches=skip["eval"]["launches"][0]["K1-skip"],
             **skip["K1_skip"]),
        dict(name="K3f-skip attention_train forward with src_invalid (dead query rows 0, row max -inf)", route="cuda",
             source="trafficbots_tpu_torch/csrc/attention_train.cu",
             replaces="trafficbots_tpu/ops/attention_train.py:215", launches=train_launches["K3f-skip"],
             **skip["K3f_skip"]),
        dict(name="K3b-skip attention_train backward of a skipping forward (dead rows dropped by their row max)",
             route="cuda", source="trafficbots_tpu_torch/csrc/attention_train.cu",
             replaces="trafficbots_tpu/ops/attention_train.py:260", launches=train_launches["K3b-skip"],
             **skip["K3b_skip"]),
    ]
    for k in kernels:  # the readings at the other widths, beside each kernel's default row
        key = k["name"].split(" ")[0]
        if key in ("K2", "K2-bf16", "K4f", "K4b"):
            k["other_widths"] = {name: r[key] for name, r in widths.items() if key in r}
        for width, rows in wide_attn.items():  # phase 3a: d_head 128, 8 and 4
            if key in rows:
                k[width] = rows[key]
        long_key = {"K3f-skip": None, "K3b-skip": None}.get(key, key)
        if long_key in long_map["kernels"]:
            k["long_keys"] = long_map["kernels"][long_key]
    for k in kernels:
        require(all(math.isfinite(k[f]) for f in ("ms", "device_ms", "plain_ms", "bound_ms", "max_abs_err")), str(k))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"main_path": path}))
    log(json.dumps({"training_path": train}))
    log(json.dumps({"validation_path": val}))
    log(json.dumps({"media": media}))
    log(json.dumps({"augment": augment}))
    log(json.dumps({"bf16": bf16}))
    log(json.dumps({"row_skip": skip}))
    log(json.dumps({"options": options}))
    log(json.dumps({"long_map": {k: v for k, v in long_map.items() if k != "kernels"}}))
    log(json.dumps({"cli_path": cli}))
    log(json.dumps({"ablations": abl}))
    log(json.dumps({"data_parallel": dp}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        import multiprocessing

        for p in multiprocessing.active_children():  # phase 9's ranks, when they still run
            p.kill()
        raise
