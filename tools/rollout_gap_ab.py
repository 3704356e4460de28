"""How far the eval rollout's closed loop carries each eval kernel's rounding,
on one card.

    python3 tools/rollout_gap_ab.py [--hidden 128] [--heads 2] [--seeds 0 1 2]

At full width (`ExperimentConfig()`, 8 seed-0 synthetic scenes at 768 of
1024 polylines and 40 of 64 agents valid, 30 steps), with the hybrid node
encoder (K6) at the given hidden width and head count, for each model seed:
the rollout through the plain versions is the reference, and beside it are
printed the gaps of the rollout through every kernel, through K1 alone (K6's
plain version), through K6 alone (K1's plain version) and of the plain
rollout on a one-ulp map nudge: each gap's largest value over the first 20
and 30 steps (metres) and the first step over each threshold, and the map
encoding's largest gap through the kernels. One JSON line a seed, then the
card's name and power limit. Needs an NVIDIA GPU with nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from trafficbots_tpu_torch import ops  # noqa: E402
from trafficbots_tpu_torch import orchestration as O  # noqa: E402
from trafficbots_tpu_torch.config import ExperimentConfig  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import pre_processing, to_torch  # noqa: E402
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch  # noqa: E402
from trafficbots_tpu_torch.models import modules as TM  # noqa: E402
from trafficbots_tpu_torch.ops import block_attn as BA  # noqa: E402
from trafficbots_tpu_torch.ops import cuda_build  # noqa: E402
from trafficbots_tpu_torch.ops import fused_attention as FA  # noqa: E402
from trafficbots_tpu_torch.ops import node_encoder as NE  # noqa: E402

STEPS = 30
THRESHOLDS = (1e-5, 1e-4, 1e-3, 1e-2)


def config(hidden: int, n_head: int) -> ExperimentConfig:
    cfg = ExperimentConfig()
    tf = dataclasses.replace(cfg.model.tf_cfg, d_model=hidden, n_head=n_head, d_feedforward=hidden)
    me = dataclasses.replace(cfg.model.map_encoder, node_encoder_impl="hybrid")
    return dataclasses.replace(cfg, time_step_end=STEPS, model=dataclasses.replace(
        cfg.model, hidden_dim=hidden, tf_cfg=tf, map_encoder=me))


def gap(out, ref) -> dict:
    d = (out.preds.float().cpu() - ref.preds.float().cpu()).abs()
    per_step = d.amax(dim=(0, 1, 3)).tolist()
    return dict(max_20=max(per_step[:20]), max_30=max(per_step[:30]),
                first_step_over={str(t): next((s for s, e in enumerate(per_step) if e > t), None)
                                 for t in THRESHOLDS})


def rollout(cfg, model, batch, dev, k1: bool, k6: bool):
    """The eval rollout with K1 and K6 each on its kernel or its plain
    version (every other site as the kernels leave it)."""
    saved = TM.fused_attention_core, NE.block_attn_core
    TM.fused_attention_core = saved[0] if k1 else FA.attention_core_plain
    NE.block_attn_core = saved[1] if k6 else (
        lambda q, k, v, valid, n_head, bf16=False: BA.block_attn_core_plain(q, k, v, valid, n_head, bf16))
    try:
        return O.eval_rollout(cfg, model, batch, device=dev)
    finally:
        TM.fused_attention_core, NE.block_attn_core = saved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rollout_gap_ab.py: no CUDA device")
    dev = O.resolve_device("cuda")
    cuda_build.build_all(("fused_attention", "block_attn"))
    cfg = config(args.hidden, args.heads)
    batch = synthetic_episode_batch(cfg.data, n_scene=8, seed=0, n_valid_pl=768, n_valid_agent=40)
    nudged = dict(batch, **{"map/pos": np.nextafter(batch["map/pos"], np.float32(np.inf))})
    for seed in args.seeds:
        model = O.make_model(cfg, device=dev, seed=seed)
        with ops.plain_versions():
            ref = O.eval_rollout(cfg, model, batch, device=dev)
            nudge = O.eval_rollout(cfg, model, nudged, device=dev)
            pb = pre_processing(to_torch(batch, dev), cfg.model, training=False)
            with torch.no_grad():
                map_plain, _ = O.encode_map_chunked(model, pb, 8)
        with torch.no_grad():
            map_kernels, _ = O.encode_map_chunked(model, pb, 8)
        line = dict(hidden=args.hidden, heads=args.heads, model_seed=seed,
                    map_feature_max_abs=(map_kernels - map_plain).abs().max().item(),
                    kernels=gap(rollout(cfg, model, batch, dev, True, True), ref),
                    k1_alone=gap(rollout(cfg, model, batch, dev, True, False), ref),
                    k6_alone=gap(rollout(cfg, model, batch, dev, False, True), ref),
                    nudge=gap(nudge, ref))
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
