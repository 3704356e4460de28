"""Simulation-quality metrics as (sum, counter) reductions on tensors.

Counterpart of `trafficbots_tpu/eval/metrics.py`: each validation batch maps
to a dict of scalar sums and counters (`*_update`), the host adds the dicts
across batches (`add_metric_sums`), and `*_compute` divides at the end.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..geometry import cast_rad

Tensor = torch.Tensor

RULE_KEYS = (
    "outside_map", "collided", "run_road_edge", "run_red_light",
    "passive", "goal_reached", "dest_reached",
)


def error_metrics_update(
    pred_valid: Tensor,  # [B, A, (K), S]
    pred_states: Tensor,  # [B, A, (K), S, 4]
    gt_valid: Tensor,  # [B, A, S]
    gt_states: Tensor,  # [B, A, S, 4]
    override_masks: Tensor,  # [B, A, (K), S]
    agent_role: Tensor,  # [B, A, 3]
    loss_for_teacher_forcing: bool = False,
) -> Dict[str, Tensor]:
    """Position, heading and speed error sums over the relevant agents'
    closed-loop (not teacher-forced) steps, and their count."""
    if pred_valid.ndim == 3:  # add a K axis
        pred_valid, pred_states, override_masks = pred_valid[:, :, None], pred_states[:, :, None], override_masks[:, :, None]
    mask_rel = agent_role.any(dim=-1)[:, :, None, None]
    gt_valid, gt_states = gt_valid[:, :, None], gt_states[:, :, None]
    pv = pred_valid & mask_rel
    if not loss_for_teacher_forcing:
        pv = pv & ~override_masks
    err_valid = gt_valid & pv
    zero = torch.zeros((), dtype=pred_states.dtype, device=pred_states.device)
    gt = torch.where(err_valid[..., None], gt_states, zero)
    pr = torch.where(err_valid[..., None], pred_states, zero)
    return {
        "err_counter": err_valid.sum().float(),
        "err_pos_meter": torch.linalg.norm(gt[..., :2] - pr[..., :2], dim=-1).sum(),
        "err_rot_deg": torch.rad2deg(cast_rad(gt[..., 2] - pr[..., 2])).abs().sum(),
        "err_spd_m_per_s": (gt[..., 3] - pr[..., 3]).abs().sum(),
    }


def error_metrics_compute(sums: Dict[str, float], prefix: str = "") -> Dict[str, float]:
    if not sums:  # no batches accumulated
        return {}
    c = max(float(sums["err_counter"]), 1.0)
    return {
        f"{prefix}err/pos_meter": float(sums["err_pos_meter"]) / c,
        f"{prefix}err/rot_deg": float(sums["err_rot_deg"]) / c,
        f"{prefix}err/spd_m_per_s": float(sums["err_spd_m_per_s"]) / c,
    }


def rule_metrics_update(
    valid: Tensor,  # [B, A, (K), S]
    override_masks: Tensor,
    violations: Dict[str, Tensor],  # sticky flags, each [B, A, (K), S]
    agent_type: Tensor,  # [B, A, 3]
    loss_for_teacher_forcing: bool = False,
) -> Dict[str, Tensor]:
    """Per-agent any-step violation counts and the agent/vehicle counters."""
    if valid.ndim == 3:
        valid, override_masks = valid[:, :, None], override_masks[:, :, None]
        violations = {k: violations[k][:, :, None] for k in RULE_KEYS}
    else:
        violations = {k: violations[k] for k in RULE_KEYS}
    if loss_for_teacher_forcing:
        agent_valid = valid.any(dim=-1)
    else:
        av = valid & ~override_masks
        violations = {k: v & av for k, v in violations.items()}
        agent_valid = av.any(dim=-1)
    mask_veh = agent_type[:, :, 0:1]
    out = {
        "counter_agent": agent_valid.sum().float(),
        "counter_veh": (agent_valid & mask_veh).sum().float(),
    }
    for k, v in violations.items():
        out[k] = v.any(dim=-1).sum().float()
    return out


def rule_metrics_compute(sums: Dict[str, float], prefix: str = "") -> Dict[str, float]:
    if not sums:
        return {}
    ca = max(float(sums["counter_agent"]), 1.0)
    cv = max(float(sums["counter_veh"]), 1.0)
    per_veh = {"run_road_edge", "run_red_light", "passive"}
    return {f"{prefix}traffic_rule/{k}": float(sums[k]) / (cv if k in per_veh else ca) for k in RULE_KEYS}


def add_metric_sums(a: Dict, b: Dict) -> Dict:
    if not a:
        return dict(b)
    return {k: a[k] + b[k] for k in b}
