"""Waymo motion-prediction metrics: minADE/minFDE/miss-rate/overlap/mAP.

A copy of `trafficbots_tpu/eval/motion_metrics.py` (pure numpy): the port
keeps its own copy instead of importing the JAX package, and
tests/test_torch_eval.py holds the two to the same numbers.

Reimplementation of the math inside Waymo's C++ `py_metrics_ops.motion_metrics`
TF op, the upstream TrafficBots' single native dependency (invoked in its
src/models/metrics/womd.py:176-227). The algorithm
follows the published waymo-open-dataset metric definition:

  * predictions are at 2 Hz (16 steps over the 8 s future), ground truth at
    10 Hz; prediction step i maps to track step history + 5*(i+1);
  * per-breakdown evaluation at measurement steps {5, 9, 15} (3/5/8 s) with
    lateral/longitudinal miss thresholds {1.0/2.0, 1.8/3.6, 3.0/6.0} m,
    scaled by the agent's current speed:
    scale = 0.5 + 0.5 * clamp((v - 1.4) / (11.0 - 1.4), 0, 1);
  * a joint prediction (of N objects) misses at step T if ANY object's
    displacement, rotated into its GT heading frame at T, exceeds the scaled
    thresholds; the object group is a miss if ALL K guesses miss;
  * minADE/minFDE: min over K of the object-averaged displacement (mean over
    valid 2 Hz steps <= T for ADE, at T for FDE);
  * overlap rate: the most-likely guess overlaps if its predicted box
    (GT length/width, heading from the predicted motion direction) intersects
    any other valid object's GT box at any 2 Hz step <= T;
  * mAP: per (object-type, step) breakdown, predictions are grouped into the
    8 trajectory-shape buckets (classify_trajectory below, mirroring
    motion_metrics_utils.cc); within a bucket all guesses across the dataset
    are sorted by score, at most one true positive per object (the
    highest-score non-missing guess; later matches are FPs for mAP and
    ignored for Soft mAP), and AP is the area under the interpolated P/R
    curve with recall denominator = #objects in the bucket.

This module is pure numpy and runs host-side after rollouts (never in the
differentiated path), exactly like the reference's CPU TF op. The JAX
package also has a C++ implementation (native/motion_metrics.cc) for large
validation sweeps; the port has not copied it yet and uses this numpy
version.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# trajectory-shape buckets (motion_metrics_utils.cc)
TRAJ_TYPE_NAMES = (
    "STATIONARY", "STRAIGHT", "STRAIGHT_LEFT", "STRAIGHT_RIGHT",
    "LEFT_U_TURN", "LEFT_TURN", "RIGHT_U_TURN", "RIGHT_TURN",
)
OBJECT_TYPE_NAMES = {1: "TYPE_VEHICLE", 2: "TYPE_PEDESTRIAN", 3: "TYPE_CYCLIST"}


@dataclasses.dataclass(frozen=True)
class StepConfig:
    measurement_step: int  # 2 Hz index (1-based within the future)
    lateral_miss_threshold: float
    longitudinal_miss_threshold: float


@dataclasses.dataclass(frozen=True)
class MotionMetricsConfig:
    """Mirrors the proto in the upstream src/models/metrics/womd.py:234-262."""

    track_steps_per_second: int = 10
    prediction_steps_per_second: int = 2
    track_history_samples: int = 10
    track_future_samples: int = 80
    speed_lower_bound: float = 1.4
    speed_upper_bound: float = 11.0
    speed_scale_lower: float = 0.5
    speed_scale_upper: float = 1.0
    max_predictions: int = 6
    step_configurations: Tuple[StepConfig, ...] = (
        StepConfig(5, 1.0, 2.0),
        StepConfig(9, 1.8, 3.6),
        StepConfig(15, 3.0, 6.0),
    )

    @property
    def step_ratio(self) -> int:
        return self.track_steps_per_second // self.prediction_steps_per_second

    def pred_to_track_step(self, i: int) -> int:
        """2 Hz prediction index (0-based) -> 10 Hz track index."""
        return self.track_history_samples + self.step_ratio * (i + 1)


def breakdown_names(config: MotionMetricsConfig) -> List[str]:
    """e.g. TYPE_VEHICLE_5 ... mirrors config_util_py.get_breakdown_names."""
    names = []
    for ot in (1, 2, 3):
        for sc in config.step_configurations:
            names.append(f"{OBJECT_TYPE_NAMES[ot]}_{sc.measurement_step}")
    return names


def classify_trajectory(
    valid: np.ndarray, pos: np.ndarray, yaw: np.ndarray, spd: np.ndarray
) -> int:
    """8-way shape bucket of a GT track (motion_metrics_utils.cc).

    Thresholds: stationary if max(spd) < 2 m/s and displacement < 5 m;
    straight if |heading diff| < pi/6 and |lateral| < 5 m; u-turn if
    longitudinal < -5 m. Returns -1 for tracks with < 2 valid states.
    """
    idx = np.nonzero(valid)[0]
    if len(idx) < 2:
        return -1
    i0, i1 = idx[0], idx[-1]
    dxy = pos[i1] - pos[i0]
    final_disp = float(np.hypot(dxy[0], dxy[1]))
    c, s = np.cos(-yaw[i0]), np.sin(-yaw[i0])
    dx = dxy[0] * c - dxy[1] * s
    dy = dxy[0] * s + dxy[1] * c
    heading_diff = float(yaw[i1] - yaw[i0])
    max_speed = float(max(spd[i0], spd[i1]))

    if max_speed < 2.0 and final_disp < 5.0:
        return 0
    if abs(heading_diff) < np.pi / 6.0:
        if abs(dy) < 5.0:
            return 1
        return 2 if dy > 0 else 3
    if heading_diff < -np.pi / 6.0 and dy < 0:
        return 6 if dx < -5.0 else 7
    return 4 if dx < -5.0 else 5


def _box_corners(cx, cy, heading, length, width):
    c, s = np.cos(heading), np.sin(heading)
    dxl, dyl = c * length / 2, s * length / 2
    dxw, dyw = -s * width / 2, c * width / 2
    return np.array(
        [
            [cx + dxl + dxw, cy + dyl + dyw],
            [cx + dxl - dxw, cy + dyl - dyw],
            [cx - dxl - dxw, cy - dyl - dyw],
            [cx - dxl + dxw, cy - dyl + dyw],
        ]
    )


def _boxes_overlap(b1: np.ndarray, b2: np.ndarray) -> bool:
    """SAT test for two convex quads [4, 2]."""
    for box in (b1, b2):
        for i in range(4):
            edge = box[(i + 1) % 4] - box[i]
            axis = np.array([-edge[1], edge[0]])
            p1 = b1 @ axis
            p2 = b2 @ axis
            if p1.max() < p2.min() or p2.max() < p1.min():
                return False
    return True


@dataclasses.dataclass
class _PredRecord:
    """One (object-group, guess) entry for mAP accumulation."""

    score: float
    is_match: bool  # non-miss
    group_id: int  # unique per object group (for the one-TP rule)


class MotionMetrics:
    """Accumulate batches, then compute the full metric dict.

    Input layout matches the reference op exactly (womd.py:113-122):
      prediction_trajectory [B, M, K, N, TP, 2]
      prediction_score      [B, M, K]
      ground_truth_trajectory [B, A, TG, 7]  (x, y, length, width, heading, vx, vy)
      ground_truth_is_valid   [B, A, TG]
      prediction_ground_truth_indices      [B, M, N] int
      prediction_ground_truth_indices_mask [B, M, N] bool
      object_type [B, A] float (1=veh, 2=ped, 3=cyc)
    """

    def __init__(self, config: Optional[MotionMetricsConfig] = None):
        self.config = config or MotionMetricsConfig()
        self._batches: List[Dict[str, np.ndarray]] = []

    def reset(self):
        self._batches = []

    def update(self, **kwargs):
        self._batches.append({k: np.asarray(v) for k, v in kwargs.items()})

    # ------------------------------------------------------------------
    def compute(self) -> Dict[str, float]:
        cfg = self.config
        names = breakdown_names(cfg)
        # accumulators per breakdown
        acc = {
            n: {
                "ade": [], "fde": [], "miss": [], "overlap": [],
                "pred_records": [[] for _ in TRAJ_TYPE_NAMES],
                "bucket_counts": np.zeros(len(TRAJ_TYPE_NAMES), dtype=np.int64),
            }
            for n in names
        }
        group_counter = 0

        for b in self._batches:
            B = b["prediction_trajectory"].shape[0]
            for i in range(B):
                group_counter = self._accumulate_scene(b, i, acc, group_counter)

        out: Dict[str, float] = {}
        values = {m: [] for m in (
            "min_ade", "min_fde", "miss_rate", "overlap_rate",
            "mean_average_precision", "soft_mean_average_precision",
        )}
        for n in names:
            a = acc[n]
            out_ade = float(np.mean(a["ade"])) if a["ade"] else 0.0
            out_fde = float(np.mean(a["fde"])) if a["fde"] else 0.0
            out_miss = float(np.mean(a["miss"])) if a["miss"] else 0.0
            out_ovl = float(np.mean(a["overlap"])) if a["overlap"] else 0.0
            out_map = self._mean_ap(a["pred_records"], a["bucket_counts"])
            # Soft mAP: duplicate non-missing guesses for an already-matched
            # object are ignored instead of counted as false positives
            out_smap = self._mean_ap(a["pred_records"], a["bucket_counts"], soft=True)
            out[f"min_ade/{n}"] = out_ade
            out[f"min_fde/{n}"] = out_fde
            out[f"miss_rate/{n}"] = out_miss
            out[f"overlap_rate/{n}"] = out_ovl
            out[f"mean_average_precision/{n}"] = out_map
            out[f"soft_mean_average_precision/{n}"] = out_smap
            values["min_ade"].append(out_ade)
            values["min_fde"].append(out_fde)
            values["miss_rate"].append(out_miss)
            values["overlap_rate"].append(out_ovl)
            values["mean_average_precision"].append(out_map)
            values["soft_mean_average_precision"].append(out_smap)

        for m, vals in values.items():
            out[m] = float(np.mean(vals)) if vals else 0.0
            for ot_name in ("TYPE_VEHICLE", "TYPE_PEDESTRIAN", "TYPE_CYCLIST"):
                sel = [v for n, v in zip(breakdown_names(cfg), vals) if n.startswith(ot_name)]
                out[f"{m}/{ot_name}"] = float(np.mean(sel)) if sel else 0.0
        return out

    # ------------------------------------------------------------------
    def _accumulate_scene(self, b, i, acc, group_counter) -> int:
        cfg = self.config
        pred_traj = b["prediction_trajectory"][i]  # [M, K, N, TP, 2]
        pred_score = b["prediction_score"][i]  # [M, K]
        gt_traj = b["ground_truth_trajectory"][i]  # [A, TG, 7]
        gt_valid = b["ground_truth_is_valid"][i]  # [A, TG]
        pg_idx = b["prediction_ground_truth_indices"][i]  # [M, N]
        pg_mask = b["prediction_ground_truth_indices_mask"][i]  # [M, N]
        obj_type = b["object_type"][i]  # [A]

        M, K, N, TP, _ = pred_traj.shape
        cur = cfg.track_history_samples
        future = slice(cur + 1, cur + cfg.track_future_samples + 1)

        for m in range(M):
            objs = [n for n in range(N) if pg_mask[m, n]]
            if not objs:
                continue
            gt_ids = [int(pg_idx[m, n]) for n in objs]
            # require GT valid at the current step for evaluation
            if not all(gt_valid[g, cur] for g in gt_ids):
                continue

            # per-object speed scale (speed at current step)
            scales = {}
            for g in gt_ids:
                v = float(np.hypot(gt_traj[g, cur, 5], gt_traj[g, cur, 6]))
                frac = np.clip(
                    (v - cfg.speed_lower_bound) / (cfg.speed_upper_bound - cfg.speed_lower_bound),
                    0.0, 1.0,
                )
                scales[g] = cfg.speed_scale_lower + (cfg.speed_scale_upper - cfg.speed_scale_lower) * frac

            # bucket from the first object's GT future shape
            g0 = gt_ids[0]
            bucket = classify_trajectory(
                gt_valid[g0, cur:], gt_traj[g0, cur:, :2], gt_traj[g0, cur:, 4],
                np.hypot(gt_traj[g0, cur:, 5], gt_traj[g0, cur:, 6]),
            )
            # breakdown by first object's type
            ot = int(obj_type[g0])
            if ot not in OBJECT_TYPE_NAMES or bucket < 0:
                continue

            for sc in cfg.step_configurations:
                name = f"{OBJECT_TYPE_NAMES[ot]}_{sc.measurement_step}"
                T = sc.measurement_step  # 1-based 2 Hz step
                track_T = cfg.pred_to_track_step(T - 1)
                if track_T >= gt_traj.shape[1]:
                    continue
                # objects must have valid GT at the measurement step
                if not all(gt_valid[g, track_T] for g in gt_ids):
                    continue

                # displacement per guess, per object, per 2 Hz step <= T
                ades = np.zeros(K)
                fdes = np.zeros(K)
                misses = np.zeros(K, dtype=bool)
                for k in range(K):
                    obj_ade = []
                    obj_fde = []
                    k_miss = False
                    for n, g in zip(objs, gt_ids):
                        errs = []
                        for t2 in range(T):
                            tt = cfg.pred_to_track_step(t2)
                            if not gt_valid[g, tt]:
                                continue
                            d = pred_traj[m, k, n, t2] - gt_traj[g, tt, :2]
                            errs.append(np.hypot(d[0], d[1]))
                        if errs:
                            obj_ade.append(np.mean(errs))
                        # FDE + miss at the measurement step
                        dT = pred_traj[m, k, n, T - 1] - gt_traj[g, track_T, :2]
                        obj_fde.append(np.hypot(dT[0], dT[1]))
                        h = gt_traj[g, track_T, 4]
                        c, s = np.cos(-h), np.sin(-h)
                        lon = dT[0] * c - dT[1] * s
                        lat = dT[0] * s + dT[1] * c
                        if (
                            abs(lat) > sc.lateral_miss_threshold * scales[g]
                            or abs(lon) > sc.longitudinal_miss_threshold * scales[g]
                        ):
                            k_miss = True
                    ades[k] = np.mean(obj_ade) if obj_ade else 0.0
                    fdes[k] = np.mean(obj_fde) if obj_fde else 0.0
                    misses[k] = k_miss

                a = acc[name]
                a["ade"].append(float(ades.min()))
                a["fde"].append(float(fdes.min()))
                a["miss"].append(float(misses.all()))
                a["overlap"].append(
                    self._overlap(pred_traj[m], pred_score[m], objs, gt_ids, gt_traj, gt_valid, T)
                )
                a["bucket_counts"][bucket] += 1
                gid = group_counter
                for k in range(K):
                    a["pred_records"][bucket].append(
                        _PredRecord(score=float(pred_score[m, k]), is_match=not misses[k], group_id=gid)
                    )
                group_counter += 1
        return group_counter

    def _overlap(self, pred_traj_m, pred_score_m, objs, gt_ids, gt_traj, gt_valid, T) -> float:
        """Most-likely guess overlaps any OTHER object's GT box at any 2 Hz step <= T."""
        cfg = self.config
        k_star = int(np.argmax(pred_score_m))
        A = gt_traj.shape[0]
        for n, g in zip(objs, gt_ids):
            length, width = gt_traj[g, cfg.track_history_samples, 2:4]
            prev = gt_traj[g, cfg.track_history_samples, :2]
            for t2 in range(T):
                tt = cfg.pred_to_track_step(t2)
                if tt >= gt_traj.shape[1]:
                    break
                p = pred_traj_m[k_star, n, t2]
                d = p - prev
                heading = np.arctan2(d[1], d[0]) if np.hypot(d[0], d[1]) > 1e-4 else gt_traj[g, tt, 4]
                prev = p
                box_p = _box_corners(p[0], p[1], heading, length, width)
                for other in range(A):
                    if other == g or not gt_valid[other, tt]:
                        continue
                    og = gt_traj[other, tt]
                    box_o = _box_corners(og[0], og[1], og[4], og[2], og[3])
                    # cheap reject before SAT
                    if np.abs(og[:2] - p).max() > (length + og[2]):
                        continue
                    if _boxes_overlap(box_p, box_o):
                        return 1.0
        return 0.0

    @staticmethod
    def _ap_from_records(records: List[_PredRecord], n_objects: int, soft: bool = False) -> float:
        """AP from sorted (score, match, group) records; one TP per group."""
        if n_objects == 0:
            return 0.0
        recs = sorted(records, key=lambda r: -r.score)
        seen = set()
        tps, fps = [], []
        for r in recs:
            if r.is_match and r.group_id not in seen:
                seen.add(r.group_id)
                tps.append(1.0)
                fps.append(0.0)
            elif r.is_match and soft:
                continue  # extra matches ignored for Soft mAP
            else:
                tps.append(0.0)
                fps.append(1.0)
        if not tps:
            return 0.0
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(fps)
        recall = tp_cum / n_objects
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        # standard 101-point interpolation
        ap = 0.0
        for r_level in np.linspace(0, 1, 101):
            prec = precision[recall >= r_level]
            ap += float(prec.max()) if prec.size else 0.0
        return ap / 101.0

    def _mean_ap(self, pred_records, bucket_counts, soft: bool = False) -> float:
        aps = []
        for bucket in range(len(TRAJ_TYPE_NAMES)):
            n_obj = int(bucket_counts[bucket])
            if n_obj == 0:
                continue
            aps.append(self._ap_from_records(pred_records[bucket], n_obj, soft))
        return float(np.mean(aps)) if aps else 0.0
