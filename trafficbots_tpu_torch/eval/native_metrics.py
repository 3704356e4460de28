"""ctypes bindings for the native motion-metrics engine (native/motion_metrics.cc).

A copy of `trafficbots_tpu/eval/native_metrics.py` over the port's own copy
of the C++ source (`trafficbots_tpu_torch/native/motion_metrics.cc`);
tests/test_torch_data.py holds the source and `NativeMotionMetrics` equal
to the originals, and tests/test_torch_eval.py the numbers to the JAX
package's native engine and to the numpy one. One difference: the library
is built with g++ at first use into `trafficbots_tpu_torch/build/`
(gitignored), named by a hash of the source and the flags, written under a
temporary name and renamed into place, so that processes building at once
never load a half-written file; a failed build raises.

Drop-in replacement for eval.motion_metrics.MotionMetrics for large
validation sweeps; the numpy engine is the correctness oracle.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .motion_metrics import MotionMetricsConfig, breakdown_names

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "motion_metrics.cc"
BUILD = _PKG / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"libmotion_metrics-{h}.so"


def _build_library() -> Path:
    out = library_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.check_call(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)])
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        path = _build_library()
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.motion_metrics_compute.argtypes = [
        f32p, f32p, f32p, u8p, i64p, u8p, f32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        i32p, f32p, f32p, ctypes.c_int, f32p,
    ]
    lib.motion_metrics_compute.restype = ctypes.c_int
    return lib


class NativeMotionMetrics:
    """Same update/compute/reset interface as MotionMetrics (numpy)."""

    def __init__(self, config: Optional[MotionMetricsConfig] = None):
        self.config = config or MotionMetricsConfig()
        self.lib = load_library()
        self._batches: List[Dict[str, np.ndarray]] = []

    def reset(self):
        self._batches = []

    def update(self, **kwargs):
        self._batches.append({k: np.asarray(v) for k, v in kwargs.items()})

    def compute(self) -> Dict[str, float]:
        cfg = self.config
        if not self._batches:
            return {}
        cat = {
            k: np.ascontiguousarray(np.concatenate([b[k] for b in self._batches], axis=0))
            for k in self._batches[0]
        }
        pt = cat["prediction_trajectory"].astype(np.float32)
        ps = cat["prediction_score"].astype(np.float32)
        gt = cat["ground_truth_trajectory"].astype(np.float32)
        gv = cat["ground_truth_is_valid"].astype(np.uint8)
        pgi = cat["prediction_ground_truth_indices"].astype(np.int64)
        pgm = cat["prediction_ground_truth_indices_mask"].astype(np.uint8)
        ot = cat["object_type"].astype(np.float32)
        B, M, K, N, TP, _ = pt.shape
        A, TG = gt.shape[1], gt.shape[2]

        n_cfg = len(cfg.step_configurations)
        meas = np.array([s.measurement_step for s in cfg.step_configurations], np.int32)
        lat = np.array([s.lateral_miss_threshold for s in cfg.step_configurations], np.float32)
        lon = np.array([s.longitudinal_miss_threshold for s in cfg.step_configurations], np.float32)
        out = np.zeros(3 * n_cfg * 6, np.float32)

        rc = self.lib.motion_metrics_compute(
            pt, ps, gt, gv, pgi, pgm, ot,
            B, M, K, N, TP, A, TG,
            cfg.track_history_samples, cfg.step_ratio,
            cfg.speed_lower_bound, cfg.speed_upper_bound,
            cfg.speed_scale_lower, cfg.speed_scale_upper,
            meas, lat, lon, n_cfg, out,
        )
        assert rc == 0
        out = out.reshape(3, n_cfg, 6)

        names = breakdown_names(cfg)
        metric_names = ("min_ade", "min_fde", "miss_rate", "overlap_rate",
                        "mean_average_precision", "soft_mean_average_precision")
        result: Dict[str, float] = {}
        values = {m: [] for m in metric_names}
        for oi, ot_name in enumerate(("TYPE_VEHICLE", "TYPE_PEDESTRIAN", "TYPE_CYCLIST")):
            for ci, sc in enumerate(cfg.step_configurations):
                n = f"{ot_name}_{sc.measurement_step}"
                for mi, m in enumerate(metric_names):
                    result[f"{m}/{n}"] = float(out[oi, ci, mi])
                    values[m].append(float(out[oi, ci, mi]))
        for m in metric_names:
            result[m] = float(np.mean(values[m]))
            for oi, ot_name in enumerate(("TYPE_VEHICLE", "TYPE_PEDESTRIAN", "TYPE_CYCLIST")):
                result[f"{m}/{ot_name}"] = float(out[oi, :, {
                    "min_ade": 0, "min_fde": 1, "miss_rate": 2,
                    "overlap_rate": 3, "mean_average_precision": 4,
                    "soft_mean_average_precision": 5,
                }[m]].mean())
        return result
