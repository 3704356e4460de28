"""WOMD metrics packing: rollouts -> motion-metrics op input layout.

A copy of `trafficbots_tpu/eval/womd.py` (host-side numpy), kept by the
port instead of importing the JAX package; tests/test_torch_eval.py holds
the two to the same numbers. One difference: `use_native=True` (the
default, as in the JAX package) takes the port's native engine
(`eval.native_metrics`) and raises when it cannot be built, where the JAX
class falls back to numpy quietly. `sync()` unions the ranks'
accumulated inputs through the port's `parallel.mesh.allgather_pyobj`.

The predict-agents-first permutation of each scene is a stable argsort, the
same layout as the upstream TrafficBots' per-scene boolean indexing.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .motion_metrics import MotionMetrics, MotionMetricsConfig


class WOMDMetrics:
    """Packs batches and delegates to the metrics engine."""

    def __init__(
        self,
        prefix: str,
        step_gt: int = 90,
        step_current: int = 10,
        interactive_challenge: bool = False,
        use_native: bool = True,
    ):
        self.prefix = prefix
        self.step_gt = step_gt
        self.step_current = step_current
        self.interactive_challenge = interactive_challenge
        self.track_future_samples = step_gt - step_current
        # the official challenge layout needs the full 80-step future (the
        # 10->2 Hz downsample below indexes [4:80:5]); shorter debug horizons
        # disable the WOMD metric instead of crashing the validation loop
        self.enabled = self.track_future_samples == 80
        if not self.enabled:
            import warnings

            warnings.warn(
                f"WOMDMetrics({prefix}) disabled: future horizon is "
                f"{self.track_future_samples} steps, the challenge needs 80. "
                "val/loss will NOT reflect mAP.",
                stacklevel=2,
            )
        if self.interactive_challenge:
            self.m_joint, self.n_pred = 1, 2
        else:
            self.m_joint, self.n_pred = 8, 1
        config = MotionMetricsConfig(
            track_history_samples=step_current,
            track_future_samples=self.track_future_samples,
        )
        if use_native:
            from .native_metrics import NativeMotionMetrics

            self.engine = NativeMotionMetrics(config)
        else:
            self.engine = MotionMetrics(config)
        self._synced = False

    def reset(self):
        self.engine.reset()
        self._synced = False

    def sync(self) -> None:
        """The union of every rank's accumulated metric inputs, in rank
        order, on every rank (each rank packed its own rows, pad rows
        dropped, so the lists are ragged), so the compute sees every
        scenario. Once an epoch: a second call gathers nothing. With one
        process, a no-op."""
        if not self.enabled or self._synced:
            return
        from ..parallel.mesh import allgather_pyobj

        self._synced = True
        self.engine._batches = [b for batches in allgather_pyobj(self.engine._batches) for b in batches]

    def update(
        self, batch: Dict[str, np.ndarray], pred_traj: np.ndarray, pred_score: Optional[np.ndarray] = None
    ) -> None:
        """batch: episode dict (numpy); pred_traj [B, S_future.., A, K, 2]
        (steps step_start+1..step_end); pred_score [B, A, K] normalized.

        """
        if not self.enabled:
            return
        batch = {k: np.asarray(v) for k, v in batch.items()}
        pred_traj = np.asarray(pred_traj)

        mask_pred = batch["agent/role"][..., 2].astype(bool)  # [B, A]
        mask_other = (~mask_pred) & batch["agent/valid"][:, : self.step_current + 1].all(1)

        n_step_total = batch["agent/pos"].shape[1]
        size2 = np.broadcast_to(
            batch["agent/size"][:, None, :, :2],
            (*batch["agent/pos"].shape[:3], 2),
        )
        gt_traj = np.concatenate(
            [batch["agent/pos"], size2, batch["agent/yaw_bbox"], batch["agent/vel"]], axis=-1
        ).swapaxes(1, 2)[:, :, : self.step_gt + 1]  # [B, A, T, 7]
        gt_valid = batch["agent/valid"].swapaxes(1, 2)[:, :, : self.step_gt + 1]
        agent_type = batch["agent/type"].astype(np.float32).argmax(-1) + 1.0  # [B, A]

        # downsample 10 Hz -> 2 Hz (ref womd.py:91)
        pred_traj = pred_traj[:, 4 : self.track_future_samples : 5]

        if self.interactive_challenge:
            # [B, 1, K, A, steps, 2]
            pred_traj = np.transpose(pred_traj, (0, 3, 2, 1, 4))[:, None]
            if pred_score is None:
                k = pred_traj.shape[2]
                pred_score = np.full((pred_traj.shape[0], 1, k), 1.0 / k, np.float32)
            else:
                pred_score = np.asarray(pred_score).sum(axis=1, keepdims=True)  # [B, 1, K]
        else:
            # [B, A, K, 1, steps, 2]
            pred_traj = np.transpose(pred_traj, (0, 2, 3, 1, 4))[:, :, :, None]
            if pred_score is None:
                k = pred_traj.shape[2]
                pred_score = np.full(pred_traj.shape[:2] + (k,), 1.0 / k, np.float32)
            else:
                pred_score = np.asarray(pred_score)

        B, A = gt_traj.shape[:2]
        TG = gt_traj.shape[2]
        TP = pred_traj.shape[-2]
        K = pred_traj.shape[2]

        ptr = np.zeros((B, self.m_joint, K, self.n_pred, TP, 2), np.float32)
        psc = np.zeros((B, self.m_joint, K), np.float32)
        gtt = np.zeros((B, A, TG, 7), np.float32)
        gtv = np.zeros((B, A, TG), bool)
        pgi_mask = np.zeros((B, self.m_joint, self.n_pred), bool)
        otype = np.zeros((B, A), np.float32)

        for i in range(B):
            # predict-agents-first stable permutation (ref womd.py:124-145)
            order = np.argsort(
                np.where(mask_pred[i], 0, np.where(mask_other[i], 1, 2)), kind="stable"
            )
            n_p = int(mask_pred[i].sum())
            n_o = int(mask_other[i].sum())
            keep = order[: n_p + n_o]
            gtt[i, : n_p + n_o] = gt_traj[i, keep]
            gtv[i, : n_p + n_o] = gt_valid[i, keep]
            otype[i, : n_p + n_o] = agent_type[i, keep]

            pred_sel = order[:n_p]
            if self.interactive_challenge:
                ptr[i, :, :, :n_p] = pred_traj[i, :, :, pred_sel].transpose(1, 2, 0, 3, 4)
                psc[i] = pred_score[i]
                pgi_mask[i, :, :n_p] = True
            else:
                n_take = min(n_p, self.m_joint)
                ptr[i, :n_take] = pred_traj[i, pred_sel[:n_take]]
                psc[i, :n_take] = pred_score[i, pred_sel[:n_take]]
                pgi_mask[i, :n_take] = True

        if self.interactive_challenge:
            pgi = np.broadcast_to(
                np.arange(self.n_pred, dtype=np.int64)[None, None, :], pgi_mask.shape
            ).copy()
        else:
            pgi = np.broadcast_to(
                np.arange(self.m_joint, dtype=np.int64)[None, :, None], pgi_mask.shape
            ).copy()

        self.engine.update(
            prediction_trajectory=ptr,
            prediction_score=psc,
            ground_truth_trajectory=gtt,
            ground_truth_is_valid=gtv,
            prediction_ground_truth_indices=pgi,
            prediction_ground_truth_indices_mask=pgi_mask,
            object_type=otype,
        )

    def compute(self) -> Dict[str, float]:
        if not self.enabled:
            return {}
        raw = self.engine.compute()
        out = {}
        for k, v in raw.items():
            if "/" in k and k.split("/", 1)[1].startswith("TYPE_"):
                m, rest = k.split("/", 1)
                if "_" in rest and rest.split("_")[-1].isdigit():
                    out[f"waymo_metrics/{self.prefix}_{m}_{rest}"] = v
                else:
                    short = {"TYPE_VEHICLE": "veh", "TYPE_PEDESTRIAN": "ped", "TYPE_CYCLIST": "cyc"}[rest]
                    out[f"{self.prefix}/{short}/{m}"] = v
            else:
                out[f"{self.prefix}/{k}"] = v
        return out
