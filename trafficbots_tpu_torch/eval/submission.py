"""WOMD motion-challenge submission writer.

A copy of `trafficbots_tpu/eval/submission.py`, kept by the port instead of
importing the JAX package. Differences: the rotation back to the global
frame uses the port's `geometry` on CPU tensors (the JAX class calls the
JAX geometry); `sync()` is a no-op, single-process, until the port's
data-parallel slice brings the multi-process union; the official
waymo_open_dataset protos are not looked for (the JAX class imports them
and then never uses them): the wire encoder writes the files.
tests/test_torch_eval.py holds the bytes against the JAX writer.

The upstream TrafficBots' src/utils/submission.py:15-133: accumulates top-K
predictions per scenario (K=1..k_futures as separate submissions), rotates
trajectories back to the global frame via the stored scenario center/yaw,
downsamples to 2 Hz, and writes MotionChallengeSubmission `.bin` + `.tar.gz`
files.

Serialization uses the built-in wire encoder (proto_wire.py) with the
field layout of waymo's motion_submission.proto:

  MotionChallengeSubmission: account_name=1, unique_method_name=2,
    authors=3, affiliation=4, submission_type=5 (MOTION_PREDICTION=1,
    INTERACTION_PREDICTION=2), scenario_predictions=6, description=7,
    method_link=8
  ChallengeScenarioPredictions: scenario_id=1, single_predictions=2,
    joint_prediction=3
  PredictionSet: predictions=1
  SingleObjectPrediction: object_id=1, trajectories=2
  ScoredTrajectory: confidence=1, trajectory=2
  Trajectory: center_x=1 (packed), center_y=2 (packed)
  JointPrediction: joint_trajectories=1
  ScoredJointTrajectory: confidence=1, trajectories=2
  ObjectTrajectory: object_id=1, trajectory=2

NOTE: verify field numbers against the official proto before a leaderboard
upload; the encoder itself is wire-format exact.
"""
from __future__ import annotations

import os
import tarfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..geometry import pos2global, rad2rot
from .proto_wire import Message, enc_message_field


def _traj_msg(xs: np.ndarray, ys: np.ndarray) -> Message:
    return Message().packed_floats(1, xs).packed_floats(2, ys)


class SubWOMD:
    def __init__(
        self,
        k_futures: int = 6,
        interactive_challenge: bool = False,
        activate: bool = False,
        method_name: str = "trafficbots_tpu",
        authors: Sequence[str] = ("ANON",),
        affiliation: str = "AFFILIATION",
        description: str = "scr_womd",
        method_link: str = "METHOD_LINK",
        account_name: str = "user@example.com",
        wb_artifact: Optional[str] = None,
    ):
        self.activate = activate
        self.method_name = method_name
        self.interactive = interactive_challenge
        self.meta = dict(
            account_name=account_name,
            authors=list(authors),
            affiliation=affiliation,
            description=f"{description}, wb_model: {wb_artifact}",
            method_link=method_link,
        )
        self.k_futures = k_futures
        self.reset()

    def reset(self) -> None:
        """Clear accumulated payloads, so a Validator reused across epochs
        does not duplicate earlier epochs' scenarios."""
        # per K: list of serialized ChallengeScenarioPredictions
        self.scenario_payloads: Dict[int, List[bytes]] = {
            k: [] for k in range(1, self.k_futures + 1)
        }

    def add_to_submissions(
        self,
        waymo_trajs: np.ndarray,  # [B, steps 11..90, A, K, 2]
        waymo_scores: np.ndarray,  # [B, A, K]
        mask_pred: np.ndarray,  # [B, A]
        object_id: np.ndarray,  # [B, A]
        scenario_center: np.ndarray,  # [B, 2]
        scenario_yaw: np.ndarray,  # [B]
        scenario_id: Sequence,
    ) -> None:
        if not self.activate:
            return
        waymo_trajs = np.asarray(waymo_trajs)[:, 4::5]  # 2 Hz
        waymo_trajs = np.transpose(waymo_trajs, (0, 2, 3, 1, 4))  # [B, A, K, T, 2]
        B, A, K, T, _ = waymo_trajs.shape

        # rotate back to global, in fp32 on the CPU
        center = torch.as_tensor(np.asarray(scenario_center), dtype=torch.float32)[:, None, :]
        rot = rad2rot(torch.as_tensor(np.asarray(scenario_yaw), dtype=torch.float32))
        flat = torch.as_tensor(np.ascontiguousarray(waymo_trajs), dtype=torch.float32).reshape(B, A * K * T, 2)
        waymo_trajs = pos2global(flat, center, rot).numpy().reshape(B, A, K, T, 2)

        waymo_scores = np.asarray(waymo_scores)
        mask_pred = np.asarray(mask_pred).astype(bool)
        object_id = np.asarray(object_id)

        for i in range(B):
            sel = mask_pred[i]
            pos = waymo_trajs[i, sel]  # [n_pred, K, T, 2]
            ids = object_id[i, sel]
            score = waymo_scores[i, sel]
            sid = scenario_id[i]
            if isinstance(sid, bytes):
                sid = sid.decode()
            for n_K in self.scenario_payloads:
                sp = Message().string(1, str(sid))
                if not self.interactive:
                    pset = Message()
                    for tr in range(pos.shape[0]):
                        pred = Message().varint(1, int(ids[tr]))
                        for k in range(n_K):
                            st = Message().float32(1, float(score[tr, k]))
                            st.message(2, _traj_msg(pos[tr, k, :, 0], pos[tr, k, :, 1]))
                            pred.message(2, st)
                        pset.message(1, pred)
                    sp.message(2, pset)
                else:
                    jp = Message()
                    for k in range(n_K):
                        sjt = Message().float32(1, float(score[:, k].sum()))
                        for tr in range(pos.shape[0]):
                            ot = Message().varint(1, int(ids[tr]))
                            ot.message(2, _traj_msg(pos[tr, k, :, 0], pos[tr, k, :, 1]))
                            sjt.message(2, ot)
                        jp.message(1, sjt)
                    sp.message(3, jp)
                self.scenario_payloads[n_K].append(sp.serialize())

    def sync(self) -> None:
        """Single-process: every payload is already here. The multi-process
        union belongs to the data-parallel slice."""

    def save_sub_files(self, out_dir: str = ".") -> List[str]:
        if not self.activate:
            return []
        paths = []
        for k, payloads in self.scenario_payloads.items():
            msg = (
                Message()
                .string(1, self.meta["account_name"])
                .string(2, f"{self.method_name}_K{k}")
            )
            for a in self.meta["authors"]:
                msg.string(3, a)
            msg.string(4, self.meta["affiliation"])
            msg.varint(5, 2 if self.interactive else 1)
            body = msg.serialize() + b"".join(
                enc_message_field(6, p) for p in payloads
            )
            body += (
                Message()
                .string(7, self.meta["description"])
                .string(8, self.meta["method_link"])
                .serialize()
            )
            sub_dir = Path(out_dir) / f"womd_{self.method_name}_K{k}"
            sub_dir.mkdir(exist_ok=True, parents=True)
            bin_path = sub_dir / f"womd_{self.method_name}_K{k}.bin"
            bin_path.write_bytes(body)
            tar_path = sub_dir.as_posix() + ".tar.gz"
            with tarfile.open(tar_path, "w:gz") as tar:
                tar.add(sub_dir, arcname=sub_dir.name)
            paths.append(tar_path)
        return paths
