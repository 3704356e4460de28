"""Episode visualization: map + rollout videos and goal-probability images.

A copy of `trafficbots_tpu/utils/vis.py` (numpy and OpenCV only) kept by the
port instead of importing the JAX package; tests/test_torch_vis.py holds its
code equal to the original's (docstrings and comments aside) and its frames
equal to the original's, bitwise. `cv2` is optional: without it `_HAS_CV2`
is False and `evaluation_loop.render_validation_media` writes nothing.

One vectorized rasterizer draws the static map layer once and composites
per-frame agent boxes on top; prediction and attention videos (mp4) and
destination-probability heat images (png).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

# BGR palette per polyline type (lane types green-ish, edges gray, etc.)
PL_COLORS = {
    0: (80, 160, 80), 1: (80, 160, 120), 2: (80, 160, 160), 3: (160, 160, 80),
    4: (120, 120, 120), 5: (140, 140, 140), 6: (200, 200, 200), 7: (200, 200, 255),
    8: (120, 200, 255), 9: (255, 200, 120), 10: (255, 255, 150),
}
TL_COLORS = {0: (128, 128, 128), 1: (0, 0, 255), 2: (0, 165, 255), 3: (0, 255, 0), 4: (0, 255, 255)}
AGENT_COLORS = {0: (255, 120, 0), 1: (0, 200, 255), 2: (255, 0, 255)}  # veh, ped, cyc
VIOLATION_COLOR = (0, 0, 255)
SDC_COLOR = (0, 255, 0)


class VisScene:
    """Rasterizer for one episode. Ref vis_waymo.py:50-176 (map drawing)."""

    def __init__(
        self,
        map_valid: np.ndarray,  # [P, N]
        map_type: np.ndarray,  # [P, 11]
        map_pos: np.ndarray,  # [P, N, 2]
        map_boundary: np.ndarray,  # [4] xmin,xmax,ymin,ymax
        px_per_meter: float = 4.0,
        pad_meter: float = 10.0,
    ):
        assert _HAS_CV2, "cv2 required for visualization"
        self.ppm = px_per_meter
        xmin, xmax, ymin, ymax = map_boundary
        self.xmin = float(xmin) - pad_meter
        self.ymin = float(ymin) - pad_meter
        self.w = int((float(xmax) - self.xmin + pad_meter) * px_per_meter)
        self.h = int((float(ymax) - self.ymin + pad_meter) * px_per_meter)
        self.w = min(self.w, 4000)
        self.h = min(self.h, 4000)

        self.base = np.full((self.h, self.w, 3), 30, np.uint8)
        type_idx = np.argmax(map_type, axis=-1)
        for p in range(map_valid.shape[0]):
            pts = map_pos[p][map_valid[p]]
            if len(pts) < 2:
                continue
            color = PL_COLORS.get(int(type_idx[p]), (100, 100, 100))
            cv2.polylines(self.base, [self._px(pts)], False, color, 1, cv2.LINE_AA)

    def _px(self, xy: np.ndarray) -> np.ndarray:
        px = np.empty_like(xy)
        px[..., 0] = (xy[..., 0] - self.xmin) * self.ppm
        px[..., 1] = self.h - (xy[..., 1] - self.ymin) * self.ppm
        return np.round(px).astype(np.int32)

    def _draw_agent(self, img, x, y, yaw, length, width, color, thickness=-1):
        c, s = np.cos(yaw), np.sin(yaw)
        f = np.array([c, s]) * length / 2
        r = np.array([s, -c]) * width / 2
        corners = np.stack([-f + r, f + r, f - r, -f - r]) + np.array([x, y])
        cv2.fillPoly(img, [self._px(corners)], color)
        # heading tick
        tip = np.array([x, y]) + f
        cv2.line(img, tuple(self._px(np.array([x, y]))), tuple(self._px(tip)), (255, 255, 255), 1)

    def render_frame(
        self,
        agent_valid: np.ndarray,  # [A]
        agent_pos: np.ndarray,  # [A, 2]
        agent_yaw: np.ndarray,  # [A]
        agent_size: np.ndarray,  # [A, 2+]
        agent_type: Optional[np.ndarray] = None,  # [A, 3]
        agent_role: Optional[np.ndarray] = None,  # [A, 3]
        violations: Optional[np.ndarray] = None,  # [A] bool
        tl_valid: Optional[np.ndarray] = None,  # [n_tl]
        tl_pos: Optional[np.ndarray] = None,
        tl_state: Optional[np.ndarray] = None,  # [n_tl, 5]
        goal_xy: Optional[np.ndarray] = None,  # [A, 2]
    ) -> np.ndarray:
        img = self.base.copy()
        if tl_valid is not None:
            for t in range(len(tl_valid)):
                if not tl_valid[t]:
                    continue
                st = int(np.argmax(tl_state[t])) if tl_state is not None else 0
                cv2.circle(img, tuple(self._px(tl_pos[t])), 3, TL_COLORS.get(st, (255, 255, 255)), -1)
        for a in range(len(agent_valid)):
            if not agent_valid[a]:
                continue
            if violations is not None and violations[a]:
                color = VIOLATION_COLOR
            elif agent_role is not None and agent_role[a, 0]:
                color = SDC_COLOR
            elif agent_type is not None:
                color = AGENT_COLORS[int(np.argmax(agent_type[a]))]
            else:
                color = (255, 255, 255)
            self._draw_agent(
                img, agent_pos[a, 0], agent_pos[a, 1], float(agent_yaw[a]),
                float(agent_size[a, 0]), float(agent_size[a, 1]), color,
            )
            if goal_xy is not None:
                cv2.drawMarker(img, tuple(self._px(goal_xy[a])), color, cv2.MARKER_CROSS, 8, 1)
        return img

    def save_video(self, path: str, frames: Sequence[np.ndarray], fps: int = 10) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (self.w, self.h)
        )
        for f in frames:
            writer.write(f)
        writer.release()
        return path

    def save_prediction_video(
        self,
        path: str,
        episode: Dict[str, np.ndarray],
        prediction: Optional[Dict[str, np.ndarray]] = None,
        step_current: int = 10,
        title: Optional[str] = None,
    ) -> str:
        """GT video for steps <= step_current, then GT or prediction after.

        episode keys: agent/valid [T, A], agent/pos [T, A, 2],
        agent/yaw_bbox [T, A, 1], agent/size [A, 3], agent/type, agent/role,
        tl_stop/*; prediction keys (from the rollout buffer, step-major):
        agent/valid [T', A], agent/pos [T', A, 2], agent/yaw_bbox [T', A, 1],
        optionally violation flags [T', A]. `title` overlays a caption (e.g.
        the joint-future K index + score, ref log_val_video pred_scores).
        """
        T = episode["agent/valid"].shape[0]

        def frame_of(d: Dict[str, np.ndarray], key: str, t: int):
            """Frame t of an optional per-step series; None when absent."""
            series = d.get(key)
            return None if series is None else series[t]

        frames = []
        for t in range(T):
            # traffic lights always come from the episode at (clamped) GT time
            tl_t = min(t, T - 1)
            tl_kwargs = dict(
                tl_valid=frame_of(episode, "tl_stop/valid", tl_t),
                tl_pos=frame_of(episode, "tl_stop/pos", tl_t),
                tl_state=frame_of(episode, "tl_stop/state", tl_t),
            )
            if prediction is not None and t > step_current:
                tp = t - step_current - 1
                if tp >= prediction["agent/valid"].shape[0]:
                    break
                violations = prediction.get("violations")
                if violations is not None and tp >= violations.shape[0]:
                    raise ValueError(
                        f"prediction['violations'] has {violations.shape[0]} "
                        f"steps but agent/valid has at least {tp + 1}"
                    )
                frames.append(
                    self.render_frame(
                        prediction["agent/valid"][tp],
                        prediction["agent/pos"][tp],
                        prediction["agent/yaw_bbox"][tp, :, 0],
                        episode["agent/size"],
                        episode.get("agent/type"),
                        episode.get("agent/role"),
                        violations=None if violations is None else violations[tp],
                        **tl_kwargs,
                    )
                )
            else:
                frames.append(
                    self.render_frame(
                        episode["agent/valid"][t],
                        episode["agent/pos"][t],
                        episode["agent/yaw_bbox"][t, :, 0],
                        episode["agent/size"],
                        episode.get("agent/type"),
                        episode.get("agent/role"),
                        **tl_kwargs,
                    )
                )
        if title:
            for f in frames:
                cv2.putText(f, title, (8, 18), cv2.FONT_HERSHEY_SIMPLEX,
                            0.5, (255, 255, 255), 1, cv2.LINE_AA)
        return self.save_video(path, frames)

    def save_attention_video(
        self,
        path: str,
        map_valid: np.ndarray,  # [P, N]
        map_pos: np.ndarray,  # [P, N, 2]
        agent_valid: np.ndarray,  # [T, A]
        agent_pos: np.ndarray,  # [T, A, 2]
        agent_yaw: np.ndarray,  # [T, A]
        agent_size: np.ndarray,  # [A, 3]
        attn_pl: np.ndarray,  # [A, T, P] agent->polyline attention
        agent_idx: int = 0,
        fps: int = 10,
    ) -> str:
        """Per-step agent->map attention heat overlay for one agent.

        Capability port of ref vis_waymo.py:459-717 (save_attn_videos): each
        frame draws the map polylines colored by the policy's as2pl attention
        weight for `agent_idx` at that step, plus the agent's box.
        """
        frames = []
        T = agent_valid.shape[0]
        for t in range(T):
            img = self.base.copy()
            w = attn_pl[agent_idx, min(t, attn_pl.shape[1] - 1)]
            wmax = w.max() + 1e-9
            for p in range(map_valid.shape[0]):
                if not map_valid[p].any() or w[p] <= 0:
                    continue
                heat = int(255 * w[p] / wmax)
                if heat < 8:
                    continue
                pts = map_pos[p][map_valid[p]]
                cv2.polylines(img, [self._px(pts)], False, (0, heat, 255), 2)
            if agent_valid[t, agent_idx]:
                self._draw_agent(
                    img, agent_pos[t, agent_idx, 0], agent_pos[t, agent_idx, 1],
                    float(agent_yaw[t, agent_idx]),
                    float(agent_size[agent_idx, 0]), float(agent_size[agent_idx, 1]),
                    SDC_COLOR,
                )
            frames.append(img)
        return self.save_video(path, frames, fps=fps)

    def save_dest_prob_image(
        self, path: str, map_valid: np.ndarray, map_pos: np.ndarray, dest_probs: np.ndarray, agent_idx: int = 0
    ) -> str:
        """Heat image of the destination distribution for one agent.

        Ref vis_waymo.py:719-798 (get_dest_prob_image).
        """
        img = self.base.copy()
        probs = dest_probs[agent_idx]
        pmax = probs.max() + 1e-9
        for p in range(map_valid.shape[0]):
            if not map_valid[p].any() or probs[p] <= 0:
                continue
            heat = int(255 * probs[p] / pmax)
            pts = map_pos[p][map_valid[p]]
            cv2.polylines(img, [self._px(pts)], False, (0, heat, 255), 2)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cv2.imwrite(path, img)
        return path
