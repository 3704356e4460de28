"""Synthetic episode fixtures matching the packed-h5 tensor contract.

The reference validates only against real WOMD data; this generator produces
batches with the exact shapes/dtypes the datamodule declares
(ref data_h5_womd.py:85-173) so every layer is testable without the 1-TB
dataset (SURVEY.md section 4 item 1). Trajectories are kinematically
consistent (integrated from smooth accel/yaw-rate profiles) so reactive
replay and the differentiable reward behave like on real data.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..config import DataConfig


def synthetic_episode_batch(
    data: DataConfig,
    n_scene: int = 2,
    seed: int = 0,
    n_valid_agent: Optional[int] = None,
    with_history: bool = True,
    with_agent_no_sim: bool = False,
    n_valid_pl: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Build a training-contract batch; optionally add val/test history keys.

    `n_valid_agent`/`n_valid_pl` control how much of the fixed agent/map
    capacity is real (defaults mimic a typical packed scene: A//4 agents,
    P//8 polylines) — the perf tools use them for padding-sensitivity A/Bs.
    """
    rng = np.random.RandomState(seed)
    T, A, P, N = data.n_step, data.n_agent, data.n_pl, data.n_pl_node
    TL, TLS = data.n_tl, data.n_tl_stop
    dt = 0.1
    n_valid = n_valid_agent if n_valid_agent is not None else max(2, A // 4)

    out: Dict[str, np.ndarray] = {}

    # ---- agents: integrate unicycle trajectories
    valid = np.zeros((n_scene, T, A), dtype=bool)
    pos = np.zeros((n_scene, T, A, 2), dtype=np.float32)
    vel = np.zeros((n_scene, T, A, 2), dtype=np.float32)
    spd = np.zeros((n_scene, T, A, 1), dtype=np.float32)
    acc = np.zeros((n_scene, T, A, 1), dtype=np.float32)
    yaw = np.zeros((n_scene, T, A, 1), dtype=np.float32)
    yaw_rate = np.zeros((n_scene, T, A, 1), dtype=np.float32)

    for s in range(n_scene):
        for a in range(n_valid):
            t0 = 0 if a < n_valid // 2 else rng.randint(0, max(T // 3, 2))
            t1 = T if rng.rand() < 0.8 else rng.randint(max(2 * T // 3, 1), T)
            valid[s, t0:t1, a] = True
            x = rng.uniform(-50, 50)
            y = rng.uniform(-50, 50)
            th = rng.uniform(-np.pi, np.pi)
            v = rng.uniform(0, 15)
            a_prof = rng.uniform(-1, 1, size=T).astype(np.float32)
            w_prof = rng.uniform(-0.2, 0.2, size=T).astype(np.float32)
            for t in range(t0, t1):
                pos[s, t, a] = (x, y)
                yaw[s, t, a] = th
                spd[s, t, a] = v
                vel[s, t, a] = (v * np.cos(th), v * np.sin(th))
                acc[s, t, a] = a_prof[t]
                yaw_rate[s, t, a] = w_prof[t]
                x += v * np.cos(th) * dt
                y += v * np.sin(th) * dt
                th += w_prof[t] * dt
                v = max(0.0, v + a_prof[t] * dt)

    out["agent/valid"] = valid
    out["agent/pos"] = pos
    out["agent/z"] = np.zeros((n_scene, T, A, 1), dtype=np.float32)
    out["agent/vel"] = vel
    out["agent/spd"] = spd
    out["agent/acc"] = acc
    out["agent/yaw_bbox"] = yaw
    out["agent/yaw_rate"] = yaw_rate

    agent_type = np.zeros((n_scene, A, 3), dtype=bool)
    type_idx = rng.randint(0, 3, size=(n_scene, A))
    type_idx[:, 0] = 0  # SDC is a vehicle
    for s in range(n_scene):
        agent_type[s, np.arange(A), type_idx[s]] = True
    out["agent/type"] = agent_type

    cmd = np.zeros((n_scene, A, 8), dtype=bool)
    cmd[:, :, 0] = True
    out["agent/cmd"] = cmd
    role = np.zeros((n_scene, A, 3), dtype=bool)
    role[:, 0, 0] = True  # sdc
    role[:, 1 : min(3, n_valid), 2] = True  # predict
    out["agent/role"] = role
    size = np.zeros((n_scene, A, 3), dtype=np.float32)
    size[:, :, 0] = rng.uniform(3.5, 5.5, size=(n_scene, A))
    size[:, :, 1] = rng.uniform(1.6, 2.2, size=(n_scene, A))
    size[:, :, 2] = rng.uniform(1.4, 1.9, size=(n_scene, A))
    out["agent/size"] = size

    # goal = last valid state (ref pack_h5.py:242-246)
    goal = np.zeros((n_scene, A, 4), dtype=np.float32)
    for s in range(n_scene):
        for a in range(A):
            idx = np.nonzero(valid[s, :, a])[0]
            if len(idx):
                t = idx[-1]
                goal[s, a] = (pos[s, t, a, 0], pos[s, t, a, 1], yaw[s, t, a, 0], spd[s, t, a, 0])
    out["agent/goal"] = goal

    # ---- map: straight/curved polylines around the scene
    map_valid = np.zeros((n_scene, P, N), dtype=bool)
    map_pos = np.zeros((n_scene, P, N, 2), dtype=np.float32)
    map_dir = np.zeros((n_scene, P, N, 2), dtype=np.float32)
    map_type = np.zeros((n_scene, P, 11), dtype=bool)
    n_valid_pl = n_valid_pl if n_valid_pl is not None else max(8, P // 8)
    for s in range(n_scene):
        for p in range(n_valid_pl):
            n_nodes = rng.randint(5, N + 1)
            map_valid[s, p, :n_nodes] = True
            start = rng.uniform(-80, 80, size=2)
            th = rng.uniform(-np.pi, np.pi)
            curv = rng.uniform(-0.02, 0.02)
            pt = start.copy()
            for i in range(n_nodes):
                map_pos[s, p, i] = pt
                d = np.array([np.cos(th), np.sin(th)]) * 2.0
                map_dir[s, p, i] = d
                pt = pt + d
                th += curv
            # cycle through all 11 pl types but guarantee lanes (0-2), bike
            # lanes (3) and road edges (4) exist: dest assignment below needs
            # type-consistent polylines (as real WOMD packing guarantees,
            # ref pack_h5.py:828-867)
            map_type[s, p, p % 11 if p >= 5 else p] = True
    out["map/valid"] = map_valid
    out["map/type"] = map_type
    out["map/pos"] = map_pos
    out["map/dir"] = map_dir

    # destinations: type-consistent with the agent (veh -> lanes 0-2,
    # ped -> road edge 4, cyc -> bike lane 3; ref pack_h5.py:828-867)
    dest = np.zeros((n_scene, A), dtype=np.int64)
    pl_type_idx = np.argmax(map_type, axis=-1)  # [n_scene, P]
    for s in range(n_scene):
        valid_pl = map_valid[s].any(-1)
        for a in range(A):
            if agent_type[s, a, 0]:
                allowed = np.nonzero(valid_pl & np.isin(pl_type_idx[s], [0, 1, 2]))[0]
            elif agent_type[s, a, 1]:
                allowed = np.nonzero(valid_pl & (pl_type_idx[s] == 4))[0]
            else:
                allowed = np.nonzero(valid_pl & (pl_type_idx[s] == 3))[0]
            dest[s, a] = rng.choice(allowed) if len(allowed) else 0
    out["agent/dest"] = dest
    out["map/boundary"] = np.tile(
        np.array([-200.0, 200.0, -200.0, 200.0], dtype=np.float32), (n_scene, 1)
    )

    # ---- traffic lights
    tl_lane_valid = np.zeros((n_scene, T, TL), dtype=bool)
    tl_lane_state = np.zeros((n_scene, T, TL, 5), dtype=bool)
    tl_lane_idx = np.full((n_scene, T, TL), -1, dtype=np.int64)
    tl_stop_valid = np.zeros((n_scene, T, TLS), dtype=bool)
    tl_stop_state = np.zeros((n_scene, T, TLS, 5), dtype=bool)
    tl_stop_pos = np.zeros((n_scene, T, TLS, 2), dtype=np.float32)
    tl_stop_dir = np.zeros((n_scene, T, TLS, 2), dtype=np.float32)
    n_tl_active = 4
    for s in range(n_scene):
        for i in range(n_tl_active):
            st = rng.randint(0, 5)
            p = rng.uniform(-60, 60, size=2).astype(np.float32)
            d = rng.uniform(-1, 1, size=2).astype(np.float32)
            d /= np.linalg.norm(d) + 1e-6
            tl_lane_valid[s, :, i] = True
            tl_lane_state[s, :, i, st] = True
            tl_lane_idx[s, :, i] = rng.randint(0, n_valid_pl)
            tl_stop_valid[s, :, i] = True
            tl_stop_state[s, :, i, st] = True
            tl_stop_pos[s, :, i] = p
            tl_stop_dir[s, :, i] = d
    out["tl_lane/valid"] = tl_lane_valid
    out["tl_lane/state"] = tl_lane_state
    out["tl_lane/idx"] = tl_lane_idx
    out["tl_stop/valid"] = tl_stop_valid
    out["tl_stop/state"] = tl_stop_state
    out["tl_stop/pos"] = tl_stop_pos
    out["tl_stop/dir"] = tl_stop_dir

    if with_history:
        H = data.n_step_history
        out["history/agent/object_id"] = np.arange(A, dtype=np.int64)[None].repeat(n_scene, 0)
        for k in ("valid", "pos", "z", "vel", "spd", "acc", "yaw_bbox", "yaw_rate"):
            out[f"history/agent/{k}"] = out[f"agent/{k}"][:, :H]
        for k in ("type", "role", "size"):
            out[f"history/agent/{k}"] = out[f"agent/{k}"]
        for k in ("valid", "state", "idx"):
            out[f"history/tl_lane/{k}"] = out[f"tl_lane/{k}"][:, :H]
        for k in ("valid", "state", "pos", "dir"):
            out[f"history/tl_stop/{k}"] = out[f"tl_stop/{k}"][:, :H]
        out["agent/object_id"] = out["history/agent/object_id"]

    if with_agent_no_sim:
        NS = data.n_agent_no_sim
        H = data.n_step_history
        out["agent_no_sim/object_id"] = (
            np.arange(NS, dtype=np.int64)[None].repeat(n_scene, 0) + 1000
        )
        out["agent_no_sim/valid"] = np.zeros((n_scene, T, NS), dtype=bool)
        out["agent_no_sim/pos"] = np.zeros((n_scene, T, NS, 2), dtype=np.float32)
        out["agent_no_sim/z"] = np.zeros((n_scene, T, NS, 1), dtype=np.float32)
        out["agent_no_sim/vel"] = np.zeros((n_scene, T, NS, 2), dtype=np.float32)
        out["agent_no_sim/spd"] = np.zeros((n_scene, T, NS, 1), dtype=np.float32)
        out["agent_no_sim/yaw_bbox"] = np.zeros((n_scene, T, NS, 1), dtype=np.float32)
        out["agent_no_sim/type"] = np.zeros((n_scene, NS, 3), dtype=bool)
        out["agent_no_sim/size"] = np.zeros((n_scene, NS, 3), dtype=np.float32)
        out["history/agent_no_sim/object_id"] = out["agent_no_sim/object_id"]
        for k in ("valid", "pos", "z", "vel", "spd", "yaw_bbox"):
            out[f"history/agent_no_sim/{k}"] = out[f"agent_no_sim/{k}"][:, : data.n_step_history]
        for k in ("type", "size"):
            out[f"history/agent_no_sim/{k}"] = out[f"agent_no_sim/{k}"]

    out["scenario_center"] = np.zeros((n_scene, 2), dtype=np.float64)
    out["scenario_yaw"] = np.zeros((n_scene,), dtype=np.float64)
    out["episode_idx"] = np.arange(n_scene, dtype=np.int64)
    return out
