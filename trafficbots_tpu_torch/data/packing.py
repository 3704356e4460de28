"""Offline episode packing (ETL): scenarios -> fixed-shape padded h5 episodes.

A copy of `trafficbots_tpu/data/packing.py` kept by the port instead of importing
the JAX package; tests/test_torch_data.py holds its code equal to the
original's (docstrings and comments aside).

From-scratch implementation of the upstream TrafficBots' packing layer
(pack_h5_womd.py + utils/pack_h5.py), built around a neutral `Scenario` dict contract so the
math is testable without WOMD TFRecords; `scenario_from_womd_proto` adapts
the Waymo proto when the waymo_open_dataset package is available.

Scenario contract (all python lists/np arrays, world frame):
  scenario_id: str
  timestamps: n_step (91 for WOMD)
  current_step: int (10)
  sdc_track_index: int
  track_index_predict: list[int]; object_id_interest: list[int]
  tracks: list of dicts {id, type (0=veh,1=ped,2=cyc), states [n_step, 10]:
          x, y, z, length, width, height, heading, vx, vy, valid}
  map_features: list of dicts {id, type (0..10 folded), xyz [n, 3]} — already
          subsampled x2 for lanes/edges/lines (ref pack_h5_womd.py:148,165,184)
  map_edges: list of [id_from, id_to] lane-topology pairs
  tl_states: per step: {lane_state [n], lane_id [n], stop_point [n, 3]}
          with the 9->5 folded states (ref pack_h5_womd.py:96-125)

Behaviors reproduced: polygon->polyline conversion,
<=20-node chunking, signed speed, goal = last valid state, 8-way command,
SDC swap to index 0, SE(2) scene centering with train-time random offset,
distance filtering with progressive threshold halving, gap interpolation with
finite-difference acc/yaw-rate, and type-dependent destination finding with
lane-topology random walk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..eval.motion_metrics import classify_trajectory

N_AGENT_CMD = 8
# lane types for dest finding (ref pack_h5_womd.py:204-205 style dims)
DIM_VEH_LANES = [0, 1, 2]
DIM_CYC_LANES = [3]
DIM_PED_LANES = [4]


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def polylines_from_polygon(polygon: np.ndarray) -> List[np.ndarray]:
    """4-corner polygon -> 4 polylines (both directions of the 2 long sides).

    Ref pack_h5.py:19-47 (1 m resampling along the longer edge pair).
    """
    l1 = np.linalg.norm(polygon[1, :2] - polygon[0, :2])
    l2 = np.linalg.norm(polygon[2, :2] - polygon[1, :2])

    def interp(start, end):
        length = np.linalg.norm(end - start)
        unit = (end - start) / max(length, 1e-9)
        pts = [start + unit * i for i in range(int(length) + 1)]
        pts.append(end)
        return np.asarray(pts)

    if l1 > l2:
        pl1 = interp(polygon[0], polygon[1])
        pl2 = interp(polygon[2], polygon[3])
    else:
        pl1 = interp(polygon[0], polygon[3])
        pl2 = interp(polygon[2], polygon[1])
    return [pl1, pl1[::-1], pl2, pl2[::-1]]


def se2_transform(points: np.ndarray, center: np.ndarray, yaw: float) -> np.ndarray:
    """World -> frame at (center, yaw): rotate by -yaw after translating."""
    c, s = np.cos(-yaw), np.sin(-yaw)
    p = points[..., :2] - center[:2]
    return np.stack([p[..., 0] * c - p[..., 1] * s, p[..., 0] * s + p[..., 1] * c], axis=-1)


def so2_rotate(vec: np.ndarray, yaw: float) -> np.ndarray:
    c, s = np.cos(-yaw), np.sin(-yaw)
    return np.stack([vec[..., 0] * c - vec[..., 1] * s, vec[..., 0] * s + vec[..., 1] * c], axis=-1)


# ---------------------------------------------------------------------------
# stage 1: pack raw scenario into max-capacity buffers
# ---------------------------------------------------------------------------

def pack_map(scenario: Dict, n_pl_max: int = 3000, n_nodes: int = 20) -> Dict[str, np.ndarray]:
    """Chunk polylines into <=n_nodes segments. Ref pack_h5.py:130-174."""
    ep: Dict[str, np.ndarray] = {
        "map/valid": np.zeros([n_pl_max, n_nodes], bool),
        "map/id": np.full([n_pl_max], -1, np.int64),
        "map/type": np.zeros([n_pl_max], np.int64),
        "map/pos": np.zeros([n_pl_max, n_nodes, 3], np.float32),
        "map/dir": np.zeros([n_pl_max, n_nodes, 3], np.float32),
        "map/edge": np.asarray(scenario.get("map_edges", [[-1, -1]]), np.int64),
    }
    counter = 0
    for mf in scenario["map_features"]:
        pos = np.asarray(mf["xyz"], np.float32)
        if len(pos) < 2:
            continue
        vec = np.diff(pos, axis=0)
        n = len(vec)
        cuts = np.linspace(0, n, n // n_nodes + 1, dtype=int, endpoint=False)
        for ci in range(len(cuts)):
            i0 = cuts[ci]
            i1 = n if ci + 1 == len(cuts) else cuts[ci + 1]
            if counter >= n_pl_max:
                break
            ep["map/valid"][counter, : i1 - i0] = True
            ep["map/pos"][counter, : i1 - i0] = pos[i0:i1]
            ep["map/dir"][counter, : i1 - i0] = vec[i0:i1]
            ep["map/type"][counter] = mf["type"]
            ep["map/id"][counter] = mf["id"]
            counter += 1
    return ep


def pack_agents(
    scenario: Dict, ep: Dict[str, np.ndarray],
    pack_all: bool, pack_history: bool, n_agent_max: int = 256,
) -> None:
    """Signed speed, mean size, goal=last valid state, 8-way cmd, SDC first.

    Ref pack_h5.py:176-301.
    """
    tracks = scenario["tracks"]
    n_step = len(tracks[0]["states"])
    cur = scenario["current_step"]

    valid = np.zeros([n_step, n_agent_max], bool)
    pos = np.zeros([n_step, n_agent_max, 3], np.float32)
    vel = np.zeros([n_step, n_agent_max, 2], np.float32)
    spd = np.zeros([n_step, n_agent_max, 1], np.float32)
    yaw = np.zeros([n_step, n_agent_max, 1], np.float32)
    atype = np.zeros([n_agent_max, 3], bool)
    cmd = np.zeros([n_agent_max, N_AGENT_CMD], bool)
    role = np.zeros([n_agent_max, 3], bool)
    size = np.zeros([n_agent_max, 3], np.float32)
    goal = np.zeros([n_agent_max, 4], np.float32)
    oid = np.full([n_agent_max], -1, np.int64)

    predict_set = set(scenario.get("track_index_predict", []))
    interest_set = set(scenario.get("object_id_interest", []))
    for i, tr in enumerate(tracks[:n_agent_max]):
        states = np.asarray(tr["states"], np.float32)
        v = states[:, 9] > 0
        valid[:, i] = v
        pos[v, i] = states[v, :3]
        yaw[v, i, 0] = states[v, 6]
        vel[v, i] = states[v, 7:9]
        sp = np.linalg.norm(states[v, 7:9], axis=-1)
        sign = np.sign(np.cos(states[v, 6]) * states[v, 7] + np.sin(states[v, 6]) * states[v, 8])
        spd[v, i, 0] = sp * sign
        if v.any():
            size[i] = states[v, 3:6].mean(axis=0)
            last = np.nonzero(v)[0][-1]
            goal[i] = (pos[last, i, 0], pos[last, i, 1], yaw[last, i, 0], spd[last, i, 0])
        atype[i, tr["type"]] = True
        oid[i] = tr["id"]
        role[i, 0] = i == scenario["sdc_track_index"]
        role[i, 1] = tr["id"] in interest_set
        role[i, 2] = i in predict_set
        c = classify_trajectory(valid[cur:, i], pos[cur:, i, :2], yaw[cur:, i, 0], spd[cur:, i, 0])
        cmd[i, max(c, 0)] = True

    # SDC to index 0 (ref pack_h5.py:260-271)
    sdc = int(np.nonzero(role[:, 0])[0][0])
    for arr in (valid, pos, vel, spd, yaw):
        arr[:, [0, sdc]] = arr[:, [sdc, 0]]
    for arr in (atype, cmd, role, size, goal, oid):
        arr[[0, sdc]] = arr[[sdc, 0]]

    def put(prefix, sl):
        ep[prefix + "agent/valid"] = valid[sl].copy()
        ep[prefix + "agent/pos"] = pos[sl].copy()
        ep[prefix + "agent/vel"] = vel[sl].copy()
        ep[prefix + "agent/spd"] = spd[sl].copy()
        ep[prefix + "agent/yaw_bbox"] = yaw[sl].copy()
        ep[prefix + "agent/object_id"] = oid.copy()
        ep[prefix + "agent/type"] = atype.copy()
        ep[prefix + "agent/role"] = role.copy()
        ep[prefix + "agent/size"] = size.copy()

    if pack_all:
        put("", slice(None))
        ep["agent/cmd"] = cmd.copy()
        ep["agent/goal"] = goal.copy()
    if pack_history:
        put("history/", slice(0, cur + 1))
        hist_invalid = ~ep["history/agent/valid"].any(0)
        ep["history/agent/object_id"][hist_invalid] = -1
        ep["history/agent/type"][hist_invalid] = False
        ep["history/agent/size"][hist_invalid] = 0


def pack_traffic_lights(
    scenario: Dict, ep: Dict[str, np.ndarray],
    pack_all: bool, pack_history: bool, n_tl_max: int = 100,
) -> None:
    """Ref pack_h5.py:305-345."""
    tls = scenario["tl_states"]
    n_step = len(tls)
    cur = scenario["current_step"]
    valid = np.zeros([n_step, n_tl_max], bool)
    state = np.zeros([n_step, n_tl_max], np.int64)
    lid = np.full([n_step, n_tl_max], -1, np.int64)
    stop = np.zeros([n_step, n_tl_max, 3], np.float32)
    for t, step_tl in enumerate(tls):
        n = len(step_tl["lane_state"])
        if n:
            valid[t, :n] = True
            state[t, :n] = step_tl["lane_state"]
            lid[t, :n] = step_tl["lane_id"]
            stop[t, :n] = step_tl["stop_point"]

    def put(prefix, sl):
        ep[prefix + "tl_lane/valid"] = valid[sl].copy()
        ep[prefix + "tl_lane/state"] = state[sl].copy()
        ep[prefix + "tl_lane/id"] = lid[sl].copy()
        ep[prefix + "tl_stop/pos"] = stop[sl].copy()

    if pack_all:
        put("", slice(None))
    if pack_history:
        put("history/", slice(0, cur + 1))


def center_at_sdc(ep: Dict[str, np.ndarray], rand_pos: float = -1, rand_yaw: float = -1,
                  rng: Optional[np.random.RandomState] = None) -> Tuple[np.ndarray, float]:
    """Re-express everything in the SDC frame at t=0. Ref pack_h5.py:348-416."""
    rng = rng or np.random
    prefixes = [p for p in ("", "history/") if p + "agent/valid" in ep]
    p0 = prefixes[0]
    center = ep[p0 + "agent/pos"][0, 0, :2].copy().astype(np.float64)
    yaw = float(ep[p0 + "agent/yaw_bbox"][0, 0, 0])
    if rand_pos > 0:
        center += rng.uniform(-rand_pos, rand_pos, 2)
    if rand_yaw > 0:
        yaw += float(rng.uniform(-rand_yaw, rand_yaw))

    mv = ep["map/valid"]
    ep["map/pos"][..., :2][mv] = se2_transform(ep["map/pos"][mv], center, yaw)
    ep["map/dir"][..., :2][mv] = so2_rotate(ep["map/dir"][mv][..., :2], yaw)

    for pf in prefixes:
        av = ep[pf + "agent/valid"]
        ep[pf + "agent/pos"][..., :2][av] = se2_transform(ep[pf + "agent/pos"][av], center, yaw)
        ep[pf + "agent/vel"][av] = so2_rotate(ep[pf + "agent/vel"][av], yaw)
        ep[pf + "agent/yaw_bbox"][av] -= yaw
        if pf + "tl_lane/valid" in ep:
            tv = ep[pf + "tl_lane/valid"]
            ep[pf + "tl_stop/pos"][..., :2][tv] = se2_transform(ep[pf + "tl_stop/pos"][tv], center, yaw)
        if pf == "" and "agent/goal" in ep:
            gv = ep["agent/valid"].any(0)
            ep["agent/goal"][..., :2][gv] = se2_transform(
                np.concatenate([ep["agent/goal"][gv, :2], np.zeros_like(ep["agent/goal"][gv, :1])], -1),
                center, yaw,
            )
            ep["agent/goal"][gv, 2] -= yaw
    return center, yaw


# ---------------------------------------------------------------------------
# stage 2: filtering to fixed capacity
# ---------------------------------------------------------------------------

def filter_map(ep: Dict[str, np.ndarray], n_pl: int, thresh_map: float = 120.0, thresh_z: float = 3.0):
    """Distance filter with progressive threshold halving. Ref pack_h5.py:449-519."""
    if "agent/valid" in ep:
        rel = ep["agent/role"].any(-1)
        av = ep["agent/valid"][:11, rel]
        ap = ep["agent/pos"][:11, rel]
    else:
        rel = ep["history/agent/role"].any(-1)
        av = ep["history/agent/valid"][:, rel]
        ap = ep["history/agent/pos"][:, rel]
    ap = ap[av]

    xmin, xmax = ap[:, 0].min(), ap[:, 0].max()
    ymin, ymax = ap[:, 1].min(), ap[:, 1].max()
    xt = max(xmax - xmin, thresh_map)
    yt = max(ymax - ymin, thresh_map)

    old = ep["map/valid"].copy()
    mp = ep["map/pos"]
    ep["map/valid"] &= (mp[..., 0] > xmin - xt) & (mp[..., 0] < xmax + xt)
    ep["map/valid"] &= (mp[..., 1] > ymin - yt) & (mp[..., 1] < ymax + yt)
    if thresh_z > 0:
        zmin, zmax = ap[:, 2].min(), ap[:, 2].max()
        zt = max(zmax - zmin, thresh_z)
        ep["map/valid"] &= (mp[..., 2] > zmin - zt) & (mp[..., 2] < zmax + zt)
    if ep["map/valid"].any(1).sum() < 10:
        # degenerate z (known bad episodes); keep the unfiltered map
        ep["map/valid"] = old

    ep["map/valid"][ep["map/valid"].sum(1) <= 3] = False

    thresh = thresh_map
    while ep["map/valid"].any(1).sum() > n_pl:
        remain = ep["map/valid"].any(1)
        for i in np.nonzero(remain)[0]:
            pts = ep["map/pos"][i][ep["map/valid"][i]]
            d = min(
                np.linalg.norm(ap[:, :2] - pts[0, :2], axis=1).min(),
                np.linalg.norm(ap[:, :2] - pts[-1, :2], axis=1).min(),
            )
            if d >= thresh:
                ep["map/valid"][i] = False
            if ep["map/valid"].any(1).sum() == n_pl:
                break
        thresh *= 0.5


def filter_traffic_lights(ep: Dict[str, np.ndarray]):
    """Drop tl entries whose lane vanished from the map. Ref pack_h5.py:419-446."""
    for pf in ("", "history/"):
        if pf + "tl_lane/valid" not in ep:
            continue
        v = ep[pf + "tl_lane/valid"]
        for t in range(v.shape[0]):
            for j in np.nonzero(v[t])[0]:
                pl_sel = ep["map/id"] == ep[pf + "tl_lane/id"][t, j]
                if ep["map/valid"][pl_sel].sum() == 0:
                    v[t, j] = False


def filter_agents(
    ep: Dict[str, np.ndarray], ep_reduced: Dict[str, np.ndarray],
    n_agent: int, prefix: str, dist_thresh_agent: float = 120.0, step_current: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Progressive agent pruning. Ref pack_h5.py:871-1012.

    Order: history-unseen; still & far from everything; off-lane parked
    vehicles; (train) erratic-yaw tracks; then distance pruning with
    threshold halving until <= n_agent. Returns (mask_sim, mask_no_sim).
    """
    valid = ep[prefix + "agent/valid"].copy()
    rel = ep[prefix + "agent/role"].any(-1)
    ap = ep[prefix + "agent/pos"][:, rel][ep[prefix + "agent/valid"][:, rel]][:, :2]
    thresh_spd = 2.0 if prefix == "" else 0.5
    n_max = valid.shape[1]

    # history-unseen
    unseen = (~rel) & ~(valid[: step_current + 1].any(0))
    valid &= ~unseen[None]

    lane_pos = ep_reduced["map/pos"][ep_reduced["map/valid"]][:, :2]

    # still & far from relevant agents and lanes
    still = (ep[prefix + "agent/spd"][..., 0].sum(0) * 0.1 < thresh_spd) & (~rel) & valid.any(0)
    for i in np.nonzero(still)[0]:
        if valid.any(0).sum() <= n_agent:
            break
        poses = ep[prefix + "agent/pos"][:, i, :2][valid[:, i]]
        if len(poses) == 0:
            continue
        far_agent = (
            np.linalg.norm(ap - poses[0], axis=1).min() > 20
            and np.linalg.norm(ap - poses[-1], axis=1).min() > 20
        )
        far_lane = (
            np.linalg.norm(lane_pos - poses[0], axis=1).min() > 20
            and np.linalg.norm(lane_pos - poses[-1], axis=1).min() > 20
        )
        if far_agent and far_lane:
            valid[:, i] = False

    # parked vehicles not associated to a lane and far from relevant agents
    mask_lane = ep_reduced["map/type"][:, DIM_VEH_LANES].any(-1, keepdims=True) & ep_reduced["map/valid"]
    pos_lane = ep_reduced["map/pos"][mask_lane]
    dir_lane = ep_reduced["map/dir"][mask_lane]
    dir_lane = dir_lane / np.maximum(np.linalg.norm(dir_lane, axis=-1, keepdims=True), 1e-9)
    veh_still = still & ep[prefix + "agent/type"][:, 0]
    for i in np.nonzero(veh_still)[0]:
        if valid.any(0).sum() <= n_agent or not valid[:, i].any():
            continue
        p_last = ep[prefix + "agent/pos"][:, i, :2][valid[:, i]][-1]
        y_last = ep[prefix + "agent/yaw_bbox"][:, i, 0][valid[:, i]][-1]
        heading = np.array([np.cos(y_last), np.sin(y_last)])
        cand = (np.linalg.norm(pos_lane - p_last, axis=1) < 3) & (dir_lane @ heading > 0)
        far = np.linalg.norm(ap - p_last, axis=1).min() > 10
        if far and not cand.any():
            valid[:, i] = False

    # erratic yaw (training only)
    if prefix == "" and valid.any(0).sum() > n_agent:
        yb = ep["agent/yaw_bbox"][..., 0]
        dyaw = np.abs((np.diff(yb, axis=0) + np.pi) % (2 * np.pi) - np.pi) * (valid[:-1] & valid[1:])
        max_dyaw = dyaw.max(0)
        total_disp = ep["agent/spd"][..., 0].sum(0) * 0.1
        bad_veh = (((total_disp < 6) & (max_dyaw > 0.5)) | (max_dyaw > 1.5)) & ep["agent/type"][:, 0]
        bad_pc = (((total_disp < 1) & (max_dyaw > 0.5)) | (max_dyaw > 1.5)) & ep["agent/type"][:, 1:].any(-1)
        bad = (bad_veh | bad_pc) & (~rel) & valid.any(0)
        valid[:, bad] = False

    # distance pruning with threshold halving
    thresh = dist_thresh_agent
    while valid.any(0).sum() > n_agent:
        remain = (~rel) & valid.any(0)
        for i in np.nonzero(remain)[0]:
            poses = ep[prefix + "agent/pos"][:, i, :2][valid[:, i]]
            close = min(
                np.linalg.norm(ap - poses[0], axis=1).min(),
                np.linalg.norm(ap - poses[-1], axis=1).min(),
            ) < thresh
            if not close:
                valid[:, i] = False
            if valid.any(0).sum() == n_agent:
                break
        thresh *= 0.5

    mask_sim = valid.any(0)
    mask_no_sim = ep[prefix + "agent/valid"].any(0) & (~mask_sim)
    return mask_sim, mask_no_sim


# ---------------------------------------------------------------------------
# stage 3: repack into the final fixed shapes
# ---------------------------------------------------------------------------

def repack_map(ep: Dict, out: Dict, n_pl: int, n_pl_type: int = 11):
    """Ref pack_h5.py:598-627."""
    n_nodes = ep["map/valid"].shape[1]
    out["map/valid"] = np.zeros([n_pl, n_nodes], bool)
    out["map/type"] = np.zeros([n_pl], np.int64)
    out["map/pos"] = np.zeros([n_pl, n_nodes, 2], np.float32)
    out["map/dir"] = np.zeros([n_pl, n_nodes, 2], np.float32)
    out["map/id"] = np.full([n_pl], -1, np.int64)
    sel = ep["map/valid"].any(1)
    n = int(sel.sum())
    out["map/valid"][:n] = ep["map/valid"][sel]
    out["map/type"][:n] = ep["map/type"][sel]
    out["map/pos"][:n] = ep["map/pos"][sel, :, :2]
    out["map/dir"][:n] = ep["map/dir"][sel, :, :2]
    out["map/id"][:n] = ep["map/id"][sel]
    out["map/type"] = np.eye(n_pl_type, dtype=bool)[out["map/type"]] & out["map/valid"].any(-1, keepdims=True)


def repack_traffic_lights(ep: Dict, out: Dict, n_tl: int, n_tl_state: int = 5):
    """Dual tl_lane (per affected map polyline) / tl_stop repr. Ref pack_h5.py:522-595."""
    for pf in ("", "history/"):
        if pf + "tl_lane/valid" not in ep:
            continue
        n_step, n_tl_max = ep[pf + "tl_lane/valid"].shape
        out[pf + "tl_lane/valid"] = np.zeros([n_step, n_tl], bool)
        out[pf + "tl_lane/state"] = np.zeros([n_step, n_tl], np.int64)
        out[pf + "tl_lane/idx"] = np.full([n_step, n_tl], -1, np.int64)
        out[pf + "tl_stop/valid"] = np.zeros([n_step, n_tl_max], bool)
        out[pf + "tl_stop/state"] = np.zeros([n_step, n_tl_max], np.int64)
        out[pf + "tl_stop/pos"] = np.zeros([n_step, n_tl_max, 2], np.float32)
        out[pf + "tl_stop/dir"] = np.zeros([n_step, n_tl_max, 2], np.float32)
        for t in range(n_step):
            c_lane = 0
            c_stop = 0
            for j in np.nonzero(ep[pf + "tl_lane/valid"][t])[0]:
                lane_idx = np.nonzero(out["map/id"] == ep[pf + "tl_lane/id"][t, j])[0]
                n_lanes = len(lane_idx)
                if n_lanes == 0 or c_lane + n_lanes > n_tl:
                    continue
                out[pf + "tl_lane/valid"][t, c_lane : c_lane + n_lanes] = True
                out[pf + "tl_lane/state"][t, c_lane : c_lane + n_lanes] = ep[pf + "tl_lane/state"][t, j]
                out[pf + "tl_lane/idx"][t, c_lane : c_lane + n_lanes] = lane_idx
                c_lane += n_lanes
                out[pf + "tl_stop/valid"][t, c_stop] = True
                out[pf + "tl_stop/state"][t, c_stop] = ep[pf + "tl_lane/state"][t, j]
                out[pf + "tl_stop/pos"][t, c_stop] = ep[pf + "tl_stop/pos"][t, j, :2]
                out[pf + "tl_stop/dir"][t, c_stop] = out["map/dir"][lane_idx[0], 0]
                c_stop += 1
        for key in ("tl_lane", "tl_stop"):
            oh = np.eye(n_tl_state, dtype=bool)[out[pf + f"{key}/state"]]
            out[pf + f"{key}/state"] = oh & out[pf + f"{key}/valid"][:, :, None]


def _interp_track(valid: np.ndarray, arrs: List[np.ndarray]) -> Tuple[slice, List[np.ndarray]]:
    """Linear gap interpolation over the valid span. Ref pack_h5.py:740-768."""
    steps = np.nonzero(valid)[0]
    s0, s1 = steps[0], steps[-1]
    x = np.arange(s0, s1 + 1)
    out = []
    for a in arrs:
        cols = [np.interp(x, steps, a[steps, d]) for d in range(a.shape[1])]
        out.append(np.stack(cols, -1).astype(np.float32))
    return slice(s0, s1 + 1), out


def find_dest(
    agent_type: np.ndarray, agent_goal: np.ndarray, map_edge: np.ndarray,
    pos_veh, dir_veh, map_id_veh, pl_idx_veh,
    pos_cyc, dir_cyc, pl_idx_cyc,
    pos_edge, pl_idx_edge,
    no_pred: bool = False, rng: Optional[np.random.RandomState] = None,
) -> int:
    """Type-dependent destination polyline. Ref pack_h5.py:797-867."""
    rng = rng or np.random
    yaw = agent_goal[2]
    heading = np.array([np.cos(yaw), np.sin(yaw)])
    goal_pos = agent_goal[:2]
    ext = goal_pos if no_pred else goal_pos + heading * agent_goal[3] * 5.0

    def nearest_edge():
        return int(pl_idx_edge[np.linalg.norm(pos_edge - ext, axis=1).argmin()])

    if agent_type[0]:  # vehicle: snap to lane, random-walk topology 1-3 hops
        if len(pos_veh) == 0:
            return nearest_edge() if len(pos_edge) else 0
        dp = np.linalg.norm(pos_veh - goal_pos, axis=1)
        dr = dir_veh @ heading
        cand = (dp < 3) & (dr > 0)
        if cand.any():
            if no_pred:
                return int(pl_idx_veh[cand][np.argmin(dp[cand])])
            dest_id = map_id_veh[cand][np.argmin(dp[cand])]
            next_id = dest_id
            counter = 0
            while True:
                nxt = np.nonzero(map_edge[:, 0] == next_id)[0]
                if len(nxt) == 0:
                    break
                dest_id, next_id = map_edge[rng.choice(nxt)]
                counter += 1
                if (next_id not in map_id_veh) or (len(nxt) > 1 and counter > 1) or counter > 3:
                    break
            hits = np.nonzero(map_id_veh == dest_id)[0]
            if len(hits):
                return int(pl_idx_veh[hits[-1]])
            return nearest_edge() if len(pos_edge) else 0
        return nearest_edge() if len(pos_edge) else 0
    if agent_type[1]:  # pedestrian
        return nearest_edge() if len(pos_edge) else 0
    # cyclist
    if len(pos_cyc):
        dp = np.linalg.norm(pos_cyc - ext, axis=1)
        dr = dir_cyc @ heading
        cand = (dp < 3) & (dr > 0)
        if cand.any():
            return int(pl_idx_cyc[cand][np.argmin(dp[cand])])
    return nearest_edge() if len(pos_edge) else 0


def repack_agents(
    ep: Dict, out: Dict, mask_sim: np.ndarray, n_agent: int, prefix: str,
    dest_no_pred: bool = False, rng: Optional[np.random.RandomState] = None,
):
    """Interp gaps, finite-diff acc/yaw_rate, find dest. Ref pack_h5.py:660-795."""
    n_step = ep[prefix + "agent/valid"].shape[0]
    for k, shape, dt in (
        ("valid", (n_step, n_agent), bool),
        ("pos", (n_step, n_agent, 2), np.float32),
        ("z", (n_step, n_agent, 1), np.float32),
        ("vel", (n_step, n_agent, 2), np.float32),
        ("spd", (n_step, n_agent, 1), np.float32),
        ("acc", (n_step, n_agent, 1), np.float32),
        ("yaw_bbox", (n_step, n_agent, 1), np.float32),
        ("yaw_rate", (n_step, n_agent, 1), np.float32),
    ):
        out[prefix + f"agent/{k}"] = np.zeros(shape, dt)
    out[prefix + "agent/object_id"] = np.full([n_agent], -1, np.int64)
    out[prefix + "agent/type"] = np.zeros([n_agent, 3], bool)
    out[prefix + "agent/role"] = np.zeros([n_agent, 3], bool)
    out[prefix + "agent/size"] = np.zeros([n_agent, 3], np.float32)
    if prefix == "":
        out["agent/cmd"] = np.zeros([n_agent, N_AGENT_CMD], bool)
        out["agent/goal"] = np.zeros([n_agent, 4], np.float32)
        out["agent/dest"] = np.zeros([n_agent], np.int64)
        # dest lookup tables
        n_pl, n_node = out["map/valid"].shape
        pl_grid = np.arange(n_pl)[:, None].repeat(n_node, 1)
        id_grid = out["map/id"][:, None].repeat(n_node, 1)
        m_veh = out["map/type"][:, DIM_VEH_LANES].any(-1, keepdims=True) & out["map/valid"]
        m_cyc = out["map/type"][:, DIM_CYC_LANES].any(-1, keepdims=True) & out["map/valid"]
        m_edge = out["map/type"][:, DIM_PED_LANES].any(-1, keepdims=True) & out["map/valid"]
        pos_veh, dir_veh = out["map/pos"][m_veh], out["map/dir"][m_veh]
        dir_veh = dir_veh / np.maximum(np.linalg.norm(dir_veh, axis=-1, keepdims=True), 1e-9)
        id_veh, idx_veh = id_grid[m_veh], pl_grid[m_veh]
        pos_cyc, dir_cyc = out["map/pos"][m_cyc], out["map/dir"][m_cyc]
        dir_cyc = dir_cyc / np.maximum(np.linalg.norm(dir_cyc, axis=-1, keepdims=True), 1e-9)
        idx_cyc = pl_grid[m_cyc]
        pos_edge, idx_edge = out["map/pos"][m_edge], pl_grid[m_edge]

    for i, idx in enumerate(np.nonzero(mask_sim)[0][:n_agent]):
        valid = ep[prefix + "agent/valid"][:, idx]
        if valid.sum() > 1:
            sl, (xy, z, vel, spd, yaw) = _interp_track(
                valid,
                [
                    ep[prefix + "agent/pos"][:, idx, :2],
                    ep[prefix + "agent/pos"][:, idx, 2:3],
                    ep[prefix + "agent/vel"][:, idx],
                    ep[prefix + "agent/spd"][:, idx],
                    np.unwrap(ep[prefix + "agent/yaw_bbox"][:, idx], axis=0),
                ],
            )
            out[prefix + "agent/valid"][sl, i] = True
            out[prefix + "agent/pos"][sl, i] = xy
            out[prefix + "agent/z"][sl, i] = z
            out[prefix + "agent/vel"][sl, i] = vel
            out[prefix + "agent/spd"][sl, i] = spd
            out[prefix + "agent/yaw_bbox"][sl, i] = yaw
            s0 = sl.start
            out[prefix + "agent/acc"][s0 + 1 : sl.stop, i] = np.diff(spd, axis=0) / 0.1
            out[prefix + "agent/yaw_rate"][s0 + 1 : sl.stop, i] = np.diff(yaw, axis=0) / 0.1
        elif valid.sum() == 1:
            t = np.nonzero(valid)[0][0]
            out[prefix + "agent/valid"][t, i] = True
            out[prefix + "agent/pos"][t, i] = ep[prefix + "agent/pos"][t, idx, :2]
            out[prefix + "agent/z"][t, i] = ep[prefix + "agent/pos"][t, idx, 2:3]
            out[prefix + "agent/vel"][t, i] = ep[prefix + "agent/vel"][t, idx]
            out[prefix + "agent/spd"][t, i] = ep[prefix + "agent/spd"][t, idx]
            out[prefix + "agent/yaw_bbox"][t, i] = ep[prefix + "agent/yaw_bbox"][t, idx]
        out[prefix + "agent/object_id"][i] = ep[prefix + "agent/object_id"][idx]
        out[prefix + "agent/type"][i] = ep[prefix + "agent/type"][idx]
        out[prefix + "agent/role"][i] = ep[prefix + "agent/role"][idx]
        out[prefix + "agent/size"][i] = ep[prefix + "agent/size"][idx]
        if prefix == "":
            out["agent/goal"][i] = ep["agent/goal"][idx]
            out["agent/cmd"][i] = ep["agent/cmd"][idx]
            out["agent/dest"][i] = find_dest(
                out["agent/type"][i], out["agent/goal"][i], ep["map/edge"],
                pos_veh, dir_veh, id_veh, idx_veh,
                pos_cyc, dir_cyc, idx_cyc, pos_edge, idx_edge,
                no_pred=dest_no_pred, rng=rng,
            )


def repack_agents_no_sim(ep: Dict, out: Dict, mask_no_sim: np.ndarray, n_no_sim: int, prefix: str):
    """Ref pack_h5.py:630-657."""
    n_step = ep[prefix + "agent/valid"].shape[0]
    out[prefix + "agent_no_sim/valid"] = np.zeros([n_step, n_no_sim], bool)
    out[prefix + "agent_no_sim/pos"] = np.zeros([n_step, n_no_sim, 2], np.float32)
    out[prefix + "agent_no_sim/z"] = np.zeros([n_step, n_no_sim, 1], np.float32)
    out[prefix + "agent_no_sim/vel"] = np.zeros([n_step, n_no_sim, 2], np.float32)
    out[prefix + "agent_no_sim/spd"] = np.zeros([n_step, n_no_sim, 1], np.float32)
    out[prefix + "agent_no_sim/yaw_bbox"] = np.zeros([n_step, n_no_sim, 1], np.float32)
    out[prefix + "agent_no_sim/object_id"] = np.full([n_no_sim], -1, np.int64)
    out[prefix + "agent_no_sim/type"] = np.zeros([n_no_sim, 3], bool)
    out[prefix + "agent_no_sim/size"] = np.zeros([n_no_sim, 3], np.float32)
    for i, idx in enumerate(np.nonzero(mask_no_sim)[0][:n_no_sim]):
        out[prefix + "agent_no_sim/valid"][:, i] = ep[prefix + "agent/valid"][:, idx]
        out[prefix + "agent_no_sim/pos"][:, i] = ep[prefix + "agent/pos"][:, idx, :2]
        out[prefix + "agent_no_sim/z"][:, i] = ep[prefix + "agent/pos"][:, idx, 2:3]
        out[prefix + "agent_no_sim/vel"][:, i] = ep[prefix + "agent/vel"][:, idx]
        out[prefix + "agent_no_sim/spd"][:, i] = ep[prefix + "agent/spd"][:, idx]
        out[prefix + "agent_no_sim/yaw_bbox"][:, i] = ep[prefix + "agent/yaw_bbox"][:, idx]
        out[prefix + "agent_no_sim/object_id"][i] = ep[prefix + "agent/object_id"][idx]
        out[prefix + "agent_no_sim/type"][i] = ep[prefix + "agent/type"][idx]
        out[prefix + "agent_no_sim/size"][i] = ep[prefix + "agent/size"][idx]


def get_map_boundary(map_valid: np.ndarray, map_pos: np.ndarray) -> np.ndarray:
    """Ref pack_h5.py:49-63."""
    pos = map_pos[map_valid]
    return np.array([pos[:, 0].min(), pos[:, 0].max(), pos[:, 1].min(), pos[:, 1].max()], np.float32)


# ---------------------------------------------------------------------------
# top-level: pack one scenario for a given split
# ---------------------------------------------------------------------------

def pack_scenario(
    scenario: Dict,
    split: str,  # "training" | "validation" | "testing"
    n_pl: int = 1024, n_tl: int = 100, n_tl_stop: int = 40,
    n_agent: int = 64, n_agent_no_sim: int = 256,
    rand_pos: float = 50.0, rand_yaw: float = 3.14,
    seed: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Scenario dict -> (fixed-shape episode, attrs). Ref pack_h5_womd.py:218-386.

    tl_stop slots are sized by the raw tl buffer (n_tl_stop=40) while the
    tl_lane expansion gets n_tl=100 slots, matching the datamodule contract
    (data_h5_womd.py:83-84).
    """
    rng = np.random.RandomState(seed)
    pack_all = split in ("training", "validation")
    pack_history = split in ("validation", "testing")

    ep = pack_map(scenario)
    pack_agents(scenario, ep, pack_all, pack_history)
    pack_traffic_lights(scenario, ep, pack_all, pack_history, n_tl_max=n_tl_stop)
    center, yaw = center_at_sdc(
        ep,
        rand_pos=rand_pos if split == "training" else -1,
        rand_yaw=rand_yaw if split == "training" else -1,
        rng=rng,
    )
    filter_map(ep, n_pl)
    filter_traffic_lights(ep)

    out: Dict[str, np.ndarray] = {}
    repack_map(ep, out, n_pl)
    repack_traffic_lights(ep, out, n_tl)

    if split == "training":
        mask_sim, _ = filter_agents(ep, out, n_agent, "")
        repack_agents(ep, out, mask_sim, n_agent, "", rng=rng)
    elif split == "validation":
        mask_sim, mask_no_sim = filter_agents(ep, out, n_agent, "")
        repack_agents(ep, out, mask_sim, n_agent, "", rng=rng)
        repack_agents(ep, out, mask_sim, n_agent, "history/", rng=rng)
        repack_agents_no_sim(ep, out, mask_no_sim, n_agent_no_sim, "")
        repack_agents_no_sim(ep, out, mask_no_sim, n_agent_no_sim, "history/")
    else:  # testing
        mask_sim, mask_no_sim = filter_agents(ep, out, n_agent, "history/")
        repack_agents(ep, out, mask_sim, n_agent, "history/", dest_no_pred=True, rng=rng)
        repack_agents_no_sim(ep, out, mask_no_sim, n_agent_no_sim, "history/")

    out["map/boundary"] = get_map_boundary(out["map/valid"], out["map/pos"])
    out.pop("map/id", None)
    attrs = {
        "scenario_id": scenario.get("scenario_id", ""),
        "scenario_center": center,
        "scenario_yaw": yaw,
        "with_map": bool(out["map/valid"].any()),
    }
    return out, attrs


def write_h5(episodes, path: str):
    """Write packed episodes (iterable of (episode, attrs)) to an h5 file."""
    import h5py

    n = 0
    with h5py.File(path, "w") as hf:
        for i, (ep, attrs) in enumerate(episodes):
            g = hf.create_group(str(i))
            for k, v in ep.items():
                g.create_dataset(k, data=v, compression="gzip")
            for k, v in attrs.items():
                g.attrs[k] = v
            n += 1
        hf.attrs["data_len"] = n
    return n
