"""Synthetic raw (world-frame, pre-packing) scenarios for testing the ETL.

A copy of `trafficbots_tpu/data/synthetic_scenario.py` kept by the port instead of importing
the JAX package; tests/test_torch_data.py holds its code equal to the
original's (docstrings and comments aside).

Produces the neutral Scenario dict consumed by data.packing.pack_scenario —
the pre-packing analog of synthetic.synthetic_episode_batch.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_scenario(
    seed: int = 0,
    n_step: int = 91,
    n_tracks: int = 12,
    n_lanes: int = 10,
    current_step: int = 10,
) -> Dict:
    rng = np.random.RandomState(seed)
    center = rng.uniform(-1000, 1000, 2)

    tracks = []
    for i in range(n_tracks):
        x, y = center + rng.uniform(-60, 60, 2)
        th = rng.uniform(-np.pi, np.pi)
        v = rng.uniform(0, 15)
        length, width, height = rng.uniform(3.5, 5.5), rng.uniform(1.6, 2.2), 1.6
        t0 = 0 if i < n_tracks // 2 else rng.randint(0, n_step // 2)
        t1 = n_step if rng.rand() < 0.7 else rng.randint(t0 + 2, n_step + 1)
        states = []
        for t in range(n_step):
            valid = float(t0 <= t < t1)
            # random gaps inside the valid span (tests interpolation)
            if valid and rng.rand() < 0.02 and t0 < t < t1 - 1:
                valid = 0.0
            states.append(
                [x, y, 0.0, length, width, height, th, v * np.cos(th), v * np.sin(th), valid]
            )
            x += v * np.cos(th) * 0.1
            y += v * np.sin(th) * 0.1
            th += rng.uniform(-0.01, 0.01)
        tracks.append({"id": 100 + i, "type": int(rng.choice([0, 0, 0, 1, 2])), "states": states})
    tracks[0]["type"] = 0  # SDC is a vehicle

    map_features = []
    edges = []
    lane_type_cycle = [0, 1, 2, 3, 4, 4, 6, 7, 1, 0]
    for p in range(n_lanes):
        start = center + rng.uniform(-150, 150, 2)
        th = rng.uniform(-np.pi, np.pi)
        n_pts = rng.randint(10, 60)
        pts = []
        pt = np.array([start[0], start[1], 0.0])
        for _ in range(n_pts):
            pts.append(pt.tolist())
            pt = pt + np.array([np.cos(th), np.sin(th), 0.0]) * 2.0
            th += rng.uniform(-0.03, 0.03)
        mf_type = lane_type_cycle[p % len(lane_type_cycle)]
        map_features.append({"id": p, "type": mf_type, "xyz": pts})
        if mf_type <= 2:
            edges.append([p, (p + 1) % n_lanes if lane_type_cycle[(p + 1) % len(lane_type_cycle)] <= 2 else -1])

    tl_states = []
    for t in range(n_step):
        tl_states.append(
            {
                "lane_state": [1, 3],
                "lane_id": [0, 1],
                "stop_point": [
                    (center + rng.uniform(-5, 5, 2)).tolist() + [0.0],
                    (center + rng.uniform(-5, 5, 2)).tolist() + [0.0],
                ],
            }
        )

    return {
        "scenario_id": f"synthetic_{seed}",
        "current_step": current_step,
        "sdc_track_index": 0,
        "track_index_predict": [1, 2],
        "object_id_interest": [101],
        "tracks": tracks,
        "map_features": map_features,
        "map_edges": edges,
        "tl_states": tl_states,
    }
