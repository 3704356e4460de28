"""WOMD TFRecord -> Scenario-dict adapter + packing CLI.

A copy of `trafficbots_tpu/data/womd_adapter.py` kept by the port instead of importing
the JAX package; tests/test_torch_data.py holds its code equal to the
original's (docstrings and comments aside).

The proto parsing mirrors the upstream src/pack_h5_womd.py:58-196:
  - lanes: FREEWAY->0, SURFACE_STREET/UNDEFINED->1, stop-sign lanes
    override car lanes ->2, BIKE_LANE->3; polylines subsampled x2;
    exit_lanes become topology edges;
  - road edges: type+3 -> {4, 5};
  - road lines: broken->6, solid single->7, double->8;
  - speed bumps / driveways -> 9, crosswalks -> 10 via 4-corner polygon ->
    polyline conversion;
  - traffic-light states folded 9 -> 5 (unknown / stop / caution / go /
    flashing).

Requires tensorflow + waymo_open_dataset protos (gated import); everything
downstream of `scenario_from_womd_proto` is dependency-free.

CLI:
    python -m trafficbots_tpu_torch.data.womd_adapter --dataset training \
        --in-dir ./womd_scenario --out-dir ./h5 --n-workers 8
"""
from __future__ import annotations

import glob
import os
from argparse import ArgumentParser
from multiprocessing import Pool
from typing import Dict, Iterator, List, Optional

import numpy as np

from .packing import pack_scenario, polylines_from_polygon, write_h5


def fold_tl_state(state: int) -> int:
    """9 WOMD lane states -> 5. Ref pack_h5_womd.py:96-118."""
    if state == 0:
        return 0
    if state in (1, 4):
        return 1
    if state in (2, 5):
        return 2
    if state in (3, 6):
        return 3
    if state in (7, 8):
        return 4
    raise ValueError(state)


def scenario_from_womd_proto(scenario_proto) -> Dict:
    """Parse one scenario_pb2.Scenario into the neutral Scenario dict."""
    sc = scenario_proto

    tracks = []
    for tr in sc.tracks:
        states = [
            [s.center_x, s.center_y, s.center_z, s.length, s.width, s.height,
             s.heading, s.velocity_x, s.velocity_y, float(s.valid)]
            for s in tr.states
        ]
        tracks.append({"id": tr.id, "type": tr.object_type - 1, "states": states})

    mf_list: List[Dict] = []
    edges: List[List[int]] = []
    lane_ids_types: Dict[int, int] = {}
    for mf in sc.map_features:
        kind = mf.WhichOneof("feature_data")
        if kind is None:
            continue
        feat = getattr(mf, kind)
        if kind == "lane":
            t = {0: 1, 1: 0, 2: 1, 3: 3}[feat.type]
            xyz = [[p.x, p.y, p.z] for p in feat.polyline][::2]
            mf_list.append({"id": mf.id, "type": t, "xyz": xyz})
            lane_ids_types[mf.id] = len(mf_list) - 1
            if len(feat.exit_lanes) > 0:
                for e in feat.exit_lanes:
                    edges.append([mf.id, e])
            else:
                edges.append([mf.id, -1])
        elif kind == "stop_sign":
            for l_id in feat.lane:
                idx = lane_ids_types.get(l_id)
                if idx is not None and mf_list[idx]["type"] < 2:
                    mf_list[idx]["type"] = 2
        elif kind == "road_edge":
            xyz = [[p.x, p.y, p.z] for p in feat.polyline][::2]
            mf_list.append({"id": mf.id, "type": feat.type + 3, "xyz": xyz})
        elif kind == "road_line":
            if feat.type in (1, 4, 5):
                t = 6
            elif feat.type in (2, 6):
                t = 7
            else:
                t = 8
            xyz = [[p.x, p.y, p.z] for p in feat.polyline][::2]
            mf_list.append({"id": mf.id, "type": t, "xyz": xyz})
        elif kind in ("speed_bump", "driveway", "crosswalk"):
            xyz = np.array([[p.x, p.y, p.z] for p in feat.polygon])
            idx = np.linspace(0, xyz.shape[0], 4, endpoint=False, dtype=int)
            pls = polylines_from_polygon(xyz[idx])
            t = 9 if kind in ("speed_bump", "driveway") else 10
            for pl in pls:
                mf_list.append({"id": mf.id, "type": t, "xyz": pl.tolist()})

    tl_states = []
    for step_tl in sc.dynamic_map_states:
        tl_states.append(
            {
                "lane_state": [fold_tl_state(t.state) for t in step_tl.lane_states],
                "lane_id": [t.lane for t in step_tl.lane_states],
                "stop_point": [[t.stop_point.x, t.stop_point.y, t.stop_point.z] for t in step_tl.lane_states],
            }
        )

    return {
        "scenario_id": sc.scenario_id,
        "current_step": sc.current_time_index,
        "sdc_track_index": sc.sdc_track_index,
        "track_index_predict": [t.track_index for t in sc.tracks_to_predict],
        "object_id_interest": list(sc.objects_of_interest),
        "tracks": tracks,
        "map_features": mf_list,
        "map_edges": edges,
        "tl_states": tl_states,
    }


def iter_womd_scenarios(tfrecord_files: List[str]) -> Iterator[Dict]:
    import tensorflow as tf
    from waymo_open_dataset.protos import scenario_pb2  # type: ignore

    tf.config.set_visible_devices([], "GPU")
    for f in tfrecord_files:
        for record in tf.data.TFRecordDataset(f, compression_type=""):
            proto = scenario_pb2.Scenario()
            proto.ParseFromString(bytes(record.numpy()))
            yield scenario_from_womd_proto(proto)


def _pack_one(args):
    scenario, split, seed = args
    return pack_scenario(scenario, split, seed=seed)


def main():
    parser = ArgumentParser()
    parser.add_argument("--dataset", required=True, choices=["training", "validation", "testing"])
    parser.add_argument("--in-dir", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--n-workers", type=int, default=8)
    args = parser.parse_args()

    files = sorted(glob.glob(os.path.join(args.in_dir, "*")))
    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, f"{args.dataset}.h5")

    def jobs():
        for i, sc in enumerate(iter_womd_scenarios(files)):
            yield (sc, args.dataset, i)

    with Pool(args.n_workers) as pool:
        episodes = pool.imap(_pack_one, jobs(), chunksize=4)
        n = write_h5(episodes, out_path)
    print(f"packed {n} episodes -> {out_path}")


if __name__ == "__main__":
    main()
