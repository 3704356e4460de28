"""Shape-bucketed batches: slice fixed-capacity axes to the batch's real use.

A copy of `trafficbots_tpu/data/bucketing.py` kept by the port instead of importing
the JAX package; tests/test_torch_data.py holds its code equal to the
original's (docstrings and comments aside).

The text below is the JAX package's: where it speaks of XLA programs, the
port's kernels take their shapes from the tensors and nothing recompiles.

The h5 contract pads every episode to fixed capacities (1024 map polylines,
64 sim agents, 256 no-sim agents — ref data_h5_womd.py:80-84) so XLA sees
static shapes. Real scenes fill a variable PREFIX of each capacity (the
packer writes surviving entities sequentially: ref pack_h5.py:449-519 for
the map filter, :871-1012 for agents), so most batches carry mostly
padding. This module slices each capacity axis down to the batch maximum
rounded UP to a bucket multiple before the batch reaches the device:
every dense op in the program (attention targets, GRU/MLP rows, dest-head
logits, featurization) shrinks proportionally, multiplicatively with the
padding-aware kernels (ops/*) which skip intra-program.

XLA recompiles once per distinct bucket tuple; multiples of 128 polylines /
16 agents keep the bucket set tiny (<= 8 x 4 x 2 programs) and satisfy
every kernel divisibility constraint (node-encoder block 16, attention
row blocks). The persistent compilation cache amortizes across runs.

Exactness: padded entries are masked by `valid` everywhere downstream —
masked attention targets contribute exp(-inf) = 0, masked rows are zeroed,
dest logits of padded polylines underflow to softmax weight 0 — and all
integer index fields (gt/dest, tl_lane/idx) point at VALID entities, which
always live inside the kept prefix. The host-side slice and the
pre-processing views are bit-identical on the kept slots; deterministic
MODEL outputs agree to fp-tiling tolerance (XLA picks different matmul
tilings per shape, so cross-shape bit-equality is unattainable even for
identical math) — both pinned by tests/test_bucketing.py. Stochastic draws
(joint-future dest/latent sampling) differ in bits because categorical
sampling consumes per-logit randomness, with the identical distribution.

Multi-host: buckets are chosen from the LOCAL batch; with process-sharded
input the per-process maxima can differ, which would desynchronize the
global program. The caller therefore only enables bucketing when
the run is single-process (run.py).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# capacity-axis position per key suffix, AFTER the scene axis:
# step-indexed agent arrays are [S, T, A, ...] (axis 2), per-agent constants
# are [S, A, ...] (axis 1). Shared by agent/, history/agent/, agent_no_sim/
# and history/agent_no_sim/ (which carry a subset of the suffixes).
_AGENT_AXIS = {
    "valid": 2, "pos": 2, "spd": 2, "vel": 2, "yaw_bbox": 2, "yaw_rate": 2,
    "acc": 2, "z": 2,
    "cmd": 1, "dest": 1, "goal": 1, "object_id": 1, "role": 1, "size": 1,
    "type": 1,
}
_MAP_KEYS = ("map/valid", "map/type", "map/pos", "map/dir")  # axis 1


def _used_prefix(any_valid: np.ndarray) -> int:
    """any_valid [n_entity] bool -> last used index + 1 (>= 1)."""
    idx = np.nonzero(any_valid)[0]
    return int(idx[-1]) + 1 if idx.size else 1


def _bucket(n_used: int, multiple: int, capacity: int) -> int:
    b = ((n_used + multiple - 1) // multiple) * multiple
    return min(b, capacity)


def _slice_axis(a: np.ndarray, axis: int, n: int) -> np.ndarray:
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, n)
    return a[tuple(sl)]


def bucket_slice(
    batch: Dict[str, np.ndarray],
    pl_multiple: int = 128,
    agent_multiple: int = 16,
) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Slice the map/agent capacity axes of a HOST batch to bucketed maxima.

    Returns (sliced batch, {"n_pl": P', "n_agent": A', "n_agent_no_sim": C'}).
    Keys absent from the batch (e.g. no agent_no_sim in training) are fine.
    """
    out = dict(batch)
    buckets: Dict[str, int] = {}

    # ---- map polylines
    if "map/valid" in batch:
        mv = np.asarray(batch["map/valid"])
        P = mv.shape[1]
        used = _used_prefix(mv.any(axis=(0, 2)))
        P2 = _bucket(used, pl_multiple, P)
        buckets["n_pl"] = P2
        if P2 < P:
            for k in _MAP_KEYS:
                if k in out:
                    out[k] = _slice_axis(np.asarray(out[k]), 1, P2)

    # ---- agent groups (sim + no_sim, with their history/ twins)
    for group, name in (("agent", "n_agent"), ("agent_no_sim", "n_agent_no_sim")):
        vkey = f"{group}/valid"
        if vkey not in batch:
            continue
        av = np.asarray(batch[vkey])  # [S, T, A]
        A = av.shape[2]
        used = av.any(axis=(0, 1))
        hkey = f"history/{group}/valid"
        if hkey in batch:
            used = used | np.asarray(batch[hkey]).any(axis=(0, 1))
        A2 = _bucket(_used_prefix(used), agent_multiple, A)
        buckets[name] = A2
        if A2 < A:
            for prefix in (f"{group}/", f"history/{group}/"):
                for k in list(out):
                    if k.startswith(prefix):
                        suffix = k[len(prefix):]
                        ax = _AGENT_AXIS.get(suffix)
                        if ax is not None:
                            out[k] = _slice_axis(np.asarray(out[k]), ax, A2)
    return out, buckets
