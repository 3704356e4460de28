"""The port's WOMD post-processing against the JAX package, every branch, on
seeded numpy inputs: the default (K = k_pred, the temperature softmax
only), top-k, MTR-NMS, the k-means EM aggregation (ADE and FDE, with
duplicated modes so that the E-step leaves clusters empty and the split
runs), the empty-cluster split on its own, and MPA-NMS. Tolerance atol =
rtol = 1e-5 (fp32 norms, means and softmax in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu.config import PostProcessingConfig as JPP  # noqa: E402
from trafficbots_tpu.eval import postprocessing as jpp  # noqa: E402
from trafficbots_tpu_torch.config import PostProcessingConfig as TPP  # noqa: E402
from trafficbots_tpu_torch.eval import postprocessing as tpp  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
S, A, T = 2, 5, 16


def inputs(n_pred, seed, duplicates=False):
    rs = np.random.RandomState(seed)
    steps = np.cumsum(rs.normal(scale=0.5, size=(S, A, n_pred, T, 2)), axis=3)
    trajs = np.concatenate([steps, rs.normal(size=(S, A, n_pred, T, 2))], axis=-1).astype(np.float32)
    scores = rs.uniform(0.05, 1.0, size=(S, A, n_pred)).astype(np.float32)
    if duplicates:
        # six copies of one high-scoring mode: the greedy seeding picks
        # several of them, so the E-step leaves clusters empty
        trajs[:, :, 1:6] = trajs[:, :, :1]
        scores[:, :, :6] = 1.0
        scores[:, :, 6:] = 1e-3
    agent_type = np.eye(3, dtype=bool)[rs.randint(0, 3, size=(S, A))]
    valid = rs.rand(S, A) < 0.8
    return dict(valid=valid, scores=scores, trajs=trajs, agent_type=agent_type)


CASES = {
    "default: K = k_pred, temperature": (dict(), 6, False),
    "top-k": (dict(score_temperature=0.0), 12, False),
    "mtr-nms": (dict(mtr_nms_thresh=(2.5, 1.0, 2.0)), 12, False),
    "aggr ade with empty clusters": (dict(aggr_thresh=(2.0,), n_iter_em=3), 12, True),
    "aggr fde with empty clusters": (dict(aggr_thresh=(2.0,), n_iter_em=2, use_ade=False), 12, True),
    "aggr ade": (dict(aggr_thresh=(3.0,), n_iter_em=3), 12, False),
    "mpa-nms": (dict(mpa_nms_thresh=(3.0, 1.0, 2.0)), 6, False),
    "mpa-nms after top-k, fde": (dict(mpa_nms_thresh=(3.0, 1.0, 2.0), use_ade=False), 9, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_post_processing_branch_matches_jax(case):
    kw, n_pred, dup = CASES[case]
    x = inputs(n_pred, seed=len(case), duplicates=dup)
    j = jpp.waymo_post_processing(dataclasses.replace(JPP(), **kw), **{k: jnp.asarray(v) for k, v in x.items()})
    t = tpp.waymo_post_processing(dataclasses.replace(TPP(), **kw), **{k: torch.from_numpy(v) for k, v in x.items()})
    assert t.keys() == j.keys()
    for k, jv in j.items():
        if jv is None:
            assert t[k] is None, k
            continue
        assert tuple(t[k].shape) == jv.shape, k
        np.testing.assert_allclose(t[k].numpy(), np.asarray(jv), err_msg=k, **TOL)
    np.testing.assert_allclose(t["waymo_scores"].sum(-1).numpy(), 1.0, atol=1e-5)


def test_empty_cluster_split_matches_jax():
    """The split on its own, on assignments with 1-3 empty clusters per cell
    and ties for the largest."""
    rs = np.random.RandomState(0)
    K, P = 6, 12
    idx = rs.randint(0, 3, size=(3, 4, P))  # only clusters 0..2 used: 3-5 start empty
    idx[0, 0] = [0] * 6 + [1] * 6  # a tie for the largest
    idx[1, 1, :] = 4  # one cluster holds everything
    assign = np.eye(K, dtype=np.float32)[idx]
    j = np.asarray(jpp._split_largest_into_empty(jnp.asarray(assign), K))
    t = tpp._split_largest_into_empty(torch.from_numpy(assign), K).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t.sum(axis=2) > 0).all()
