"""The port's sharded validation on two gloo ranks on the CPU against the
JAX package's `Validator(mesh=make_mesh(2))` on the same global batch.

The set-up of tests/test_torch_validation.py's
`test_validator_metric_values_match_jax_at_a_nonzero_map`: the tiny widths
at n_step 91 (the WOMD metrics on), the "hybrid" node encoder, agents that
stand still under weights whose action head outputs 0, so every prediction
sits on the GT and the metrics are not all 0. JAX draws the joint futures'
noise for the global batch from one key; the ranks get the same global
arrays through `distributions._draw` and keep their rows under the rank
draw context (tests/torch_dp_worker.py), one scene a rank. Each rank's
`epoch_end` unions the metric sums, the WOMD inputs and the submission
payloads over the ranks: every one of the 142 WOMD metric values within
rtol 1e-5 of JAX's, the other metrics (the metric sums' means over the
global batch) within that file's tolerances, and both ranks' metrics
equal to the bit.
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import evaluation_loop as JE  # noqa: E402
from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.config import config_to_dict  # noqa: E402
from trafficbots_tpu.parallel.mesh import make_mesh  # noqa: E402
from trafficbots_tpu_torch.parallel.launch import launch  # noqa: E402

from test_torch_validation import KEY, SUM_RTOL, TOL, hybrid, jax_draws, still_batch, zeroed_action_head  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

N_SCENE = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import threading

    work = tmp_path_factory.mktemp("dpval")
    jcfg = hybrid(tiny_config(n_step=91, time_step_end=90))
    batch = still_batch(tiny_batch(jcfg, n_scene=N_SCENE, seed=0))
    jmodel, params = JO.init_params(jcfg, jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree_util.tree_map(np.array, zeroed_action_head(params))
    gumbel, normal = jax_draws(jcfg, N_SCENE, jax.random.PRNGKey(KEY))
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            walk(v, path) if hasattr(v, "items") else flat.__setitem__(path, np.asarray(v))

    walk(params)
    np.savez(work / "val_params.npz", **flat)
    np.savez(work / "val_batch.npz", **batch)
    np.savez(work / "draws.npz", gumbel=gumbel, normal=normal)
    (work / "val_cfg.json").write_text(json.dumps(config_to_dict(jcfg)))

    ranks = {}

    def go():
        try:
            ranks["out"], ranks["results"] = launch("torch_dp_worker:validate_main", 2, dict(workdir=str(work)),
                                                    timeout_s=300)
        except RuntimeError as e:
            ranks["error"] = e

    thread = threading.Thread(target=go)
    thread.start()
    jv = JE.Validator(jcfg, jmodel, use_native_metrics=False, mesh=make_mesh(2))
    jv.step(params, batch, jax.random.PRNGKey(KEY))
    jm = jv.epoch_end()
    thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return dict(jm=jm, results=ranks["results"], draws=(gumbel, normal))


def test_sharded_validator_metric_values_match_jax(run):
    jm = run["jm"]
    for res in run["results"]:
        tm = res["metrics"]
        assert tm.keys() == jm.keys()
        assert tm["val/loss"] == -tm["joint_future_pred/mean_average_precision"]
        assert tm["joint_future_pred/mean_average_precision"] > 0.5
        keys = [k for k in tm if k.startswith(("waymo_metrics/", "joint_future_pred/"))]
        assert len(keys) > 100 and sum(jm[k] != 0 for k in keys) > 20
        for k in keys:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
        for k in ("reactive_replay/vae_kl", "reactive_replay/goal_loss"):
            np.testing.assert_allclose(tm[k], jm[k], **TOL)
        np.testing.assert_allclose(tm["reactive_replay/err/pos_meter"], jm["reactive_replay/err/pos_meter"],
                                   rtol=SUM_RTOL)


def test_every_rank_computes_the_same_metrics(run):
    a, b = (res["metrics"] for res in run["results"])
    assert a.keys() == b.keys()
    assert [k for k in a if not (a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])))] == []


def test_each_rank_drew_its_rows_of_the_global_noise(run):
    gumbel, normal = run["draws"]
    k = gumbel.shape[0] // N_SCENE
    for r, res in enumerate(run["results"]):
        g, n = res["noise"]  # the goal draw, then the latent draw
        assert torch.equal(g, torch.from_numpy(gumbel[r * k:(r + 1) * k]))
        assert torch.equal(n, torch.from_numpy(normal[r * k:(r + 1) * k]))
