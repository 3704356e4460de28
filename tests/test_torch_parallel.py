"""The port's data parallelism (`trafficbots_tpu_torch/parallel/mesh.py`, the
data-parallel training step) on two gloo ranks on the CPU, against the JAX
package's `make_jitted_dp_train_step` over `make_mesh(2)`.

One launch of two rank processes (tests/torch_dp_worker.py, one torch
thread each) serves the file; it runs while the JAX step compiles. The
ranks check the mesh functions (the ragged `allgather_pyobj`, the WOMD and
submission unions, `all_reduce_mean_`, `all_reduce_sum`, `rank_seed`) and
take two data-parallel training steps on their halves of a 4-scene global
batch, under tests/test_torch_training.py's set-up: every dropout rate 0,
the latent noise injected equally inside each rank (JAX's shard_map traces
the same sampler on each shard), a 20-step horizon, the prior branch, clip
0.5 (it fires). Tolerances as that file's `two_updates`: the loss and every
metric within rtol 1e-5, the grad norms within rtol 1e-4, each leaf's
update within a relative norm error of 1e-2 (the leaves whose exact
gradient is 0 moved by at most 2 lr on both sides). The two ranks'
parameters must be equal to the bit.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import trafficbots_tpu.distributions as JD  # noqa: E402
from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.config import config_to_dict  # noqa: E402
from trafficbots_tpu.parallel.mesh import make_mesh, put_global_batch, replicate  # noqa: E402
from trafficbots_tpu.training import train as JT  # noqa: E402
import trafficbots_tpu_torch.distributions as TD  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu_torch.parallel import mesh  # noqa: E402
from trafficbots_tpu_torch.parallel.launch import launch  # noqa: E402
from trafficbots_tpu_torch.weights import flax_paths  # noqa: E402

from test_torch_training import GRAD_RTOL, TOL, UPDATE_RTOL, flat_flax, no_dropout, zero_gradient_leaf  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

N_SCENE, N_STEPS, SEED = 4, 2, 11


def dp_config():
    cfg = no_dropout(tiny_config(n_step=31, time_step_end=20))
    return dataclasses.replace(cfg, p_training_rollout_prior=1.0,
                               optimizer=dataclasses.replace(cfg.optimizer, gradient_clip_val=0.5))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results beside JAX's two data-parallel steps on the same
    global batch and weights."""
    work = tmp_path_factory.mktemp("dp")
    cfg = dp_config()
    batch = tiny_batch(cfg, n_scene=N_SCENE, seed=0)
    jmodel, params = JO.init_params(cfg, jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    per = N_SCENE // 2
    eps = np.random.RandomState(7).normal(size=(per, cfg.data.n_agent, cfg.model.latent_encoder.latent_dim))
    eps = eps.astype(np.float32)
    params0 = {k: np.array(v) for k, v in flat_flax(params).items()}  # the step donates its inputs
    np.savez(work / "params.npz", **params0)
    np.savez(work / "batch.npz", **batch)
    np.save(work / "eps.npy", eps)
    (work / "cfg.json").write_text(json.dumps(config_to_dict(cfg)))

    import threading

    ranks = {}

    def go():
        try:
            ranks["out"], ranks["results"] = launch("torch_dp_worker:rank_main", 2,
                                                    dict(workdir=str(work), seed=SEED, n_steps=N_STEPS),
                                                    timeout_s=300)
        except RuntimeError as e:
            ranks["error"] = e

    thread = threading.Thread(target=go)
    thread.start()
    mp = pytest.MonkeyPatch()
    mp.setattr(JD.DiagGaussian, "sample",
               lambda self, key, deterministic=True:
               self.mean if deterministic is True else self.mean + self.stddev * jnp.asarray(eps))
    try:
        tx = JT.make_optimizer(cfg, params)
        m2 = make_mesh(2)
        step = JT.make_jitted_dp_train_step(cfg, jmodel, tx, m2)
        # placed as run.py places them and not weakly typed (the init's
        # constants are), so the second step reuses the first's program
        strong = jax.tree_util.tree_map(np.array, params)
        jb = put_global_batch(batch, m2)
        p, opt_state, jm = replicate(strong, m2), replicate(tx.init(strong), m2), []
        for i in range(N_STEPS):
            p, opt_state, m = step(p, opt_state, jb, jax.random.PRNGKey(i))
            jm.append({k: float(v) for k, v in m.items()})
    finally:
        mp.undo()
    thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return dict(cfg=cfg, params0=params0, jparams=flat_flax(p), jm=jm, results=ranks["results"])


def test_allgather_pyobj_gathers_ragged_objects_in_rank_order(run):
    for res in run["results"]:
        got = res["collectives"]["gathered"]
        assert len(got) == 2 and len(got[0]) == 2 and got[1]["b"].shape == (2, 5)
        np.testing.assert_array_equal(got[0][1], np.arange(3))
        assert res["collectives"]["world"] == 2 and res["collectives"]["is_main"] == (res["collectives"]["rank"] == 0)


def test_womd_sync_unions_the_ranks_inputs_in_rank_order_once(run):
    for res in run["results"]:
        c = res["collectives"]
        assert c["womd_rows"] == [[4, 0.0], [3, 0.5], [2, 1.0]]
        assert c["womd_rows_again"] == [4, 3, 2]


def test_sub_sync_unions_the_ranks_payloads_in_rank_order_once(run):
    for res in run["results"]:
        c = res["collectives"]
        assert c["payloads"] == {1: [b"p0a", b"p0b", b"p1a"], 2: [b"p0a", b"p0b", b"p1a"]}
        assert c["payloads_again"] == c["payloads"]


def test_all_reduce_mean_is_bitwise_the_halved_sum(run):
    g = []
    for r in range(2):
        gen = torch.Generator().manual_seed(SEED + r)
        g.append([torch.randn(3, 4, generator=gen), torch.randn(5, generator=gen) if r == 1 else torch.zeros(5),
                  torch.zeros(2, 2)])
    for res in run["results"]:
        got = res["collectives"]["grads"]
        for i in range(3):
            assert torch.equal(got[i], (g[0][i] + g[1][i]) / 2), i
        assert res["collectives"]["sum"] == {"x": 4.0, "n": 4.0}


def test_rank_seed_mixes_the_rank_and_is_the_identity_with_one_rank():
    assert mesh.world_size() == 1 and mesh.rank_seed(123) == 123 and mesh.rank_seed(123, 0, 1) == 123
    seeds = {mesh.rank_seed(123, r, 2) for r in range(2)}
    assert len(seeds) == 2 and all(0 <= s < 2**62 for s in seeds)


def test_rank_seeds_of_the_ranks(run):
    got = [res["collectives"]["rank_seed"] for res in run["results"]]
    assert got == [mesh.rank_seed(SEED, r, 2) for r in range(2)] and got[0] != got[1]


def test_global_batch_draws_keep_the_rank_rows_of_the_one_process_draw():
    """Each rank asks for its n rows; inside the context it gets exactly its
    rows of the draw one process makes for the global batch from the same
    generator state, and leaves the generator where that draw leaves it."""
    draws = (lambda g, n: TD.standard_normal((n, 3, 5), torch.float32, "cpu", g),
             lambda g, n: TD.standard_gumbel((n, 7), torch.float32, "cpu", g),
             lambda g, n: TD.DiagGaussian(torch.zeros(n, 4), torch.zeros(n, 4)).sample(g, False))
    for draw in draws:
        ref_gen = torch.Generator().manual_seed(3)
        ref = draw(ref_gen, 6)
        for world in (2, 3):
            n = 6 // world
            for r in range(world):
                gen = torch.Generator().manual_seed(3)
                with TD.global_batch_draws(r, world):
                    local = draw(gen, n)
                assert torch.equal(local, ref[r * n:(r + 1) * n])
                assert torch.equal(gen.get_state(), ref_gen.get_state())
        with TD.global_batch_draws(0, 1):  # one rank: the plain draw
            assert torch.equal(draw(torch.Generator().manual_seed(3), 6), ref)


def test_init_from_env_is_a_no_op_with_one_rank(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_from_env("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_from_env("cpu") is False
    assert mesh.world_size() == 1 and mesh.allgather_pyobj({"a": 1}) == [{"a": 1}]
    assert mesh.choose_backend("cpu", 2) == "gloo"


def test_dp_train_step_matches_jax_shard_map_step(run):
    cfg, jm = run["cfg"], run["jm"]
    for res in run["results"]:
        for step, (tm, j) in enumerate(zip(res["train"]["metrics"], jm)):
            assert j["grad_norm"] > 0.5  # the clip fires
            assert tm.keys() == j.keys()
            for k, v in j.items():
                rtol = GRAD_RTOL if k.startswith("grad_norm") else TOL["rtol"]
                np.testing.assert_allclose(tm[k], v, rtol=rtol, atol=TOL["atol"], err_msg=f"step {step} {k}")
    model = TO.make_model(config_from_dict(config_to_dict(cfg)), device="cpu")
    paths = flax_paths(model)
    p0 = run["params0"]
    lr = cfg.optimizer.lr
    for name, t in run["results"][0]["train"]["params"].items():
        path, transposed = paths[name]
        j, j0 = run["jparams"][path], p0[path]
        if transposed:
            j, j0 = j.T, j0.T
        t = t.numpy()
        if zero_gradient_leaf(name):
            assert np.abs(t - j0).max() <= 2 * lr and np.abs(j - j0).max() <= 2 * lr, path
            continue
        du = np.linalg.norm((t - j0) - (j - j0))
        assert du <= UPDATE_RTOL * np.linalg.norm(j - j0), (path, du)


def test_dp_ranks_parameters_are_bitwise_equal(run):
    a, b = (res["train"]["params"] for res in run["results"])
    assert a.keys() == b.keys()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
