"""The eval slice of the port against the JAX package, module by module and
end to end, at the tests/tiny.py widths on the CPU.

Weights: `orchestration.init_params` on the JAX side, then
`weights.load_jax_params` into the port. The JAX side runs its CPU paths
(the XLA attention and node stack, which the Pallas kernels match).

Tolerances:
  - encoders, latent distribution and single policy steps: atol = rtol =
    1e-5 in fp32 (the two CPU backends round sin/cos and order matmul sums
    differently, a few ulp);
  - the 91-step closed loop: booleans (validity, overrides, every violation
    flag) exactly and the action and latent log-probs within 1e-5, over all
    steps; preds within 1e-4 m over the first 20 steps (10 teacher-forced,
    10 closed-loop) and within 1e-3 m over the first HELD_STEPS = 50, and
    the rewards within 1e-3 over those 50. Past that the closed loop
    amplifies ulp-level differences about a thousandfold: the port's preds
    first leave 1e-3 m of JAX's at step 60 and end 4.6e-3 m away, while
    moving the map positions by one ulp moves JAX's own preds by 5.1e-3 m.
    So the whole horizon's preds and rewards are recorded as readings
    beside that one-ulp reading (junit properties), not held to a limit
    (ROADMAP.md, Queue 3).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO
from trafficbots_tpu.data.preprocessing import pre_processing as j_pre
from trafficbots_tpu.sim.teacher_forcing import teacher_forcing_mask as j_tf_mask
from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.data.preprocessing import pre_processing as t_pre, to_torch
from trafficbots_tpu_torch.models import goal_manager as TGM
from trafficbots_tpu_torch.weights import load_jax_params

from tiny import tiny_batch, tiny_config
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)
HELD_STEPS = 50  # the closed loop's steps held to ROLLOUT_ATOL; see the module docstring
ROLLOUT_ATOL = 1e-3  # metres


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(n_step=91, time_step_end=90)
    batch = tiny_batch(cfg, n_scene=2, seed=0)
    jmodel, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tmodel = TO.make_model(cfg, device="cpu")
    load_jax_params(tmodel, params_np)
    jb = j_pre({k: jnp.asarray(v) for k, v in batch.items()}, cfg.model, training=False)
    tb = t_pre(to_torch(batch, "cpu"), cfg.model, training=False)
    jf = JO.encode_episode_features(jmodel, params, jb, training=False, key=None)
    with torch.no_grad():
        tf = TO.encode_episode_features(tmodel, tb)
    return dict(cfg=cfg, batch=batch, jmodel=jmodel, params=params, params_np=params_np,
                tmodel=tmodel, jb=jb, tb=tb, jf=jf, tf=tf)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


def test_load_jax_params_is_strict(setup):
    cfg, p = setup["cfg"], setup["params_np"]
    m = TO.make_model(cfg, device="cpu")
    missing = {k: v for k, v in p.items() if k != "action_head"}
    with pytest.raises(KeyError, match="action_head"):
        load_jax_params(m, missing)
    extra = dict(p, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray/kernel"):
        load_jax_params(m, extra)
    bad = {k: v for k, v in p.items()}
    bad["tl_encoder"] = {"mlp": {**p["tl_encoder"]["mlp"], "fc0": {"kernel": np.zeros((6, 32), np.float32),
                                                                   "bias": p["tl_encoder"]["mlp"]["fc0"]["bias"]}}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(m, bad)
    load_jax_params(m, p)  # every array consumed, the goal_manager's predictor's too


def test_map_encoder(setup):
    jf, tf = setup["jf"]["input"], setup["tf"]["input"]
    _close(tf["map_feature"], jf["map_feature"])
    np.testing.assert_array_equal(tf["map_feature_valid"].numpy(), np.asarray(jf["map_feature_valid"]))


@pytest.mark.parametrize("view", ["input", "latent_post", "latent_prior"])
def test_agent_and_tl_encoders(setup, view):
    jf, tf = setup["jf"][view], setup["tf"][view]
    for k in ("agent_feature", "tl_feature"):
        _close(tf[k], jf[k])


@pytest.mark.parametrize("posterior", [True, False])
def test_latent_encoder(setup, posterior):
    view = "latent_post" if posterior else "latent_prior"
    j = setup["jmodel"].apply({"params": setup["params"]}, method="latent", posterior=posterior, **setup["jf"][view])
    with torch.no_grad():
        t = setup["tmodel"].latent(posterior=posterior, **setup["tf"][view])
    _close(t.mean, j.mean)
    _close(t.stddev, j.stddev)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


def test_gt_goal_and_dest_feature(setup):
    cfg, jb, tb = setup["cfg"], setup["jb"], setup["tb"]
    jg, jv = JO.get_gt_goal(cfg, jb["input/agent_valid"], jb["gt/goal"], jb["gt/dest"])
    tg, tv = TO.get_gt_goal(cfg, tb["input/agent_valid"], tb["gt/goal"], tb["gt/dest"])
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jmf, tmf = setup["jf"]["input"]["map_feature"], setup["tf"]["input"]["map_feature"]
    j = jnp.take_along_axis(jmf, jg[..., None], axis=1)
    _close(TGM.goal_feature(cfg.model.goal_manager, tg, None, tmf), j)


def test_policy_steps_carry_hidden(setup):
    """Three hidden-carrying policy steps with the bf16 map K/V cache and
    the hoisted goal/latent MLPs, as the rollout calls them."""
    cfg, jm, p, tm = setup["cfg"], setup["jmodel"], setup["params"], setup["tmodel"]
    jf, tf, jb, tb = setup["jf"]["input"], setup["tf"]["input"], setup["jb"], setup["tb"]
    ap = lambda method, **kw: jm.apply({"params": p}, method=method, **kw)  # noqa: E731
    rs = np.random.RandomState(0)
    B, A, d = jf["agent_feature"][:, 0].shape
    goal_f = rs.normal(size=(B, A, d)).astype(np.float32)
    lat = rs.normal(size=(B, A, cfg.model.latent_encoder.latent_dim)).astype(np.float32)
    gv = rs.rand(B, A) < 0.7
    jkv = ap("precompute_map_kv", map_feature=jf["map_feature"])
    jg, jl = ap("precompute_add_feats", goal_feature=jnp.asarray(goal_f), goal_valid=jnp.asarray(gv),
                latent_sample=jnp.asarray(lat), latent_valid=jnp.ones((B, A), bool))
    jh = ap("init_hidden", n_batch=B, n_agent=A)
    with torch.no_grad():
        tkv = tm.precompute_map_kv(tf["map_feature"])
        assert tkv[0][0].dtype == torch.bfloat16
        tg, tl = tm.precompute_add_feats(torch.from_numpy(goal_f), torch.from_numpy(gv),
                                         torch.from_numpy(lat), torch.ones((B, A), dtype=torch.bool))
        th = tm.init_hidden(B, A)
        for step in range(3):
            kw = dict(agent_valid=jb["input/agent_valid"][:, step], agent_feature=jf["agent_feature"][:, step],
                      map_valid=jf["map_feature_valid"], map_feature=None, map_kv=jkv,
                      tl_valid=jf["tl_feature_valid"][:, step], tl_feature=jf["tl_feature"][:, step],
                      goal_valid=jnp.asarray(gv), goal_feature=jnp.asarray(goal_f), latent_sample=jnp.asarray(lat),
                      hidden=jh, agent_type=jb["sc/agent_type"], goal_z_pre=jg, latent_z_pre=jl)
            jmean, jlog, jh, jx, _ = ap("policy_step", **kw)
            tkw = dict(agent_valid=tb["input/agent_valid"][:, step], agent_feature=tf["agent_feature"][:, step],
                       map_valid=tf["map_feature_valid"], map_feature=None, map_kv=tkv,
                       tl_valid=tf["tl_feature_valid"][:, step], tl_feature=tf["tl_feature"][:, step],
                       goal_valid=torch.from_numpy(gv), goal_feature=torch.from_numpy(goal_f),
                       latent_sample=torch.from_numpy(lat), hidden=th, agent_type=tb["sc/agent_type"],
                       goal_z_pre=tg, latent_z_pre=tl)
            tmean, tlog, th, tx = tm.policy_step(**tkw)
            _close(tx, jx)
            _close(th, jh)
            _close(tmean, jmean)
            _close(tlog, jlog)


@pytest.fixture(scope="module")
def rollouts(setup):
    """JAX's eval program (bench.py's eval_rollout) under ONE jax.jit, on the
    batch and on the batch with map positions moved by one ulp; the port's
    eval_rollout on the batch."""
    cfg, jm, params, batch = setup["cfg"], setup["jmodel"], setup["params"], setup["batch"]

    def ev(params, b):
        pb = j_pre(b, cfg.model, training=False)
        feats = JO.encode_episode_features(jm, params, pb, training=False, key=None)
        goal, goal_valid = JO.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
        latent = jm.apply({"params": params}, method="latent", posterior=True, **feats["latent_post"])
        mask_tf = j_tf_mask(JO.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])
        return JO.reactive_replay(cfg, jm, params, pb, feats["input"], latent, goal, goal_valid, mask_tf,
                                  jax.random.PRNGKey(1), deterministic_latent=True, deterministic_action=True)

    fn = jax.jit(ev)
    jbuf = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    nudged = dict(batch, **{"map/pos": np.nextafter(batch["map/pos"], np.float32(np.inf))})
    jbuf_nudged = fn(params, {k: jnp.asarray(v) for k, v in nudged.items()})
    tbuf = TO.eval_rollout(cfg, setup["tmodel"], batch, device="cpu")
    return jbuf, jbuf_nudged, tbuf


def test_eval_rollout_booleans_match_exactly(rollouts):
    jbuf, _, tbuf = rollouts
    assert tbuf.preds.shape == (2, 4, 90, 4)
    np.testing.assert_array_equal(tbuf.valid.numpy(), np.asarray(jbuf.valid))
    np.testing.assert_array_equal(tbuf.override_masks.numpy(), np.asarray(jbuf.override_masks))
    np.testing.assert_array_equal(tbuf.diffbar_rewards_valid.numpy(), np.asarray(jbuf.diffbar_rewards_valid))
    assert tbuf.violations.keys() == jbuf.violations.keys()
    for k, v in jbuf.violations.items():
        np.testing.assert_array_equal(tbuf.violations[k].numpy(), np.asarray(v), err_msg=k)
    assert tbuf.step_future_start == jbuf.step_future_start


def test_eval_rollout_preds_within_closed_loop_floor(rollouts, record_property):
    jbuf, jbuf_nudged, tbuf = rollouts
    jp, tp = np.asarray(jbuf.preds), tbuf.preds.numpy()
    assert np.isfinite(tp).all()
    # warm start + 10 closed-loop steps: ulp-close
    np.testing.assert_allclose(tp[:, :, :20], jp[:, :, :20], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp[:, :, :HELD_STEPS], jp[:, :, :HELD_STEPS], atol=ROLLOUT_ATOL, rtol=0)
    # readings over the whole horizon: the port's gap and JAX's own one-ulp sensitivity
    record_property("preds_max_abs_diff_all_steps_m", float(np.abs(tp - jp).max()))
    record_property("jax_preds_one_ulp_map_nudge_m", float(np.abs(np.asarray(jbuf_nudged.preds) - jp).max()))


def test_eval_rollout_rewards_and_log_probs(rollouts, record_property):
    jbuf, _, tbuf = rollouts
    tr, jr = tbuf.diffbar_rewards.numpy(), np.asarray(jbuf.diffbar_rewards)
    np.testing.assert_allclose(tr[:, :, :HELD_STEPS], jr[:, :, :HELD_STEPS], atol=ROLLOUT_ATOL, rtol=0)
    record_property("rewards_max_abs_diff_all_steps", float(np.abs(tr - jr).max()))
    np.testing.assert_allclose(tbuf.latent_log_probs.numpy(), np.asarray(jbuf.latent_log_probs), **TOL)
    np.testing.assert_allclose(tbuf.action_log_probs.numpy(), np.asarray(jbuf.action_log_probs), **TOL)


def test_entry_points_refuse_missing_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TO.make_model(setup["cfg"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TO.eval_rollout(setup["cfg"], setup["tmodel"], setup["batch"])
