"""Port simulation pieces (dynamics, teacher forcing, rules, rewards) against JAX (CPU).

Same numpy inputs through both packages. Tolerance: floats atol = rtol =
1e-5 (fp32, ulp-level libm differences in sin/cos/atan2); booleans exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO
from trafficbots_tpu.distributions import DiagGaussian as JDiag
from trafficbots_tpu.sim import dynamics as jdyn
from trafficbots_tpu.sim import rewards as jrew
from trafficbots_tpu.sim import rules as jru
from trafficbots_tpu.sim import teacher_forcing as jtf
from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.distributions import DiagGaussian as TDiag
from trafficbots_tpu_torch.sim import dynamics as tdyn
from trafficbots_tpu_torch.sim import rewards as trew
from trafficbots_tpu_torch.sim import rules as tru
from trafficbots_tpu_torch.sim import teacher_forcing as ttf

from tiny import tiny_batch, tiny_config
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)
B, A = 3, 6


def _rs(seed):
    return np.random.RandomState(seed)


def _agent(rs):
    valid = rs.rand(B, A) < 0.8
    state = np.concatenate(
        [rs.uniform(-60, 60, (B, A, 2)), rs.uniform(-3, 3, (B, A, 1)), rs.uniform(0, 15, (B, A, 1))], -1
    ).astype(np.float32)
    vel, acc, yr = (rs.normal(size=(B, A, n)).astype(np.float32) for n in (2, 1, 1))
    atype = np.eye(3, dtype=bool)[rs.randint(0, 3, (B, A))]
    return valid, state, vel, acc, yr, atype


def _cmp(t, j, name=""):
    j = np.asarray(j)
    if j.dtype == bool:
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    else:
        np.testing.assert_allclose(t.numpy(), j, err_msg=name, **TOL)


@pytest.mark.parametrize("ablation", ["traffic_bots", "trafficsim"])
def test_dynamics_update_override_kill(ablation):
    from trafficbots_tpu.config import ablation as jabl

    cfg = jabl(ablation)
    rs = _rs(0)
    valid, state, vel, acc, yr, atype = _agent(rs)
    mean, log_std = rs.normal(size=(B, A, 2)).astype(np.float32), np.full((B, A, 2), -2.0, np.float32)
    jp = JO.make_dyn_params(cfg)
    tp = TO.make_dyn_params(cfg)
    ja = jdyn.init_agent_state(*map(jnp.asarray, (valid, state, vel, acc, yr)))
    ta = tdyn.init_agent_state(*map(torch.from_numpy, (valid, state, vel, acc, yr)))
    jn, jact, jlp = jdyn.dynamics_update(jp, ja, jnp.asarray(atype), JDiag(jnp.asarray(mean), jnp.asarray(log_std)),
                                         jax.random.PRNGKey(0), deterministic=True)
    tn, tact, tlp = tdyn.dynamics_update(tp, ta, torch.from_numpy(atype),
                                         TDiag(torch.from_numpy(mean), torch.from_numpy(log_std)), None, True)
    for f in ("valid", "killed", "state", "vel", "acc", "yaw_rate"):
        _cmp(getattr(tn, f), getattr(jn, f), f)
    _cmp(tact, jact)
    _cmp(tlp, jlp)
    mask = rs.rand(B, A) < 0.5
    over = {"state": state + 1.0, "vel": vel * 2, "acc": acc - 1, "yaw_rate": yr + 0.5}
    jo = jdyn.override_states(jn, {k: jnp.asarray(v) for k, v in over.items()}, jnp.asarray(mask))
    to = tdyn.override_states(tn, {k: torch.from_numpy(v) for k, v in over.items()}, torch.from_numpy(mask))
    out_now, gt_valid = rs.rand(B, A) < 0.4, rs.rand(B, A) < 0.5
    jk = jdyn.kill(jo, jnp.asarray(out_now), jnp.asarray(gt_valid))
    tk = tdyn.kill(to, torch.from_numpy(out_now), torch.from_numpy(gt_valid))
    for f in ("valid", "killed", "state", "vel", "acc", "yaw_rate"):
        _cmp(getattr(tk, f), getattr(jk, f), f)


@pytest.mark.parametrize("name", ["tf_training", "tf_reactive_replay", "tf_joint_future_pred", "horizon_sdc"])
def test_teacher_forcing_mask(name):
    cfg = tiny_config(n_step=91, time_step_end=90)
    tfc = getattr(cfg, name) if name != "horizon_sdc" else dataclasses.replace(cfg.tf_training, step_horizon=30, gt_sdc=True)
    v = tiny_batch(cfg, n_scene=3, seed=1)["agent/valid"]
    j = jtf.teacher_forcing_mask(JO.tf_cfg_to_sim(tfc), jnp.asarray(v), current_epoch=2)
    t = ttf.teacher_forcing_mask(TO.tf_cfg_to_sim(tfc), torch.from_numpy(v), current_epoch=2)
    _cmp(t, j)


def _rule_inputs(seed):
    cfg = tiny_config()
    b = tiny_batch(cfg, n_scene=B, seed=seed)
    rs = _rs(seed)
    n_agent = b["agent/valid"].shape[2]
    valid = rs.rand(B, n_agent) < 0.9
    state = np.concatenate([b["agent/pos"][:, 12], b["agent/yaw_bbox"][:, 12], b["agent/spd"][:, 12]], -1)
    state[0, :2, :2] = [[0.0, 0.0], [1.0, 0.5]]  # a colliding pair
    state[1, 0, :2] = [250.0, 0.0]  # outside the map boundary
    state[2, :, 3] = 1.0  # slow: passive candidates
    keys = ("map/boundary", "map/valid", "map/type", "map/pos", "map/dir", "agent/type", "agent/size",
            "agent/goal", "agent/dest")
    tl = [b["tl_stop/valid"][:, 12], b["tl_stop/pos"][:, 12], b["tl_stop/state"][:, 12]]
    tl[2][:, :, 1] = True  # red everywhere
    return [b[k] for k in keys], valid, state.astype(np.float32), tl


@pytest.mark.parametrize("enable_all", [False, True])
def test_rules_constants_and_check(enable_all):
    consts_in, valid, state, tl = _rule_inputs(2)
    flags = dict(enable_check_collided=enable_all, enable_check_run_road_edge=enable_all,
                 enable_check_run_red_light=enable_all, enable_check_passive=enable_all)
    jc = jru.init_rule_constants(*map(jnp.asarray, consts_in), cfg=jru.RuleConfig(**flags))
    tc = tru.init_rule_constants(*map(torch.from_numpy, consts_in), cfg=tru.RuleConfig(**flags))
    for f in dataclasses.fields(tc):
        _cmp(getattr(tc, f.name), getattr(jc, f.name), f.name)
    js, ts = jru.init_rule_state(B, valid.shape[1]), tru.init_rule_state(B, valid.shape[1])
    for step in range(3):  # sticky flags and the passive counter carry over
        js, jv = jru.check_rules(jru.RuleConfig(**flags), jc, js, jnp.asarray(valid), jnp.asarray(state),
                                 *map(jnp.asarray, tl))
        ts, tv = tru.check_rules(tru.RuleConfig(**flags), tc, ts, torch.from_numpy(valid), torch.from_numpy(state),
                                 *map(torch.from_numpy, tl))
        assert tv.keys() == jv.keys()
        for k in jv:
            _cmp(tv[k], jv[k], k)
        _cmp(ts.passive_counter, js.passive_counter)
        state = state + np.float32(0.05)


@pytest.mark.parametrize("w_collision,reduce_max,angular", [(0.0, True, "cosine"), (1.0, True, "cast"), (1.0, False, "vector")])
def test_differentiable_reward(w_collision, reduce_max, angular):
    rs = _rs(3)
    valid, state, *_ = _agent(rs)
    gt_valid = rs.rand(B, A) < 0.7
    gt_state = (state + rs.normal(size=state.shape) * 0.5).astype(np.float32)
    size = rs.uniform(1.5, 5, (B, A, 3)).astype(np.float32)
    state[0, 1, :2] = state[0, 0, :2] + 0.5
    kw = dict(w_collision=w_collision, reduce_collision_with_max=reduce_max, angular_type_rot=angular)
    j = jrew.differentiable_reward(jrew.RewardConfig(**kw), *map(jnp.asarray, (valid, state, gt_valid, gt_state, size)))
    t = trew.differentiable_reward(trew.RewardConfig(**kw), *map(torch.from_numpy, (valid, state, gt_valid, gt_state, size)))
    _cmp(t[0], j[0])
    _cmp(t[1], j[1])
