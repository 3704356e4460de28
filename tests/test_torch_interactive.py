"""The step-at-a-time sim (`sim/interactive.py`, `orchestration.interactive_replay`)
on the CPU at the tests/tiny.py widths, mirroring tests/test_interactive.py.

The interactive sim and `reactive_replay` run the same step body with the
same operations in the same order, so in the port `run_to_end().finish()`
equals `reactive_replay` bitwise (booleans and floats), and N steps equal
its first N step columns. An override step puts the forced agents exactly
at the given state. Against JAX's `interactive_replay`, with
tests/test_torch_slice.py's tolerances: booleans exactly, preds within 1e-4
m over the first 20 steps and 1e-3 m over the first 50.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.data.preprocessing import pre_processing as j_pre  # noqa: E402
from trafficbots_tpu.sim.teacher_forcing import teacher_forcing_mask as j_tf_mask  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import pre_processing as t_pre, to_torch  # noqa: E402
from trafficbots_tpu_torch.sim.teacher_forcing import teacher_forcing_mask  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

HELD_STEPS = 50
ROLLOUT_ATOL = 1e-3  # metres
PREFIX = 20
FIELDS = ("valid", "preds", "override_masks", "diffbar_rewards", "diffbar_rewards_valid", "latent_log_probs",
          "action_log_probs")


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(n_step=91, time_step_end=90)
    batch = tiny_batch(cfg, n_scene=2, seed=0)
    jmodel, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)
    tmodel = TO.make_model(cfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    tb = t_pre(to_torch(batch, "cpu"), cfg.model, training=False)
    with torch.no_grad():
        feats = TO.encode_episode_features(tmodel, tb, views=("input", "latent_post"))
        goal, goal_valid = TO.get_gt_goal(cfg, tb["input/agent_valid"], tb["gt/goal"], tb["gt/dest"])
        latent = tmodel.latent(posterior=True, **feats["latent_post"])
    mask_tf = teacher_forcing_mask(TO.tf_cfg_to_sim(cfg.tf_reactive_replay), tb["gt/valid"])
    args = (cfg, tmodel, tb, feats["input"], latent, goal, goal_valid, mask_tf)
    with torch.no_grad():
        ref = TO.reactive_replay(*args)
    return dict(cfg=cfg, batch=batch, jmodel=jmodel, params=params, args=args, ref=ref)


def make_sim(setup):
    return TO.interactive_replay(*setup["args"], device="cpu")


@pytest.fixture(scope="module")
def run_to_end(setup):
    """One interactive sim run to its end, shared: its buffer and its final
    carried state."""
    sim = make_sim(setup).run_to_end()
    return sim.finish(), sim.carry.agent.state.clone()


def test_run_to_end_equals_reactive_replay_bitwise(setup, run_to_end):
    buf, ref = run_to_end[0], setup["ref"]
    for name in FIELDS:
        assert torch.equal(getattr(buf, name), getattr(ref, name)), name
    assert buf.violations.keys() == ref.violations.keys()
    for k, v in ref.violations.items():
        assert torch.equal(buf.violations[k], v), k
    assert buf.step_future_start == ref.step_future_start
    assert buf.preds.shape == (2, 4, 90, 4)


def test_prefix_equals_the_replay_s_first_steps(setup):
    sim = make_sim(setup)
    for _ in range(PREFIX):
        sim.step()
    assert not sim.done and sim.t == PREFIX and sim.n_steps == 90
    buf = sim.finish()
    for name in FIELDS:
        assert torch.equal(getattr(buf, name), getattr(setup["ref"], name)[:, :, :PREFIX]), name


def forced(B, A):
    mask = torch.zeros((B, A), dtype=torch.bool)
    mask[:, 1:3] = True
    state = torch.tensor([1.5, -2.0, 0.25, 3.0]).expand(B, A, 4).clone()
    state[:, 2] = torch.tensor([-4.0, 7.5, -1.0, 0.5])
    return mask, dict(state=state, vel=torch.zeros(B, A, 2), acc=torch.zeros(B, A, 1), yaw_rate=torch.zeros(B, A, 1))


def test_intervention_forces_the_state_exactly(setup):
    """Forcing agents 1 and 2 mid-rollout lands exactly on the given state;
    the step's recorded prediction is the pre-override one; the other
    agents' rewards are untouched, and so are the carried states of those
    that neither run forced at that step."""
    sim, ref = make_sim(setup), make_sim(setup)
    for _ in range(4):
        sim.step()
        ref.step()
    B, A = sim.carry.agent.valid.shape
    mask, state = forced(B, A)
    out = sim.step(mask_override=mask, state_override=state)
    ref_out = ref.step()
    assert torch.equal(sim.carry.agent.state[:, 1:3], state["state"][:, 1:3])
    assert torch.equal(sim.carry.agent.vel[:, 1:3], state["vel"][:, 1:3])
    assert sim.carry.agent.valid[:, 1:3].all()
    assert torch.equal(out.pred, ref_out.pred)
    assert torch.equal(out.override_mask, mask)
    others = [0, 3]
    assert torch.equal(out.diffbar_reward[:, others], ref_out.diffbar_reward[:, others])
    # the override replaced the step's teacher forcing: agents neither run forced keep the same state
    free = ~mask & ~ref_out.override_mask
    assert free[:, others].any()
    assert torch.equal(sim.carry.agent.state[free], ref.carry.agent.state[free])
    with pytest.raises(ValueError, match="requires mask_override"):
        sim.step(state_override=state)
    buf = sim.run_to_end().finish()
    assert sim.done and torch.isfinite(buf.preds).all()
    with pytest.raises(RuntimeError, match="finished"):
        sim.step()


def test_partial_override_keeps_the_gt_channels(setup):
    """A state-only override: the forced agents take this step's GT
    velocity, acceleration and yaw rate."""
    sim = make_sim(setup)
    B, A = sim.carry.agent.valid.shape
    mask, state = forced(B, A)
    sim.step(mask_override=mask, state_override={"state": state["state"]})
    step = setup["cfg"].time_step_sim_start
    gt_vel = setup["args"][2]["agent/vel"][:, step]
    assert torch.equal(sim.carry.agent.state[:, 1:3], state["state"][:, 1:3])
    assert torch.equal(sim.carry.agent.vel[:, 1:3], gt_vel[:, 1:3])


def test_mask_override_alone_replaces_the_teacher_forcing(setup, run_to_end):
    """A mask without states forces the masked agents to this step's GT and
    releases the others."""
    sim = make_sim(setup)
    B, A = sim.carry.agent.valid.shape
    out = sim.step(mask_override=torch.zeros((B, A), dtype=torch.bool))
    assert not out.override_mask.any()
    assert not torch.equal(sim.carry.agent.state, run_to_end[1])


def test_interactive_replay_refuses_missing_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TO.interactive_replay(*setup["args"])


@pytest.fixture(scope="module")
def jax_interactive(setup):
    """JAX's interactive_replay run to the end, and with agents 1 and 2
    forced at step 5."""
    cfg, jm, params, batch = setup["cfg"], setup["jmodel"], setup["params"], setup["batch"]
    pb = j_pre({k: jnp.asarray(v) for k, v in batch.items()}, cfg.model, training=False)
    feats = JO.encode_episode_features(jm, params, pb, training=False, key=None)
    goal, goal_valid = JO.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
    latent = jm.apply({"params": params}, method="latent", posterior=True, **feats["latent_post"])
    mask_tf = j_tf_mask(JO.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])

    def sim():
        return JO.interactive_replay(cfg, jm, params, pb, feats["input"], latent, goal, goal_valid, mask_tf,
                                     jax.random.PRNGKey(7))

    full = sim().run_to_end().finish()
    forced_sim = sim()
    for _ in range(4):
        forced_sim.step()
    B, A = forced_sim.carry.agent.valid.shape
    mask, state = forced(B, A)
    forced_sim.step(mask_override=jnp.asarray(mask.numpy()),
                    state_override={k: jnp.asarray(v.numpy()) for k, v in state.items()})
    return full, np.asarray(forced_sim.carry.agent.state), forced_sim.run_to_end().finish()


def test_interactive_matches_jax(setup, jax_interactive, run_to_end, record_property):
    jbuf, jstate5, jforced = jax_interactive
    tbuf = run_to_end[0]
    for name in ("valid", "override_masks", "diffbar_rewards_valid"):
        np.testing.assert_array_equal(getattr(tbuf, name).numpy(), np.asarray(getattr(jbuf, name)), err_msg=name)
    for k, v in jbuf.violations.items():
        np.testing.assert_array_equal(tbuf.violations[k].numpy(), np.asarray(v), err_msg=k)
    tp, jp = tbuf.preds.numpy(), np.asarray(jbuf.preds)
    np.testing.assert_allclose(tp[:, :, :20], jp[:, :, :20], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp[:, :, :HELD_STEPS], jp[:, :, :HELD_STEPS], atol=ROLLOUT_ATOL, rtol=0)
    record_property("preds_max_abs_diff_all_steps_m", float(np.abs(tp - jp).max()))
    # the same intervention on both sides: the forced agents exactly there
    sim = make_sim(setup)
    for _ in range(4):
        sim.step()
    mask, state = forced(*sim.carry.agent.valid.shape)
    sim.step(mask_override=mask, state_override=state)
    np.testing.assert_array_equal(sim.carry.agent.state[:, 1:3].numpy(), jstate5[:, 1:3])
    tf_ = sim.run_to_end().finish()
    np.testing.assert_array_equal(tf_.valid.numpy(), np.asarray(jforced.valid))
    np.testing.assert_allclose(tf_.preds.numpy()[:, :, :20], np.asarray(jforced.preds)[:, :, :20], atol=1e-4, rtol=0)
