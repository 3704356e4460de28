"""Validation of the port against the JAX package, at the tests/tiny.py widths
on the CPU, with `node_encoder_impl="hybrid"` (the JAX package runs its XLA
node stack on the CPU; the port its hybrid layout with K6's plain version).

One JAX compile serves the file: `validation_device_step` under one
`jax.jit`, reused by the JAX `Validator` (its `_jitted` is set to the same
function, so its step hits the compiled program).

Random draws: the joint futures draw goals (a categorical) and latents (a
Gaussian) for K > 0. The test reproduces the JAX package's draws from its
key (the splits in `evaluation_loop.validation_device_step`,
`orchestration.joint_future_pred` and `sim.rollout.build_sim`) and hands
them to the port through `distributions.standard_gumbel` and
`distributions.standard_normal`; the port's own generator is never asked to
match threefry.

Tolerances, as the eval slice's (tests/test_torch_slice.py, ROADMAP Queue
3): booleans (validity, overrides, every violation) and the sampled goals
exactly; goal and latent log-probs and the post-processed scores within
1e-5; preds within 1e-4 m over the first 20 steps and 1e-3 m over the first
50, for the reactive replay and every joint future. Past that the closed
loop amplifies ulp-level differences; the whole horizon's gap is a reading
(junit property). The metric sums: counts exactly, error and reward sums
(which run over all 80 future steps) within rtol 1e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import evaluation_loop as JE  # noqa: E402
from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.config import config_to_dict  # noqa: E402
import trafficbots_tpu_torch.distributions as TD  # noqa: E402
from trafficbots_tpu_torch import evaluation_loop as TE  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import to_torch  # noqa: E402
from trafficbots_tpu_torch.eval.submission import SubWOMD  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

from tiny import tiny_batch, tiny_config  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
HELD_STEPS = 50
ROLLOUT_ATOL = 1e-3  # metres
SUM_RTOL = 1e-3
KEY = 5


def hybrid(cfg):
    me = dataclasses.replace(cfg.model.map_encoder, node_encoder_impl="hybrid")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, map_encoder=me))


def jax_draws(cfg, n_scene, key):
    """The joint futures' goal Gumbel noise and latent normals, as the JAX
    package draws them from `key` in validation_device_step."""
    k = cfg.n_joint_future
    _, k2 = jax.random.split(key)
    _, k_goal, k_roll = jax.random.split(k2, 3)
    _, k_latent = jax.random.split(k_roll)
    A, P = cfg.data.n_agent, cfg.data.n_pl
    gumbel = jax.random.gumbel(k_goal, (n_scene * k, A, P), jnp.float32)
    normal = jax.random.normal(k_latent, (n_scene * k, A, cfg.model.latent_encoder.latent_dim), jnp.float32)
    return np.asarray(gumbel), np.asarray(normal)


def inject(mp, gumbel, normal):
    def draw(arr):
        def fn(shape, dtype, device, generator=None):
            assert tuple(shape) == arr.shape, (tuple(shape), arr.shape)
            return torch.tensor(arr, device=device, dtype=dtype)
        return fn

    mp.setattr(TD, "standard_gumbel", draw(gumbel))
    mp.setattr(TD, "standard_normal", draw(normal))


@pytest.fixture(scope="module")
def val():
    jcfg = hybrid(tiny_config(n_step=91, time_step_end=90))
    cfg = config_from_dict(config_to_dict(jcfg))
    batch = tiny_batch(jcfg, n_scene=2, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, list)}
    jmodel, params = JO.init_params(jcfg, jax.random.PRNGKey(0), jb)
    jfn = jax.jit(lambda p, b, k: JE.validation_device_step(jcfg, jmodel, p, b, k))
    jout = jax.tree_util.tree_map(np.asarray, jfn(params, jb, jax.random.PRNGKey(KEY)))
    tmodel = TO.make_model(cfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    gumbel, normal = jax_draws(jcfg, 2, jax.random.PRNGKey(KEY))
    mp = pytest.MonkeyPatch()
    inject(mp, gumbel, normal)
    try:
        tout = TE.validation_device_step(cfg, tmodel, to_torch(batch, "cpu"), torch.Generator().manual_seed(0))
    finally:
        mp.undo()
    return dict(jcfg=jcfg, cfg=cfg, batch=batch, jmodel=jmodel, params=params, jfn=jfn, jout=jout,
                tout=tout, tmodel=tmodel, draws=(gumbel, normal))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hold_preds(t, j, record_property, name):
    """preds [..., S, 4] with the step axis second to last: 1e-4 m over the
    first 20 steps, ROLLOUT_ATOL over the first HELD_STEPS, the rest a reading."""
    t, j = _np(t), _np(j)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t[..., :20, :], j[..., :20, :], atol=1e-4, rtol=0)
    np.testing.assert_allclose(t[..., :HELD_STEPS, :], j[..., :HELD_STEPS, :], atol=ROLLOUT_ATOL, rtol=0)
    record_property(f"{name}_max_abs_diff_all_steps_m", float(np.abs(t - j).max()))


def test_reactive_replay_matches_jax(val, record_property):
    t, j = val["tout"], val["jout"]
    assert t["buf_rr_preds"].shape == j["buf_rr_preds"].shape == (2, 4, 90, 4)
    np.testing.assert_array_equal(_np(t["buf_rr_valid"]), j["buf_rr_valid"])
    hold_preds(t["buf_rr_preds"], j["buf_rr_preds"], record_property, "rr_preds")


def test_joint_future_pred_booleans_and_goals_match_jax(val):
    t, j = val["tout"], val["jout"]
    K = val["cfg"].n_joint_future
    assert t["buf_jf_preds"].shape == j["buf_jf_preds"].shape == (2, 4, K, 90, 4)
    np.testing.assert_array_equal(_np(t["buf_jf_valid"]), j["buf_jf_valid"])
    # the sampled goals: K = 0 the argmax, K > 0 JAX's categorical draws
    np.testing.assert_array_equal(_np(t["goal_sample"]), j["goal_sample"])
    assert (j["goal_sample"][:, :, 1:] != j["goal_sample"][:, :, :1]).any()  # the draws do differ from K = 0
    np.testing.assert_allclose(_np(t["goal_logp"]), j["goal_logp"], **TOL)


@pytest.mark.parametrize("future", ["deterministic K=0", "sampled K>0"])
def test_joint_future_pred_preds_match_jax(val, future, record_property):
    t, j = _np(val["tout"]["buf_jf_preds"]), val["jout"]["buf_jf_preds"]
    sl = slice(0, 1) if future.startswith("det") else slice(1, None)
    hold_preds(t[:, :, sl], j[:, :, sl], record_property, "jf_preds_" + future.split()[0])


def test_metric_sums_match_jax(val):
    t, j = val["tout"], val["jout"]
    for group in TE.SUM_KEYS:
        assert t[group].keys() == j[group].keys(), group
        for k, v in j[group].items():
            tv = _np(t[group][k])
            if "counter" in k or "count" in k or group.startswith("rule"):
                np.testing.assert_array_equal(tv, v, err_msg=f"{group}/{k}")
            else:
                np.testing.assert_allclose(tv, v, rtol=SUM_RTOL, atol=1e-5, err_msg=f"{group}/{k}")


@pytest.mark.parametrize("which", ["pred_rr", "pred_jf"])
def test_post_processed_predictions_match_jax(val, which):
    t, j = val["tout"][which], val["jout"][which]
    assert {k for k, v in t.items() if v is not None} == {k for k, v in j.items() if v is not None}
    np.testing.assert_allclose(_np(t["waymo_scores"]), j["waymo_scores"], **TOL)
    np.testing.assert_array_equal(_np(t["waymo_valid"]), j["waymo_valid"])
    fs = 11 - 1  # the future starts at step time_step_current + 1; the rollout at 1
    held = HELD_STEPS - fs
    for k in ("waymo_trajs", "waymo_yaw_bbox", "waymo_spd"):
        assert t[k].shape == j[k].shape, k
        np.testing.assert_allclose(_np(t[k])[:, :held], j[k][:, :held], atol=ROLLOUT_ATOL, rtol=0, err_msg=k)


def test_validator_end_to_end_gives_jax_metric_keys(val):
    """Both Validators over one batch at n_step = 91 (the WOMD metrics on):
    the same metric keys, finite values, val/loss = -mAP."""
    jv = JE.Validator(val["jcfg"], val["jmodel"], use_native_metrics=False)
    jv._jitted = val["jfn"]  # the compiled validation step of the fixture
    jv.step(val["params"], val["batch"], jax.random.PRNGKey(KEY))
    jm = jv.epoch_end()
    mp = pytest.MonkeyPatch()
    inject(mp, *val["draws"])
    try:
        tv = TE.Validator(val["cfg"], val["tmodel"], device="cpu")
        tv.step(val["batch"], torch.Generator().manual_seed(0))
        tm = tv.epoch_end()
    finally:
        mp.undo()
    assert tm.keys() == jm.keys()
    assert all(np.isfinite(v) for v in tm.values())
    assert tm["val/loss"] == -tm["joint_future_pred/mean_average_precision"]
    for k in ("reactive_replay/vae_kl", "reactive_replay/goal_loss"):
        np.testing.assert_allclose(tm[k], jm[k], **TOL)
    for k in ("reactive_replay/err/pos_meter", "joint_future_pred/err/pos_meter"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=SUM_RTOL)


def still_batch(batch):
    """The batch with every agent standing still and valid at every step:
    each step's state that of its first valid step, speed, velocity,
    acceleration and yaw rate 0 (the history follows), the goal the
    standing pose."""
    b = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in batch.items()}
    valid = b["agent/valid"]  # [B, T, A]
    first = valid.argmax(axis=1)  # [B, A]
    valid[:] = valid.any(axis=1, keepdims=True)
    for k in ("pos", "yaw_bbox"):
        a = b[f"agent/{k}"]
        a[:] = np.take_along_axis(a, first[:, None, :, None], axis=1)
    for k in ("vel", "spd", "acc", "yaw_rate"):
        b[f"agent/{k}"][:] = 0
    H = b["history/agent/pos"].shape[1]
    for k in ("valid", "pos", "vel", "spd", "acc", "yaw_bbox", "yaw_rate"):
        b[f"history/agent/{k}"] = b[f"agent/{k}"][:, :H]
    b["agent/goal"] = np.concatenate(
        [b["agent/pos"][:, 0], b["agent/yaw_bbox"][:, 0], np.zeros_like(b["agent/spd"][:, 0])], axis=-1)
    return b


def test_validator_metric_values_match_jax_at_a_nonzero_map(val):
    """Both Validators on agents that stand still, under weights whose
    action head outputs 0 (its output Dense zeroed in the JAX tree and
    loaded into the port): every prediction sits on the GT, so the WOMD
    metrics are not all 0 (joint_future_pred mAP 0.6667 on both sides; 32
    of the 142 `waymo_metrics/*` and `joint_future_pred/*` values non-zero).
    Every one of those values is compared, within rtol 1e-5 (the two
    packages' predictions are exact here, so the metrics agree to the bit
    on the CPU; the tolerance leaves room for the float sums' order)."""
    params = jax.tree_util.tree_map(lambda v: v, val["params"])
    head = dict(params["action_head"])
    head["mlp_mean_w1"] = jnp.zeros_like(head["mlp_mean_w1"])
    head["mlp_mean_b1"] = jnp.zeros_like(head["mlp_mean_b1"])
    params = dict(params, action_head=head)
    batch = still_batch(val["batch"])
    jv = JE.Validator(val["jcfg"], val["jmodel"], use_native_metrics=False)
    jv._jitted = val["jfn"]  # the compiled validation step of the fixture (same shapes)
    jv.step(params, batch, jax.random.PRNGKey(KEY))
    jm = jv.epoch_end()
    tmodel = TO.make_model(val["cfg"], device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    mp = pytest.MonkeyPatch()
    inject(mp, *val["draws"])
    try:
        tv = TE.Validator(val["cfg"], tmodel, device="cpu")
        tv.step(batch, torch.Generator().manual_seed(0))
        tm = tv.epoch_end()
    finally:
        mp.undo()
    assert tm.keys() == jm.keys()
    for side in (tm, jm):
        assert side["joint_future_pred/mean_average_precision"] > 0.5
    keys = [k for k in tm if k.startswith(("waymo_metrics/", "joint_future_pred/"))]
    assert len(keys) > 100 and sum(jm[k] != 0 for k in keys) > 20
    for k in keys:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_submissions_from_the_validator_and_the_test_step(val, tmp_path):
    """The port's Validator packs submissions, and its test step (no GT, the
    history standing in) runs the joint futures and packs them too."""
    cfg, batch = val["cfg"], val["batch"]
    sub_rr, sub_jf = SubWOMD(k_futures=1, activate=True), SubWOMD(k_futures=cfg.n_joint_future, activate=True)
    v = TE.Validator(cfg, val["tmodel"], sub_rr=sub_rr, sub_jf=sub_jf, device="cpu")
    v.step(batch, torch.Generator().manual_seed(1))
    n_scene = batch["agent/valid"].shape[0]
    assert [len(p) for p in sub_jf.scenario_payloads.values()] == [n_scene] * cfg.n_joint_future
    assert len(sub_jf.save_sub_files(str(tmp_path))) == cfg.n_joint_future

    pred = TE.test_step_device(cfg, val["tmodel"], to_torch(batch, "cpu"), torch.Generator().manual_seed(2))
    assert pred["waymo_trajs"].shape == (n_scene, 80, cfg.data.n_agent, cfg.n_joint_future, 2)
    assert torch.isfinite(pred["waymo_trajs"]).all() and torch.isfinite(pred["waymo_scores"]).all()
    torch.testing.assert_close(pred["waymo_scores"].sum(-1), torch.ones(n_scene, cfg.data.n_agent))
    sub = SubWOMD(k_futures=2, activate=True)
    TE.pack_test_submission(sub, pred, dict(batch, pad_mask=[False, True]))
    assert [len(p) for p in sub.scenario_payloads.values()] == [1, 1]


def test_validator_refuses_a_mesh_and_missing_cuda(val):
    with pytest.raises(NotImplementedError, match="data-parallel"):
        TE.Validator(val["cfg"], val["tmodel"], mesh=object(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.Validator(val["cfg"], val["tmodel"])
