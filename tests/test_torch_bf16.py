"""The bf16 configuration (`precision="bf16"`) of the port against the JAX
package's bf16 path, on the CPU at the tests/tiny.py widths.

Under `precision="bf16"` the JAX package computes its encoders' products on
bf16 operands (flax `nn.Dense(dtype=bf16)`, bf16 einsums) and keeps the
parameters, the GRUs, the heads and the physics in fp32. At these widths
every attention site is below the kernels' shapes, so both sides run the
JAX package's XLA attention on bf16 operands (the kernels' bf16 functions
are held at module level in tests/test_torch_kernels.py and
tests/test_torch_block_attn.py).

The hold: the port's bf16 result against JAX's bf16 result by a relative
norm error of at most RATIO = 0.1 times JAX's own fp32-vs-bf16 relative
norm gap on the same inputs and weights. One bf16 ulp at a magnitude in
[4, 8) is 0.031, as large as that whole gap in the features, so a single
rounding flip would decide a max-abs hold: the max-abs gaps are recorded as
junit properties beside the ratios instead. Measured (this file's
properties): the map, agent and tl features at ratios of 1.6e-6 to
3.4e-5 (the port rounds where XLA does: every product's operands and
result, the elementwise work between them in fp32), the latent means at
2.3e-5 and 2.9e-5, the policy step at 1.6e-5 to 3.7e-5, the 20-step
replay's preds at 2.6e-3 (max abs 1.8e-4 m), the training loss at 3.2e-3,
and 178 of the 195 non-zero gradient leaves within 0.1 of their gap (the
rest: see the gradient test).

The booleans of the 20-step eval reactive replay (validity, overrides,
every violation) are held equal. The training step runs with every dropout
rate 0 and the latent noise injected on both sides, as
tests/test_torch_training.py does. Leaves whose exact gradient is 0 (the
key-projection biases, the destination head's output bias) carry rounding
noise on both sides: they are held against the largest leaf's gap. Each
JAX program is jitted once, for each precision.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.data.preprocessing import pre_processing as j_pre  # noqa: E402
from trafficbots_tpu.sim.teacher_forcing import teacher_forcing_mask as j_tf_mask  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu.config import config_to_dict  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import pre_processing as t_pre, to_torch  # noqa: E402
from trafficbots_tpu_torch.models.modules import xla_cpu_sum  # noqa: E402
from trafficbots_tpu_torch.weights import flax_paths, load_jax_params  # noqa: E402

from test_torch_training import flat_flax, inject_latent_noise, no_dropout, zero_gradient_leaf  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402

RATIO = 0.1


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def held(record_property, name, port, j16, j32):
    """Hold port's bf16 result to JAX's by RATIO x JAX's fp32-vs-bf16 gap;
    record the gaps, the ratio and the max-abs gap."""
    port, j16, j32 = (np.asarray(x, np.float64) for x in (port, j16, j32))
    err, gap = rel(port, j16), rel(j16, j32)
    record_property(f"{name}_ratio", err / gap if gap else float("inf"))
    record_property(f"{name}_max_abs", float(np.abs(port - j16).max()))
    record_property(f"{name}_jax_bf16_vs_fp32", gap)
    assert gap > 0, name
    assert err <= RATIO * gap, (name, err, gap)


@pytest.mark.parametrize("shape", [(320,), (2, 16, 10), (40, 20), (2, 1216), (1100, 40)])
def test_xla_cpu_sum_is_jax_s_bf16_bias_gradient(shape):
    """The bias gradient of a bf16 Dense (the sum of its bf16 cotangent over
    the leading dims) as `jax.grad` gives it on the CPU, bit for bit:
    windows of 32 with the padding split low and high, and a recursion
    past 32 windows."""
    c = np.random.RandomState(len(shape)).normal(size=shape + (8,)).astype(np.float32)

    def f(b, c):
        y = b.astype(jnp.bfloat16) + jnp.zeros(shape + (8,), jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * c)

    j = np.asarray(jax.jit(jax.grad(f))(np.zeros(8, np.float32), c))
    t = xla_cpu_sum(torch.from_numpy(c).bfloat16().float(), len(shape)).numpy()
    np.testing.assert_array_equal(t, j)


def port_cfg(jcfg):
    return config_from_dict(config_to_dict(jcfg))


@pytest.fixture(scope="module")
def setup():
    cfg32 = no_dropout(tiny_config(n_step=31, time_step_end=20))
    cfg16 = dataclasses.replace(cfg32, precision="bf16")
    batch = tiny_batch(cfg32, n_scene=2, seed=0)
    jm32, params = JO.init_params(cfg32, jax.random.PRNGKey(0), batch)
    jm16 = JO.make_model(cfg16)
    tmodel = TO.make_model(port_cfg(cfg16), device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    return dict(cfg32=cfg32, cfg16=cfg16, batch=batch, jm={"fp32": jm32, "bf16": jm16}, params=params,
                tmodel=tmodel)


@pytest.fixture(scope="module")
def evals(setup):
    """Per precision, JAX's features, latent distributions and the 20-step
    eval reactive replay under one jax.jit; the port's in bf16."""
    batch, params = setup["batch"], setup["params"]
    out = {}
    for prec, cfg in (("fp32", setup["cfg32"]), ("bf16", setup["cfg16"])):
        jm = setup["jm"][prec]

        def ev(params, b, cfg=cfg, jm=jm):
            pb = j_pre(b, cfg.model, training=False)
            feats = JO.encode_episode_features(jm, params, pb, training=False, key=None)
            goal, goal_valid = JO.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
            post = jm.apply({"params": params}, method="latent", posterior=True, **feats["latent_post"])
            prior = jm.apply({"params": params}, method="latent", posterior=False, **feats["latent_prior"])
            mask_tf = j_tf_mask(JO.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])
            buf = JO.reactive_replay(cfg, jm, params, pb, feats["input"], post, goal, goal_valid, mask_tf,
                                     jax.random.PRNGKey(1), deterministic_latent=True, deterministic_action=True)
            lat = {"post_mean": post.mean, "post_std": post.stddev, "prior_mean": prior.mean,
                   "prior_std": prior.stddev}
            return feats, lat, buf

        out[prec] = jax.jit(ev)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg, tm = port_cfg(setup["cfg16"]), setup["tmodel"]
    with torch.no_grad():
        pb = t_pre(to_torch(batch, "cpu"), cfg.model, training=False)
        feats = TO.encode_episode_features(tm, pb)
        post = tm.latent(posterior=True, **feats["latent_post"])
        prior = tm.latent(posterior=False, **feats["latent_prior"])
        lat = {"post_mean": post.mean, "post_std": post.stddev, "prior_mean": prior.mean, "prior_std": prior.stddev}
        buf = TO.eval_rollout(cfg, tm, batch, device="cpu")
    out["port"] = (feats, lat, buf)
    return out


@pytest.mark.parametrize("view,key", [("input", "map_feature")] + [
    (v, k) for v in ("input", "latent_post", "latent_prior") for k in ("agent_feature", "tl_feature")])
def test_encoders_held_to_jax_bf16(evals, record_property, view, key):
    """The views share one map encode."""
    held(record_property, f"{view}_{key}", evals["port"][0][view][key].numpy(), evals["bf16"][0][view][key],
         evals["fp32"][0][view][key])


@pytest.mark.parametrize("which", ["post", "prior"])
def test_latent_distribution_held_to_jax_bf16(evals, record_property, which):
    """The means held; the standard deviations (a learned constant, no
    product) equal at both precisions."""
    port, j16, j32 = (evals[k][1] for k in ("port", "bf16", "fp32"))
    held(record_property, f"{which}_mean", port[f"{which}_mean"].numpy(), j16[f"{which}_mean"], j32[f"{which}_mean"])
    np.testing.assert_array_equal(np.asarray(j16[f"{which}_std"]), np.asarray(j32[f"{which}_std"]))
    np.testing.assert_allclose(port[f"{which}_std"].numpy(), np.asarray(j16[f"{which}_std"]), rtol=1e-6)


def test_policy_step_held_to_jax_bf16(setup, evals, record_property):
    """One policy step on the same inputs (JAX's bf16 features, the map K/V
    cache of each side's own projections, the hoisted goal/latent MLPs)."""
    params, tm = setup["params"], setup["tmodel"]
    feats = jax.tree_util.tree_map(np.asarray, evals["bf16"][0]["input"])
    rs = np.random.RandomState(0)
    B, A, d = feats["agent_feature"][:, 0].shape
    goal_f = rs.normal(size=(B, A, d)).astype(np.float32)
    lat = rs.normal(size=(B, A, setup["cfg32"].model.latent_encoder.latent_dim)).astype(np.float32)
    gv = rs.rand(B, A) < 0.7
    atype = t_pre(to_torch(setup["batch"], "cpu"), setup["cfg32"].model, training=False)["sc/agent_type"].numpy()
    inputs = dict(agent_valid=feats["agent_feature_valid"][:, 0], agent_feature=feats["agent_feature"][:, 0],
                  map_valid=feats["map_feature_valid"], tl_valid=feats["tl_feature_valid"][:, 0],
                  tl_feature=feats["tl_feature"][:, 0], goal_valid=gv, goal_feature=goal_f, latent_sample=lat,
                  agent_type=atype)

    def jstep(jm):
        def f(params, x):
            ap = lambda method, **kw: jm.apply({"params": params}, method=method, **kw)  # noqa: E731
            kv = ap("precompute_map_kv", map_feature=jnp.asarray(feats["map_feature"]))
            g, l = ap("precompute_add_feats", goal_feature=x["goal_feature"], goal_valid=x["goal_valid"],
                      latent_sample=x["latent_sample"], latent_valid=jnp.ones((B, A), bool))
            h = ap("init_hidden", n_batch=B, n_agent=A)
            mean, log_std, h, pf, _ = ap("policy_step", map_feature=None, map_kv=kv, hidden=h, goal_z_pre=g,
                                         latent_z_pre=l, **x)
            return mean, h, pf
        return jax.jit(f)(params, {k: jnp.asarray(v) for k, v in inputs.items()})

    j16, j32 = jstep(setup["jm"]["bf16"]), jstep(setup["jm"]["fp32"])
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    with torch.no_grad():
        kv = tm.precompute_map_kv(torch.from_numpy(feats["map_feature"]))
        g, l = tm.precompute_add_feats(t["goal_feature"], t["goal_valid"], t["latent_sample"],
                                       torch.ones((B, A), dtype=torch.bool))
        mean, _, h, pf = tm.policy_step(map_feature=None, map_kv=kv, hidden=tm.init_hidden(B, A), goal_z_pre=g,
                                        latent_z_pre=l, **t)
    for name, port, a, b in zip(("action_mean", "hidden", "policy_feature"), (mean, h, pf), j16, j32):
        held(record_property, name, port.numpy(), a, b)


def test_reactive_replay_held_to_jax_bf16(evals, record_property):
    """The 20-step eval reactive replay: booleans equal, preds held."""
    jbuf, tbuf = evals["bf16"][2], evals["port"][2]
    np.testing.assert_array_equal(tbuf.valid.numpy(), np.asarray(jbuf.valid))
    np.testing.assert_array_equal(tbuf.override_masks.numpy(), np.asarray(jbuf.override_masks))
    assert tbuf.violations.keys() == jbuf.violations.keys()
    for k, v in jbuf.violations.items():
        np.testing.assert_array_equal(tbuf.violations[k].numpy(), np.asarray(v), err_msg=k)
    assert np.isfinite(tbuf.preds.numpy()).all()
    held(record_property, "replay_preds", tbuf.preds.numpy(), jbuf.preds, evals["fp32"][2].preds)


@pytest.fixture(scope="module")
def train(setup):
    """One training step's loss and gradients: JAX's at both precisions
    (jax.value_and_grad, jitted once each; the bf16 one also on the batch
    with the map positions moved by one ulp), the port's in bf16."""
    eps = np.random.RandomState(7).normal(
        size=(2, setup["cfg32"].data.n_agent, setup["cfg32"].model.latent_encoder.latent_dim)).astype(np.float32)
    batch = setup["batch"]
    nudged = dict(batch, **{"map/pos": np.nextafter(batch["map/pos"], np.float32(np.inf))})
    mp = pytest.MonkeyPatch()
    inject_latent_noise(mp, eps)
    out = {}
    try:
        for prec, cfg in (("fp32", setup["cfg32"]), ("bf16", setup["cfg16"])):
            cfg = dataclasses.replace(cfg, p_training_rollout_prior=0.0)
            jm = setup["jm"][prec]
            fn = jax.jit(jax.value_and_grad(
                lambda p, b, cfg=cfg, jm=jm: JO.training_step(cfg, jm, p, b, jax.random.PRNGKey(3)), has_aux=True))
            for name, b in ((prec, batch), (prec + "_nudged", nudged)):
                if name == "fp32_nudged":
                    continue
                (loss, _), grads = fn(setup["params"], {k: jnp.asarray(v) for k, v in b.items()})
                out[name] = (float(loss), flat_flax(grads))
        cfg = dataclasses.replace(setup["cfg16"], p_training_rollout_prior=0.0)
        tm = TO.make_model(port_cfg(cfg), device="cpu")
        load_jax_params(tm, jax.tree_util.tree_map(np.asarray, setup["params"]))
        loss, _ = TO.training_step(port_cfg(cfg), tm, to_torch(batch, "cpu"), torch.Generator().manual_seed(3))
        loss.backward()
    finally:
        mp.undo()
    out["port"] = (loss.item(), tm)
    return out


def test_training_loss_held_to_jax_bf16(train, record_property):
    held(record_property, "loss", [train["port"][0]], [train["bf16"][0]], [train["fp32"][0]])


def test_training_gradients_held_to_jax_bf16(train, record_property):
    """Every leaf: |port - jax16| <= RATIO x JAX's fp32-vs-bf16 gap at that
    leaf, or, where JAX's own bf16 gradient moves by more under a one-ulp
    nudge of the map positions, that movement (norms); the exact-zero
    leaves against RATIO x the largest leaf's gap. The backward rounds its
    cotangents to bf16 at every product, which turns a relative difference
    far below one bf16 ulp upstream into ulp-sized differences downstream,
    most at the end of the backward: the map encoder's leaves land at up to
    0.29 of their gaps. Those 17 leaves are at most 0.18 of the nudge's
    movement, which is 0.8-2.0 of their gaps. Measured: 178 of
    the 195 non-zero leaves within 0.1 of their gap (the junit
    properties)."""
    tm = train["port"][1]
    j16, j32, jn = train["bf16"][1], train["fp32"][1], train["bf16_nudged"][1]
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in tm.named_parameters()}
    paths = flax_paths(tm)
    assert {path for path, _ in paths.values()} == set(j16)

    def norm(a):
        return float(np.linalg.norm(np.asarray(a, np.float64)))

    gaps = {path: norm(j16[path] - j32[path]) for path in j16}
    nudges = {path: norm(j16[path] - jn[path]) for path in j16}
    top = max(gaps.values())
    worst_gap, worst_nudge, n_gap, n_leaves, bad = 0.0, 0.0, 0, 0, {}
    for name, (path, transposed) in paths.items():
        t = grads[name].numpy()
        j = j16[path].T if transposed else j16[path]
        err = norm(t.astype(np.float64) - j)
        if zero_gradient_leaf(name):
            limit = RATIO * top
        else:  # a leaf bf16 does not reach has no gap: held to 1e-6 of its norm
            limit = max(RATIO * gaps[path], nudges[path], 1e-6 * norm(j), 1e-12)
            worst_gap = max(worst_gap, err / max(gaps[path], 1e-6 * norm(j), 1e-12))
            n_leaves += 1
            if err <= RATIO * gaps[path]:
                n_gap += 1
            else:
                worst_nudge = max(worst_nudge, err / max(nudges[path], 1e-12))
        if err > limit:
            bad[path] = (err, gaps[path], nudges[path])
    record_property("grad_worst_ratio_to_bf16_gap", worst_gap)
    record_property("grad_worst_ratio_to_nudge_past_the_gap_hold", worst_nudge)
    record_property("grad_leaves_within_ratio_of_bf16_gap", f"{n_gap} of {n_leaves}")
    assert not bad, bad
