"""The paper's ablation models (`config.ablation`) in the port, against the
JAX package on the CPU at the tests/tiny.py widths.

- The `trafficsim` (goal_xy GoalPredictor, a latent resampled every step,
  the unmasked GRU, state-integrator dynamics) and `latent_cat`
  (MultiCategorical latents) training steps: the loss, its metrics and
  every gradient leaf against `jax.value_and_grad` of the JAX step, with
  tests/test_torch_training.py's set-up and tolerances (dropout 0, a
  20-step horizon, 15 for trafficsim, the latent's noise injected on both
  sides: the Gaussian
  sampler patched to mean + std * eps, the categorical's Gumbel noise
  handed to `jax.random.categorical` and to `distributions.standard_gumbel`;
  loss and metrics rtol 1e-5, each leaf within a relative norm error of
  1e-4). trafficsim's closed loop (state-integrator dynamics, random
  weights) leaves the ulp level sooner: at 20 steps JAX's own forward and
  its value_and_grad compilation give losses 4.9e-5 apart (rel) and the
  port sits as far from the latter; at 15 steps both gaps are ~1e-6.
- A sweep of every name `config.ablation` accepts (tests/test_ablations.py's
  tiny cut): the port builds the model, runs the eval rollout, one training
  step and one validation step, all finite; and its parameter tree is the
  JAX model's (`weights.load_jax_params`, strict both ways, fills it from
  the shapes of JAX's init). `pe_xy_unit_dir` raises the same
  AssertionError in both packages at these widths (InputPeEncoder's
  `out_dim >= 32`).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.config import ablation as j_ablation  # noqa: E402
from trafficbots_tpu.data.preprocessing import pre_processing as j_pre  # noqa: E402
import trafficbots_tpu_torch.distributions as TD  # noqa: E402
from trafficbots_tpu_torch import evaluation_loop as TE  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import ablation as t_ablation  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import to_torch  # noqa: E402
from trafficbots_tpu_torch.training import train as TT  # noqa: E402
from trafficbots_tpu_torch.weights import flax_paths, load_jax_params  # noqa: E402

from test_ablations import _tinyfy  # noqa: E402
from test_torch_training import (  # noqa: E402
    GRAD_RTOL, TOL, flat_flax, inject_latent_noise, no_dropout, port_cfg, zero_gradient_leaf,
)
from tiny import tiny_batch  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

ABLATIONS = ("traffic_bots", "simnet", "trafficsim", "bc", "bc_simnet", "no_free_nats", "large_kl",
             "action_gradients", "goal_no_navigator", "no_latent", "no_goal", "scene_transformer_pe", "pe_add",
             "pe_xy_dir", "pe_xy_unit_dir", "xy_dir", "mpa_pl", "no_interaction", "goal_xy", "latent_cat",
             "latent_std_gaus")


def test_the_sweep_names_every_ablation():
    for name in ABLATIONS:
        t_ablation(name)
    with pytest.raises(ValueError, match="unknown ablation"):
        t_ablation("no_such_recipe")


def training_config(name):
    steps = 15 if name == "trafficsim" else 20  # see the module docstring
    cfg = no_dropout(_tinyfy(j_ablation(name)), time_step_end=steps, p_training_rollout_prior=0.0)
    if name == "latent_cat":  # 2 categoricals of 4 classes (the tiny latent_dim 8 with n_cat 8 is 8 of 1)
        le = cfg.model.latent_encoder
        cat = dataclasses.replace(le.latent_post, n_cat=2)
        le = dataclasses.replace(le, latent_post=cat, latent_prior=dataclasses.replace(le.latent_prior, n_cat=2))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, latent_encoder=le))
    return cfg


def inject_categorical_noise(mp, gumbel):
    """`jax.random.categorical` and the port's `standard_gumbel` both take
    `gumbel` for draws of its shape."""
    orig = jax.random.categorical

    def categorical(key, logits, axis=-1, **kw):
        if tuple(logits.shape) != gumbel.shape:
            return orig(key, logits, axis=axis, **kw)
        return jnp.argmax(jnp.asarray(gumbel) + logits, axis=axis)

    def standard_gumbel(shape, dtype, device, generator=None):
        assert tuple(shape) == gumbel.shape, tuple(shape)
        return torch.tensor(gumbel, dtype=dtype, device=device)

    mp.setattr(jax.random, "categorical", categorical)
    mp.setattr(TD, "standard_gumbel", standard_gumbel)


@pytest.fixture(scope="module", params=["trafficsim", "latent_cat"])
def ablation_step(request):
    name = request.param
    cfg = training_config(name)
    batch = tiny_batch(cfg, n_scene=2, seed=0)
    jmodel, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)
    A, le = cfg.data.n_agent, cfg.model.latent_encoder
    rs = np.random.RandomState(7)
    mp = pytest.MonkeyPatch()
    if name == "latent_cat":
        u = rs.uniform(size=(2, A, 2, le.latent_dim // 2)).astype(np.float32)
        inject_categorical_noise(mp, -np.log(-np.log(u)))
    else:
        inject_latent_noise(mp, rs.normal(size=(2, A, le.latent_dim)).astype(np.float32))
    try:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        fn = jax.jit(jax.value_and_grad(
            lambda p: JO.training_step(cfg, jmodel, p, jb, jax.random.PRNGKey(3)), has_aux=True))
        (jloss, jmetrics), jgrads = fn(params)
        tmodel = TO.make_model(port_cfg(cfg), device="cpu")
        load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
        loss, metrics = TO.training_step(port_cfg(cfg), tmodel, to_torch(batch, "cpu"),
                                         torch.Generator().manual_seed(3))
        loss.backward()
    finally:
        mp.undo()
    return dict(name=name, jloss=jloss, jmetrics=jmetrics, jgrads=flat_flax(jgrads), loss=loss, metrics=metrics,
                tmodel=tmodel)


def test_ablation_training_loss_and_metrics_match_jax(ablation_step):
    s = ablation_step
    np.testing.assert_allclose(s["loss"].item(), float(s["jloss"]), **TOL)
    assert s["metrics"].keys() == s["jmetrics"].keys()
    assert {"vae_kl_sum", "goal_loss_sum"} <= set(s["metrics"])
    for k, v in s["jmetrics"].items():
        np.testing.assert_allclose(s["metrics"][k].detach().numpy(), np.asarray(v), err_msg=k, **TOL)


def test_ablation_training_gradients_match_jax_leaf_by_leaf(ablation_step):
    s = ablation_step
    paths = flax_paths(s["tmodel"])
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in s["tmodel"].named_parameters()}
    assert {path for path, _ in paths.values()} == set(s["jgrads"])
    scale = max(np.linalg.norm(g) for g in s["jgrads"].values())
    bad = {}
    for name, (path, transposed) in paths.items():
        t = grads[name].numpy()
        j = s["jgrads"][path].T if transposed else s["jgrads"][path]
        err, ref = np.linalg.norm(t - j), np.linalg.norm(j)
        if err > GRAD_RTOL * max(ref, 1e-3 * scale) and not (zero_gradient_leaf(name) and err < GRAD_RTOL * scale):
            bad[path] = (err, ref)
    assert not bad, bad
    # the new heads get gradients
    new = {"trafficsim": ("goal_manager.predictor.as2pl.layer0.attn.q_proj.weight",
                          "goal_manager.predictor.mlp_mean.fc1.weight", "goal_manager.predictor.log_std"),
           "latent_cat": ("latent_encoder.post_dist.mlp_logits.fc0.weight",
                          "latent_encoder.prior_dist.mlp_logits.fc1.weight")}[s["name"]]
    for name in new:
        assert grads[name].abs().sum() > 0, name


def jax_param_shapes(cfg, batch):
    """The JAX model's parameter tree as zeros of its shapes (no compile:
    `jax.eval_shape` of `orchestration.init_params`'s init)."""
    model = JO.make_model(cfg)

    def init(key, b):
        k_pre, k_init, k_do = jax.random.split(key, 3)
        pb = j_pre(b, cfg.model, n_step_hist=cfg.time_step_current + 1, training=True, key=k_pre)
        return model.init({"params": k_init, "dropout": k_do}, pb, method="init_all")["params"]

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)


@pytest.mark.parametrize("name", ABLATIONS)
def test_every_ablation_runs_in_the_port_and_has_jax_s_parameters(name):
    jcfg = _tinyfy(j_ablation(name))
    cfg = port_cfg(jcfg)
    batch = tiny_batch(jcfg, n_scene=2, seed=0)
    if name == "pe_xy_unit_dir":
        with pytest.raises(AssertionError):
            jax_param_shapes(jcfg, batch)
        with pytest.raises(AssertionError):
            TO.make_model(cfg, device="cpu", seed=0)
        return
    load_jax_params(TO.make_model(cfg, device="cpu"), jax_param_shapes(jcfg, batch))
    model = TO.make_model(cfg, device="cpu", seed=0)
    out = TO.eval_rollout(cfg, model, batch, device="cpu")
    assert out.preds.shape == (2, cfg.data.n_agent, cfg.time_step_end, 4)
    assert torch.isfinite(out.preds).all()
    step = TT.make_train_step(cfg, model, TT.make_optimizer(cfg, model))
    m = step(batch, seed=1)
    assert np.isfinite(m["loss"].item()) and m["grad_norm"].item() > 0
    val = TE.Validator(cfg, model, device="cpu")
    val.step(batch, torch.Generator().manual_seed(0))
    metrics = val.epoch_end()
    assert np.isfinite(metrics["val/loss"])
