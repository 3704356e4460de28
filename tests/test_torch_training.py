"""The training slice of the port against the JAX package, on the CPU at the
tests/tiny.py widths.

Set-up: every dropout rate 0 (the two packages' dropout bits cannot match),
the latent sample's noise injected equally on both sides (both samplers
monkeypatched to mean + std * EPS for one numpy EPS), a 20-step horizon
(10 teacher-forced warm-up steps, 10 closed-loop ones: the window where the
eval test holds preds to 1e-4 m). JAX runs its CPU paths (the XLA attention
and node stack with autodiff); the port its plain versions with autograd.

Tolerances: the loss and every metric within rtol 1e-5; each parameter's
gradient within a relative norm error of 1e-4 of the leaf's norm, or of the
largest leaf's for leaves whose exact gradient is 0 (the key-projection
biases of attention: rounding noise on both sides). The backward sums the 20 steps' and 64-wide
layers' contributions in another order; 1e-4 leaves room for that and is far
below a wrong gradient. Two `make_train_step` updates against optax (clip 0.5,
so the clip fires): the losses within rtol 1e-5, the grad norms within rtol
1e-4, each leaf's update within a relative norm error of 1e-2 (Adam's first
steps divide by |g| + 1e-8, so a gradient element near 0 turns its rounding
into a larger update error: 1.3e-3 measured on the GRU input weights), but for the key-projection biases,
whose exact gradient is 0, and the destination head's output bias (a
log-softmax ignores it too), where Adam normalizes rounding noise on both
sides: those moved by at most 2 lr, the most two steps can move them. The
optimizer alone, on identical gradients: parameters within 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import trafficbots_tpu.distributions as JD  # noqa: E402
from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.config import config_to_dict  # noqa: E402
from trafficbots_tpu.data.preprocessing import pre_processing as j_pre  # noqa: E402
from trafficbots_tpu.training import loss as JL  # noqa: E402
from trafficbots_tpu.training import train as JT  # noqa: E402
import trafficbots_tpu_torch.distributions as TD  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import pre_processing as t_pre, to_torch  # noqa: E402
from trafficbots_tpu_torch.models import goal_manager as TGM  # noqa: E402
from trafficbots_tpu_torch.training import loss as TL  # noqa: E402
from trafficbots_tpu_torch.training import train as TT  # noqa: E402
from trafficbots_tpu_torch.weights import flax_paths, load_jax_params  # noqa: E402

from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-2


def no_dropout(cfg, **kw):
    m = cfg.model
    model = dataclasses.replace(
        m,
        tf_cfg=dataclasses.replace(m.tf_cfg, dropout_p=0.0),
        input_pe_encoder=dataclasses.replace(m.input_pe_encoder, mlp_dropout_p=0.0),
        agent_temporal=dataclasses.replace(m.agent_temporal, dropout=0.0),
        add_goal=dataclasses.replace(m.add_goal, dropout_p=0.0),
        add_latent=dataclasses.replace(m.add_latent, dropout_p=0.0),
    )
    return dataclasses.replace(cfg, model=model, **kw)


def zero_gradient_leaf(name: str) -> bool:
    """Leaves whose exact gradient is 0: the key-projection biases (a
    per-row constant does not move a softmax) and the destination head's
    output bias (nor a log-softmax). Both sides give rounding noise there."""
    return name.endswith(("k_proj.bias", "densetnt.bk")) or name == "goal_manager.predictor.mlp.fc2.bias"


def port_cfg(jcfg):
    return config_from_dict(config_to_dict(jcfg))


def inject_latent_noise(monkeypatch, eps: np.ndarray):
    """Both DiagGaussian samplers draw mean + std * eps when stochastic."""

    def j_sample(self, key, deterministic=True):
        return self.mean if deterministic is True else self.mean + self.stddev * jnp.asarray(eps)

    def t_sample(self, generator=None, deterministic=True):
        return self.mean if deterministic is True else self.mean + self.stddev * torch.from_numpy(eps)

    monkeypatch.setattr(JD.DiagGaussian, "sample", j_sample)
    monkeypatch.setattr(TD.DiagGaussian, "sample", t_sample)


@pytest.fixture(scope="module")
def base():
    cfg = no_dropout(tiny_config(n_step=31, time_step_end=20))
    batch = tiny_batch(cfg, n_scene=2, seed=0)
    jmodel, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)
    eps = np.random.RandomState(7).normal(size=(2, cfg.data.n_agent, cfg.model.latent_encoder.latent_dim))
    return dict(cfg=cfg, batch=batch, jmodel=jmodel, params=params, eps=eps.astype(np.float32))


def port_model(cfg, params):
    m = TO.make_model(port_cfg(cfg), device="cpu")
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, params))
    return m


def flat_flax(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat_flax(v, path) if hasattr(v, "items") else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def step_p0(base):
    """Loss, metrics and gradients of one training step, posterior branch
    (p_training_rollout_prior = 0), on both sides."""
    mp = pytest.MonkeyPatch()
    inject_latent_noise(mp, base["eps"])
    try:
        cfg = dataclasses.replace(base["cfg"], p_training_rollout_prior=0.0)
        jb = {k: jnp.asarray(v) for k, v in base["batch"].items()}
        fn = jax.jit(jax.value_and_grad(
            lambda p: JO.training_step(cfg, base["jmodel"], p, jb, jax.random.PRNGKey(3)), has_aux=True))
        (jloss, jmetrics), jgrads = fn(base["params"])
        tmodel = port_model(cfg, base["params"])
        loss, metrics = TO.training_step(port_cfg(cfg), tmodel, to_torch(base["batch"], "cpu"),
                                         torch.Generator().manual_seed(3))
        loss.backward()
    finally:
        mp.undo()
    return dict(jloss=jloss, jmetrics=jmetrics, jgrads=flat_flax(jgrads), loss=loss, metrics=metrics, tmodel=tmodel)


def test_training_step_loss_and_metrics_match_jax(step_p0):
    s = step_p0
    np.testing.assert_allclose(s["loss"].item(), float(s["jloss"]), **TOL)
    assert s["metrics"].keys() == s["jmetrics"].keys()
    for k, v in s["jmetrics"].items():
        np.testing.assert_allclose(s["metrics"][k].detach().numpy(), np.asarray(v), err_msg=k, **TOL)


def test_training_step_gradients_match_jax_leaf_by_leaf(step_p0):
    s = step_p0
    paths = flax_paths(s["tmodel"])
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in s["tmodel"].named_parameters()}
    assert {path for path, _ in paths.values()} == set(s["jgrads"])
    scale = max(np.linalg.norm(g) for g in s["jgrads"].values())
    bad = {}
    for name, (path, transposed) in paths.items():
        t = grads[name].numpy()
        j = s["jgrads"][path].T if transposed else s["jgrads"][path]
        err, ref = np.linalg.norm(t - j), np.linalg.norm(j)
        if err > GRAD_RTOL * max(ref, 1e-3 * scale):
            bad[path] = (err, ref)
    assert not bad, bad
    # the goal head and the latent encoders do get gradients
    for name in ("goal_manager.predictor.mlp.fc0.weight", "latent_encoder.post_dist.mlp_mean.fc0.weight",
                 "latent_encoder.prior_dist.mlp_mean.fc0.weight", "map_encoder.densetnt.wq"):
        assert grads[name].abs().sum() > 0, name


@pytest.fixture(scope="module")
def two_updates(base):
    """Two make_train_step updates on both sides, prior branch
    (p_training_rollout_prior = 1), clip small enough to fire."""
    mp = pytest.MonkeyPatch()
    inject_latent_noise(mp, base["eps"])
    try:
        cfg = dataclasses.replace(base["cfg"], p_training_rollout_prior=1.0,
                                  optimizer=dataclasses.replace(base["cfg"].optimizer, gradient_clip_val=0.5))
        tx = JT.make_optimizer(cfg, base["params"])
        jstep = jax.jit(JT.make_train_step(cfg, base["jmodel"], tx))
        jb = {k: jnp.asarray(v) for k, v in base["batch"].items()}
        params, opt_state = base["params"], tx.init(base["params"])
        jm = []
        for i in range(2):
            params, opt_state, m = jstep(params, opt_state, jb, jax.random.PRNGKey(i))
            jm.append(m)
        tmodel = port_model(cfg, base["params"])
        tstep = TT.make_train_step(port_cfg(cfg), tmodel, TT.make_optimizer(port_cfg(cfg), tmodel))
        tm = [tstep(base["batch"], seed=i) for i in range(2)]
    finally:
        mp.undo()
    return dict(jm=jm, tm=tm, jparams=flat_flax(params), tmodel=tmodel, cfg=cfg, params0=base["params"])


def test_two_train_step_updates_match_optax(two_updates):
    s = two_updates
    for jm, tm in zip(s["jm"], s["tm"]):
        assert float(jm["grad_norm"]) > 0.5  # the clip fires
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
        for k in jm:
            if k.startswith("grad_norm"):
                np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=GRAD_RTOL, err_msg=k)
    lr = port_cfg(tiny_config()).optimizer.lr
    p0 = {n: p.detach().numpy() for n, p in port_model(s["cfg"], s["params0"]).named_parameters()}
    for name, p in s["tmodel"].named_parameters():
        path, transposed = flax_paths(s["tmodel"])[name]
        j = s["jparams"][path].T if transposed else s["jparams"][path]
        t = p.detach().numpy()
        if zero_gradient_leaf(name):  # Adam normalizes rounding noise on both sides
            assert np.abs(t - p0[name]).max() <= 2 * lr and np.abs(j - p0[name]).max() <= 2 * lr, path
            continue
        du = np.linalg.norm((t - p0[name]) - (j - p0[name]))
        assert du <= UPDATE_RTOL * np.linalg.norm(j - p0[name]), (path, du)


def test_optimizer_matches_optax_on_the_same_gradients(base):
    """Clip (fires), Adam, the goal-predictor LR group and the StepLR decay
    (one step an epoch, the LR halves after the first) against optax on
    identical gradients: parameters within 1e-6 after three steps."""
    oc = dataclasses.replace(base["cfg"].optimizer, lr_goal=1e-3, gradient_clip_val=0.5, scheduler_step_size=1)
    cfg = dataclasses.replace(base["cfg"], optimizer=oc)
    tmodel = port_model(cfg, base["params"])
    opt = TT.make_optimizer(port_cfg(cfg), tmodel, steps_per_epoch=1)
    tx = JT.make_optimizer(cfg, base["params"], steps_per_epoch=1)
    jparams, state = base["params"], tx.init(base["params"])

    @jax.jit
    def apply(grads, state, params):  # one compiled optax step, in place of a dispatch per leaf and operation
        updates, state = tx.update(grads, state, params)
        return jax.tree_util.tree_map(lambda a, b: a + b, params, updates), state

    paths = flax_paths(tmodel)
    rs = np.random.RandomState(0)
    for _ in range(3):
        g = {path: rs.normal(size=np.shape(v)).astype(np.float32) for path, v in flat_flax(jparams).items()}
        for name, p in tmodel.named_parameters():
            path, transposed = paths[name]
            p.grad = torch.from_numpy(g[path].T.copy() if transposed else g[path])
        metrics = opt.step()
        gtree = jax.tree_util.tree_map_with_path(
            lambda kp, v: jnp.asarray(g["/".join(k.key for k in kp)]), jparams)
        jparams, state = apply(gtree, state, jparams)
        assert metrics["grad_norm"].item() > 0.5
    flat = flat_flax(jparams)
    for name, p in tmodel.named_parameters():
        path, transposed = paths[name]
        np.testing.assert_allclose(p.detach().numpy(), flat[path].T if transposed else flat[path],
                                   atol=1e-6, rtol=0, err_msg=path)


def test_remat_gives_the_same_gradients(base):
    """Port only, dropout live: the per-step checkpoint (save_attn and none)
    gives the gradients of the plain BPTT to 1e-6."""
    cfg = port_cfg(tiny_config(n_step=31, time_step_end=20))

    def grads(**kw):
        c = dataclasses.replace(cfg, **kw)
        m = TO.make_model(c, device="cpu", seed=0)
        loss, _ = TO.training_step(c, m, to_torch(base["batch"], "cpu"), torch.Generator().manual_seed(5))
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}

    l0, g0 = grads(remat_rollout_step=False)
    for policy in ("save_attn", "none"):
        l1, g1 = grads(remat_rollout_step=True, remat_policy=policy)
        assert l1 == l0
        assert g1.keys() == g0.keys()
        for n in g0:
            torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=1e-6, msg=n)


@pytest.mark.parametrize("alpha", [-1.0, 0.8])
@pytest.mark.parametrize("free_nats", [-1.0, 0.5])
def test_balanced_kl_value_and_gradients(alpha, free_nats):
    rs = np.random.RandomState(1)
    mp, mq = rs.normal(size=(2, 3, 4, 8)).astype(np.float32)
    lp, lq = (0.3 * rs.normal(size=(2, 3, 4, 8))).astype(np.float32)

    def j_fn(mp, lp, mq, lq):
        return jnp.sum(JL.balanced_kl(JD.DiagGaussian(mp, lp), JD.DiagGaussian(mq, lq), alpha, free_nats) * jnp.arange(12.0).reshape(3, 4))

    jv, jg = jax.value_and_grad(j_fn, argnums=(0, 1, 2, 3))(mp, lp, mq, lq)
    ts = [torch.from_numpy(a).requires_grad_() for a in (mp, lp, mq, lq)]
    tv = (TL.balanced_kl(TD.DiagGaussian(ts[0], ts[1]), TD.DiagGaussian(ts[2], ts[3]), alpha, free_nats)
          * torch.arange(12.0).reshape(3, 4)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    for t, j in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)


def _loss_inputs(rs, B=2, A=5, S=12):
    pv = rs.rand(B, A, S) < 0.8
    return dict(
        pred_valid=pv, diffbar_rewards_valid=rs.rand(B, A, S) < 0.9,
        diffbar_rewards=rs.normal(size=(B, A, S)).astype(np.float32),
        override_masks=rs.rand(B, A, S) < 0.3, agent_role=rs.rand(B, A, 3) < 0.3,
    )


@pytest.mark.parametrize("rule", [
    dict(),
    dict(loss_for_teacher_forcing=False),
    dict(step_training_start=0),
    dict(step_training_start=5),
    dict(kl_for_unseen_agent=False),
    dict(w_relevant_agent=2.0),
    dict(w_vae_kl=0.0, w_goal=0.0),
])
def test_training_loss_masking_rules(rule):
    rs = np.random.RandomState(3)
    cfg = dataclasses.replace(tiny_config().training_metrics, **rule)
    inp = _loss_inputs(rs)
    B, A, _ = inp["pred_valid"].shape
    mp, mq = rs.normal(size=(2, B, A, 4)).astype(np.float32)
    ls = np.full((B, A, 4), -0.5, np.float32)
    post_v, prior_v = rs.rand(B, A) < 0.8, rs.rand(B, A) < 0.6
    logits = rs.normal(size=(B, A, 7)).astype(np.float32)
    goal = rs.randint(0, 7, size=(B, A))
    gvalid = rs.rand(B, A) < 0.7
    tcfg = port_cfg(dataclasses.replace(tiny_config(), training_metrics=cfg)).training_metrics
    jl, jm = JL.training_loss(
        cfg, **{k: jnp.asarray(v) for k, v in inp.items()}, goal_valid=jnp.asarray(gvalid),
        goal_pred=JD.DestCategorical.from_logits(jnp.asarray(logits), valid=jnp.asarray(gvalid)),
        goal_gt=jnp.asarray(goal), latent_post=JD.DiagGaussian(jnp.asarray(mp), jnp.asarray(ls), jnp.asarray(post_v)),
        latent_prior=JD.DiagGaussian(jnp.asarray(mq), jnp.asarray(ls), jnp.asarray(prior_v)),
    )
    tl, tm = TL.training_loss(
        tcfg, **{k: torch.from_numpy(v) for k, v in inp.items()}, goal_valid=torch.from_numpy(gvalid),
        goal_pred=TD.DestCategorical.from_logits(torch.from_numpy(logits), valid=torch.from_numpy(gvalid)),
        goal_gt=torch.from_numpy(goal), latent_post=TD.DiagGaussian(torch.from_numpy(mp), torch.from_numpy(ls), torch.from_numpy(post_v)),
        latent_prior=TD.DiagGaussian(torch.from_numpy(mq), torch.from_numpy(ls), torch.from_numpy(prior_v)),
    )
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), err_msg=k, **TOL)


def test_dest_predictor_matches_jax(base):
    """The goal head (training views, dropout 0) against JAX's pred_goal,
    its log-probs at the GT destinations, and the destination masks."""
    cfg, jm, params, batch = base["cfg"], base["jmodel"], base["params"], base["batch"]
    jb = j_pre({k: jnp.asarray(v) for k, v in batch.items()}, cfg.model, training=True)
    jf = JO.encode_episode_features(jm, params, jb, training=False, key=None)
    jd = jm.apply({"params": params}, method="pred_goal", agent_type=jb["ref/agent_type"],
                  map_type=jb["ref/map_type"], agent_state=jb["ref/agent_state"], **jf["input"])
    tmodel = port_model(cfg, params)
    tb = t_pre(to_torch(batch, "cpu"), port_cfg(cfg).model, training=True)
    with torch.no_grad():
        tf = TO.encode_episode_features(tmodel, tb)
        td = tmodel.pred_goal(agent_type=tb["ref/agent_type"], map_type=tb["ref/map_type"],
                              agent_state=tb["ref/agent_state"], **tf["input"])
    finite = np.isfinite(np.asarray(jd.logits))
    np.testing.assert_array_equal(np.isfinite(td.logits.numpy()), finite)
    np.testing.assert_allclose(td.logits.numpy()[finite], np.asarray(jd.logits)[finite], **TOL)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_allclose(td.log_prob(tb["gt/dest"]).numpy(), np.asarray(jd.log_prob(jb["gt/dest"])), **TOL)
    from trafficbots_tpu.models.goal_manager import _dest_type_masks
    for t, j in zip(TGM.dest_type_masks(tb["ref/agent_type"], tb["ref/map_type"], tf["input"]["map_feature_valid"]),
                    _dest_type_masks(jb["ref/agent_type"], jb["ref/map_type"], jf["input"]["map_feature_valid"])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_training_views_match_jax(base):
    cfg, batch = base["cfg"], base["batch"]
    jb = j_pre({k: jnp.asarray(v) for k, v in batch.items()}, cfg.model, training=True)
    tb = t_pre(to_torch(batch, "cpu"), port_cfg(cfg).model, training=True)
    keys = [k for k in jb if k.split("/")[0] in ("sc", "gt", "ref", "input", "latent_prior", "latent_post")]
    assert set(keys) <= set(tb)
    for k in keys:
        np.testing.assert_allclose(tb[k].numpy().astype(np.float64), np.asarray(jb[k]).astype(np.float64),
                                   err_msg=k, **TOL)


def test_train_entry_points_refuse_missing_cuda(base):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TO.make_model(port_cfg(base["cfg"]))
