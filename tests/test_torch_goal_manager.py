"""The goal heads and `need_weights` against the JAX package, on the CPU at
the tests/tiny.py widths (d = 64, 2 heads).

Each `DestPredictor` head mode ("mlp", "attn", "transformer",
"transformer_aggr") and the goal_xy `GoalPredictor` run on the same numpy
inputs on both sides, the port's weights filled from JAX's by
`weights.load_jax_params`: the logits (finite where JAX's are) and the
goal means within atol = rtol = 1e-5 in fp32, `log_std` exact, the type
exclusions and validity exact. `need_weights` of `Attention` and
`TransformerBlock` against JAX's, within 1e-5. Then the goal_xy model's
validation step (K = 6 joint futures sampling goals from the DiagGaussian,
JAX's normal draws injected through `distributions.standard_normal`) as
tests/test_torch_validation.py holds the default model's: booleans exactly,
the sampled goals and log-probs within 1e-5, preds within 1e-4 m over the
first 20 steps and 1e-3 m over the first 50.
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
from trafficbots_tpu.models import goal_manager as JGM  # noqa: E402
from trafficbots_tpu.models.modules import Attention as JAttention, TransformerBlock as JBlock  # noqa: E402
import trafficbots_tpu_torch.distributions as TD  # noqa: E402
from trafficbots_tpu_torch import evaluation_loop as TE  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import TransformerConfig, config_from_dict  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import to_torch  # noqa: E402
from trafficbots_tpu_torch.models import goal_manager as TGM  # noqa: E402
from trafficbots_tpu_torch.models.modules import Attention, TransformerBlock, tf_block_kwargs  # noqa: E402
from trafficbots_tpu_torch.ops.dropout import DropoutSeeds  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)
HELD_STEPS = 50
ROLLOUT_ATOL = 1e-3  # metres
S, T, A, P, D = 2, 11, 4, 16, 64


def head_inputs(seed=0):
    """Numpy inputs of a goal head: some agents without history, some
    polylines invalid or of types each agent type excludes."""
    rs = np.random.RandomState(seed)
    agent_type = np.eye(3, dtype=bool)[rs.randint(0, 3, size=(S, A))]
    map_type = np.zeros((S, P, 11), bool)
    map_type[np.arange(S)[:, None], np.arange(P)[None], rs.randint(0, 6, size=(S, P))] = True
    valid = rs.rand(S, T, A) < 0.7
    valid[0, :, 3] = False  # an agent without history
    map_valid = rs.rand(S, P) < 0.8
    return dict(
        agent_type=agent_type, map_type=map_type,
        agent_state=rs.normal(size=(S, T, A, 4)).astype(np.float32) * np.float32(5.0),
        agent_feature=rs.normal(size=(S, T, A, D)).astype(np.float32),
        agent_feature_valid=valid,
        map_feature=rs.normal(size=(S, P, D)).astype(np.float32),
        map_feature_valid=map_valid,
    )


TF = dict(d_model=D, n_head=2, d_feedforward=64)
HEADS = {
    "mlp": dict(mode="mlp"), "attn": dict(mode="attn"), "transformer": dict(mode="transformer"),
    "transformer_aggr": dict(mode="transformer_aggr"), "goal_xy": dict(goal_in_local=True),
    "goal_xy_global": dict(goal_in_local=False),
}


def build_head(name, dropout_p=0.0, n_layer_gru=1):
    """The JAX head, its params (perturbed off the init), and the port's
    head filled from them."""
    kw = dict(HEADS[name], n_layer_gru=n_layer_gru)
    jtf = JGM.TransformerConfig(**TF, dropout_p=dropout_p)
    ttf = TransformerConfig(**TF, dropout_p=dropout_p)
    if name.startswith("goal_xy"):
        jm, tm = JGM.GoalPredictor(tf_cfg=jtf, **kw), TGM.GoalPredictor(ttf, **kw)
    else:
        jm, tm = JGM.DestPredictor(tf_cfg=jtf, **kw), TGM.DestPredictor(ttf, **kw)
    x = {k: jnp.asarray(v) for k, v in head_inputs().items()}
    params = jm.init(jax.random.PRNGKey(0), **x)["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [a + 0.05 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("name", sorted(HEADS))
def test_goal_head_matches_jax(name):
    jm, params, tm = build_head(name)
    inp = head_inputs()
    j = jm.apply({"params": params}, **{k: jnp.asarray(v) for k, v in inp.items()})
    with torch.no_grad():
        t = tm(**{k: torch.from_numpy(v) for k, v in inp.items()})
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert not t.valid.numpy()[0, 3]
    if name.startswith("goal_xy"):
        assert isinstance(t, TD.DiagGaussian)
        np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), **TOL)
        np.testing.assert_array_equal(t.log_std.detach().numpy(), np.asarray(j.log_std))
        assert (t.mean.numpy()[0, 3] == 0).all()
        return
    jl, tl = np.asarray(j.logits), t.logits.numpy()
    finite = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), finite)
    np.testing.assert_allclose(tl[finite], jl[finite], **TOL)
    # the exclusions: no mass on an invalid or excluded polyline of a row with any left
    map_type_mask, attn_mask = TGM.dest_type_masks(*(torch.from_numpy(inp[k]) for k in
                                                     ("agent_type", "map_type", "map_feature_valid")))
    excluded = (map_type_mask[:, None] | attn_mask).numpy()
    rows = t.valid.numpy() & ~excluded.all(-1)
    assert rows.any() and np.isneginf(tl[rows][excluded[rows]]).all()
    np.testing.assert_allclose(t.probs.numpy()[rows].sum(-1), 1.0, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["mlp", "attn", "transformer", "transformer_aggr", "goal_xy"])
def test_goal_head_training_pass(name):
    """With `rng` (a training pass): dropout 0 gives the eval pass's output
    to the bit; dropout 0.1 moves it and stays finite, and the parameters
    along each path the output reads get gradients. Two GRU layers, so the
    "mlp" head has a dropout site (between them)."""
    _, params, tm0 = build_head(name, dropout_p=0.0, n_layer_gru=2)
    _, _, tm1 = build_head(name, dropout_p=0.1, n_layer_gru=2)
    inp = {k: torch.from_numpy(v) for k, v in head_inputs().items()}
    inp["agent_feature"].requires_grad_()

    def out(m, rng):
        d = m(**inp, rng=rng)
        return d.mean if name == "goal_xy" else d.logits

    with torch.no_grad():
        ref = out(tm0, None)
    assert torch.equal(out(tm0, DropoutSeeds(3)), ref)
    live = out(tm1, DropoutSeeds(3))
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(live), fin) and not torch.equal(live[fin], ref[fin])
    loss = live[fin].sum() + (tm1(**inp, rng=DropoutSeeds(4)).log_std.sum() if name == "goal_xy" else 0)
    loss.backward()
    assert inp["agent_feature"].grad is None  # detach_features
    grads = {n: p.grad for n, p in tm1.named_parameters()}
    read = {"mlp": ("gru_as.gru1.w_i", "mlp.fc0.weight"), "attn": ("gru_as.gru0.w_h", "attn.q_proj.weight"),
            "transformer": ("pl2as.layer0.attn.q_proj.weight", "mlp.fc1.weight"),
            "transformer_aggr": ("gru_as.gru0.w_i", "pl2as.layer0.attn.v_proj.weight", "mlp.fc0.weight"),
            "goal_xy": ("gru_as.gru1.w_h", "as2pl.layer0.attn.q_proj.weight", "mlp_mean.fc1.weight", "log_std")}
    for n in read[name]:
        assert grads[n] is not None and grads[n].abs().sum() > 0, n


def test_goal_heads_load_strictly_both_ways():
    for name in ("attn", "transformer", "goal_xy"):
        jm, params, tm = build_head(name)
        p = jax.tree_util.tree_map(np.asarray, params)
        sub = {"attn": "attn", "transformer": "pl2as", "goal_xy": "as2pl"}[name]
        with pytest.raises(KeyError, match=sub):
            load_jax_params(tm, {k: v for k, v in p.items() if k != sub})
        with pytest.raises(ValueError, match="stray"):
            load_jax_params(tm, dict(p, stray={"kernel": np.zeros((2, 2), np.float32)}))
        if name == "goal_xy":
            with pytest.raises(KeyError, match="log_std"):
                load_jax_params(tm, {k: v for k, v in p.items() if k != "log_std"})


def attention_inputs(seed=1, B=2, Sq=5, Tk=7):
    rs = np.random.RandomState(seed)
    pad = rs.rand(B, Tk) < 0.3
    pad[1] = True  # no valid target in scene 1: zero rows
    am = rs.rand(B, Sq, Tk) < 0.3
    spad = rs.rand(B, Sq) < 0.3
    return (rs.normal(size=(B, Sq, D)).astype(np.float32), rs.normal(size=(B, Tk, D)).astype(np.float32),
            pad, am, spad)


def _jax_params(module, *args, **kw):
    params = module.init(jax.random.PRNGKey(2), *args, **kw)["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(tree, [a + 0.05 * jax.random.normal(jax.random.PRNGKey(i), a.shape)
                                               for i, a in enumerate(leaves)])


def test_attention_need_weights_matches_jax():
    src, tgt, pad, am, _ = attention_inputs()
    jm = JAttention(d_model=D, n_head=2)
    args = (jnp.asarray(src),)
    kw = dict(tgt=jnp.asarray(tgt), tgt_padding_mask=jnp.asarray(pad), attn_mask=jnp.asarray(am), need_weights=True)
    params = _jax_params(jm, *args, **kw)
    jout, jw = jm.apply({"params": params}, *args, **kw)
    tm = Attention(D, 2)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        tout, tw = tm(torch.from_numpy(src), tgt=torch.from_numpy(tgt), tgt_padding_mask=torch.from_numpy(pad),
                      attn_mask=torch.from_numpy(am), need_weights=True)
        plain = tm(torch.from_numpy(src), tgt=torch.from_numpy(tgt), tgt_padding_mask=torch.from_numpy(pad),
                   attn_mask=torch.from_numpy(am))
    assert tw.shape == (2, 5, 7)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert torch.equal(tout, plain)  # the same output as without the weights
    assert (tw[1] == 0).all()
    rows = ~(pad[:, None] | am).all(-1)
    np.testing.assert_allclose(tw.numpy().sum(-1)[rows], 1.0, atol=1e-6, rtol=0)


def test_transformer_block_need_weights_matches_jax():
    src, tgt, pad, am, spad = attention_inputs(seed=3)
    jm = JBlock(d_model=D, n_head=2, d_feedforward=64, dropout_p=0.0, n_layer=2)
    args = (jnp.asarray(src),)
    kw = dict(src_padding_mask=jnp.asarray(spad), tgt=jnp.asarray(tgt), tgt_padding_mask=jnp.asarray(pad),
              attn_mask=jnp.asarray(am), need_weights=True)
    params = _jax_params(jm, *args, **kw)
    jout, jw = jm.apply({"params": params}, *args, **kw)
    tm = TransformerBlock(n_layer=2, **tf_block_kwargs(TransformerConfig(**TF, dropout_p=0.0)))
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    tkw = dict(src_padding_mask=torch.from_numpy(spad), tgt=torch.from_numpy(tgt),
               tgt_padding_mask=torch.from_numpy(pad), attn_mask=torch.from_numpy(am))
    with torch.no_grad():
        tout, tw = tm(torch.from_numpy(src), need_weights=True, **tkw)
        assert torch.equal(tout, tm(torch.from_numpy(src), **tkw))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    assert (tw.numpy()[spad] == 0).all()


# ------------------------------------------------------------------ goal_xy validation


def goal_xy_config():
    cfg = tiny_config(n_step=91, time_step_end=90)
    gm = dataclasses.replace(cfg.model.goal_manager, goal_attr_mode="goal_xy")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, goal_manager=gm))


def jax_normals(cfg, n_scene, key):
    """The goal_xy joint futures' goal and latent normals, as the JAX
    package draws them from `key` in validation_device_step."""
    k = cfg.n_joint_future
    _, k2 = jax.random.split(key)
    _, k_goal, k_roll = jax.random.split(k2, 3)
    _, k_latent = jax.random.split(k_roll)
    A_ = cfg.data.n_agent
    return {(n_scene * k, A_, 2): np.asarray(jax.random.normal(k_goal, (n_scene * k, A_, 2), jnp.float32)),
            (n_scene * k, A_, cfg.model.latent_encoder.latent_dim): np.asarray(
                jax.random.normal(k_latent, (n_scene * k, A_, cfg.model.latent_encoder.latent_dim), jnp.float32))}


@pytest.fixture(scope="module")
def goal_xy_val():
    jcfg = goal_xy_config()
    cfg = config_from_dict(config_to_dict(jcfg))
    batch = tiny_batch(jcfg, n_scene=2, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, list)}
    jmodel, params = JO.init_params(jcfg, jax.random.PRNGKey(0), jb)
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, b, k: JE.validation_device_step(jcfg, jmodel, p, b, k))(params, jb, jax.random.PRNGKey(5)))
    tmodel = TO.make_model(cfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    normals = jax_normals(jcfg, 2, jax.random.PRNGKey(5))
    mp = pytest.MonkeyPatch()
    mp.setattr(TD, "standard_normal", lambda shape, dtype, device, generator=None: torch.tensor(
        normals[tuple(shape)], dtype=dtype, device=device))
    try:
        tout = TE.validation_device_step(cfg, tmodel, to_torch(batch, "cpu"), torch.Generator().manual_seed(0))
    finally:
        mp.undo()
    return jout, tout


def _hold_preds(t, j, record_property, name):
    t = t.numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t[..., :20, :], j[..., :20, :], atol=1e-4, rtol=0)
    np.testing.assert_allclose(t[..., :HELD_STEPS, :], j[..., :HELD_STEPS, :], atol=ROLLOUT_ATOL, rtol=0)
    record_property(f"{name}_max_abs_diff_all_steps_m", float(np.abs(t - j).max()))


def test_goal_xy_validation_goals_match_jax(goal_xy_val):
    j, t = goal_xy_val
    assert t["goal_sample"].shape == j["goal_sample"].shape == (2, 4, 6, 2)
    np.testing.assert_allclose(t["goal_sample"].numpy(), j["goal_sample"], **TOL)
    assert (j["goal_sample"][:, :, 1:] != j["goal_sample"][:, :, :1]).any()  # the draws do move the goals
    np.testing.assert_allclose(t["goal_logp"].numpy(), j["goal_logp"], **TOL)
    np.testing.assert_array_equal(t["buf_rr_valid"].numpy(), j["buf_rr_valid"])
    np.testing.assert_array_equal(t["buf_jf_valid"].numpy(), j["buf_jf_valid"])
    for group in ("train_rr",):
        for k, v in j[group].items():
            np.testing.assert_allclose(t[group][k].numpy(), v, rtol=1e-3, atol=1e-5, err_msg=k)


def test_goal_xy_validation_preds_match_jax(goal_xy_val, record_property):
    j, t = goal_xy_val
    _hold_preds(t["buf_rr_preds"], j["buf_rr_preds"], record_property, "rr_preds")
    _hold_preds(t["buf_jf_preds"], j["buf_jf_preds"], record_property, "jf_preds")
