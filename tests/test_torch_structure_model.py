"""A whole model with the structure options the port once refused, against
the JAX package on the CPU at the tests/tiny.py widths, fp32 eval mode:
post-norm layers without a feed-forward (so the map encoder takes the
generic node stack), a 2-layer final MLP, an unbranched LayerNorm'd action
head whose log_std is an MLP.

The weights are the port's seeded init, handed to JAX through
`weights.flax_paths` (no JAX init to compile); the tree they make has
exactly the leaves and shapes of JAX's (`jax.eval_shape` of its init).
`weights.load_jax_params` is strict on the new subtrees both ways: a
missing array raises, and so does an array nothing consumes. The input
view's map, agent and traffic-light features and two hidden-carrying
policy steps match JAX's (atol = rtol = 1e-5); the port's training step
runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.config import config_to_dict  # noqa: E402
from trafficbots_tpu.data.preprocessing import extract as j_extract, pre_processing as j_pre  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import extract as t_extract, pre_processing as t_pre, to_torch  # noqa: E402
from trafficbots_tpu_torch.training import train as TT  # noqa: E402
from trafficbots_tpu_torch.weights import flax_paths, load_jax_params  # noqa: E402

from test_torch_ablations import jax_param_shapes  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def model_config():
    cfg = tiny_config(n_step=31, time_step_end=20)
    m = cfg.model
    m = dataclasses.replace(m, tf_cfg=dataclasses.replace(m.tf_cfg, norm_first=False, d_feedforward=0),
                            n_layer_final_mlp=2)
    head = dataclasses.replace(cfg.action_head, branch_type=False, use_layernorm=True, log_std=None)
    cfg = dataclasses.replace(cfg, model=m, action_head=head)
    return cfg, config_from_dict(config_to_dict(cfg))


def flax_tree(model):
    """The port's parameters as a flax param tree of numpy arrays."""
    tree = {}
    params = dict(model.named_parameters())
    for name, (path, transposed) in flax_paths(model).items():
        value = params[name].detach().numpy()
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value.T.copy() if transposed else value.copy()
    return tree


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(leaves(v, path) if isinstance(v, dict) else {path: tuple(v.shape)})
    return out


@pytest.fixture(scope="module")
def setup():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg, cfg = model_config()
    batch = tiny_batch(jcfg, n_scene=2, seed=0)
    tmodel = TO.make_model(cfg, device="cpu", seed=0)
    params_np = flax_tree(tmodel)
    jshapes = leaves(jax.tree_util.tree_map(np.asarray, jax_param_shapes(jcfg, batch)))
    jmodel = JO.make_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    jb = j_pre({k: jnp.asarray(v) for k, v in batch.items()}, jcfg.model, training=False)
    tb = t_pre(to_torch(batch, "cpu"), cfg.model, training=False)
    jf = jmodel.apply({"params": params}, method="encode_input_features", **j_extract(jb, "input"))
    with torch.no_grad():
        tf = tmodel.encode_input_features(**t_extract(tb, "input"))
    yield dict(cfg=cfg, batch=batch, jmodel=jmodel, params=params, params_np=params_np, jshapes=jshapes,
               tmodel=tmodel, jb=jb, tb=tb, jf=jf, tf=tf)
    torch.set_num_threads(n)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_the_parameter_tree_is_jax_s(setup):
    assert leaves(setup["params_np"]) == setup["jshapes"]


def without(tree, path):
    if len(path) == 1:
        return {k: v for k, v in tree.items() if k != path[0]}
    return dict(tree, **{path[0]: without(tree[path[0]], path[1:])})


@pytest.mark.parametrize("subtree", [("final_mlp", "fc1"), ("action_head", "mlp_log_std", "ln0"),
                                     ("map_encoder", "densetnt", "layer0", "norm1_post")])
def test_load_jax_params_is_strict_on_the_new_subtrees(setup, subtree):
    p, cfg = setup["params_np"], setup["cfg"]
    with pytest.raises(KeyError, match="/".join(subtree)):
        load_jax_params(TO.make_model(cfg, device="cpu"), without(p, subtree))
    stray = dict(p, **{subtree[0]: dict(p[subtree[0]], stray={"bias": np.zeros(2, np.float32)})})
    with pytest.raises(ValueError, match=f"{subtree[0]}/stray"):
        load_jax_params(TO.make_model(cfg, device="cpu"), stray)
    load_jax_params(TO.make_model(cfg, device="cpu"), p)


def test_encoders_match_jax(setup):
    for key in ("map_feature", "agent_feature", "tl_feature"):
        _close(setup["tf"][key], setup["jf"][key])


def test_policy_steps_match_jax(setup):
    s = setup
    cfg, jm_, p, tmod = s["cfg"], s["jmodel"], s["params"], s["tmodel"]
    jf, tf, jb, tb = s["jf"], s["tf"], s["jb"], s["tb"]
    rs = np.random.RandomState(0)
    B, A, d = jf["agent_feature"][:, 0].shape
    goal_f = rs.normal(size=(B, A, d)).astype(np.float32)
    lat = rs.normal(size=(B, A, cfg.model.latent_encoder.latent_dim)).astype(np.float32)
    gv = rs.rand(B, A) < 0.7
    jh = jm_.apply({"params": p}, method="init_hidden", n_batch=B, n_agent=A)
    th = tmod.init_hidden(B, A)
    for step in range(2):
        jmean, jlog, jh, jx, _ = jm_.apply(
            {"params": p}, method="policy_step", agent_valid=jb["input/agent_valid"][:, step],
            agent_feature=jf["agent_feature"][:, step], map_valid=jf["map_feature_valid"],
            map_feature=jf["map_feature"], tl_valid=jf["tl_feature_valid"][:, step],
            tl_feature=jf["tl_feature"][:, step], goal_valid=jnp.asarray(gv), goal_feature=jnp.asarray(goal_f),
            latent_sample=jnp.asarray(lat), hidden=jh, agent_type=jb["sc/agent_type"])
        with torch.no_grad():
            tmean, tlog, th, tx = tmod.policy_step(
                agent_valid=tb["input/agent_valid"][:, step], agent_feature=tf["agent_feature"][:, step],
                map_valid=tf["map_feature_valid"], map_feature=tf["map_feature"],
                tl_valid=tf["tl_feature_valid"][:, step], tl_feature=tf["tl_feature"][:, step],
                goal_valid=torch.from_numpy(gv), goal_feature=torch.from_numpy(goal_f),
                latent_sample=torch.from_numpy(lat), hidden=th, agent_type=tb["sc/agent_type"])
        _close(tx, jx)
        _close(th, jh)
        _close(tmean, jmean)
        _close(tlog, jlog)


def test_the_options_train_in_the_port(setup):
    cfg = setup["cfg"]
    model = TO.make_model(cfg, device="cpu", seed=0)
    m = TT.make_train_step(cfg, model, TT.make_optimizer(cfg, model))(setup["batch"], seed=1)
    assert np.isfinite(m["loss"].item()) and m["grad_norm"].item() > 0
