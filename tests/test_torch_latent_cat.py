"""The categorical latent and the latent encoder's remaining options, against
the JAX package on the CPU at the tests/tiny.py widths.

`MultiCategorical`'s random sample is drawn with JAX's own Gumbel noise
(`jax.random.gumbel` of the key `jax.random.categorical` draws from)
handed to the port through `distributions.standard_gumbel`: the one-hots
are held exactly. Values (log-probs, KL, the balanced KL and its
gradients, the distribution heads, the latent encoders) within atol = rtol
= 1e-5 in fp32, as tests/test_torch_slice.py holds the latent encoder.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import trafficbots_tpu.distributions as JD  # noqa: E402
from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.config import DistEncoderConfig, config_to_dict  # noqa: E402
from trafficbots_tpu.data.preprocessing import pre_processing as j_pre  # noqa: E402
from trafficbots_tpu.models.latent_encoder import DistEncoder as JDistEncoder  # noqa: E402
from trafficbots_tpu.training import loss as JL  # noqa: E402
import trafficbots_tpu_torch.distributions as TD  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import DistEncoderConfig as TDistEncoderConfig, config_from_dict  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import pre_processing as t_pre, to_torch  # noqa: E402
from trafficbots_tpu_torch.models.latent_encoder import DistEncoder as TDistEncoder  # noqa: E402
from trafficbots_tpu_torch.training import loss as TL  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _probs(seed, shape=(2, 3, 4, 5)):
    return np.array(jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(seed), shape), -1))


def inject_gumbel(mp, arr):
    def fn(shape, dtype, device, generator=None):
        assert tuple(shape) == arr.shape, (tuple(shape), arr.shape)
        return torch.tensor(arr, device=device, dtype=dtype)

    mp.setattr(TD, "standard_gumbel", fn)


@pytest.mark.parametrize("deterministic", ["random", "mixed", "argmax"])
def test_multi_categorical_sample_is_jax_s_under_its_gumbel_draws(monkeypatch, deterministic):
    probs = _probs(0)
    probs[0, 0, 0] = 0.0  # a zero class: log clamps at tiny on both sides
    probs[0, 0, 0, 2] = 1.0
    key = jax.random.PRNGKey(11)
    det = {"random": False, "argmax": True, "mixed": np.arange(6).reshape(2, 3) % 2 == 0}[deterministic]
    jdist = JD.MultiCategorical(probs=jnp.asarray(probs))
    jsample = np.asarray(jdist.sample(key, det if isinstance(det, bool) else jnp.asarray(det)))
    inject_gumbel(monkeypatch, np.asarray(jax.random.gumbel(key, probs.shape, jnp.float32)))
    tdist = TD.MultiCategorical(probs=torch.from_numpy(probs))
    tsample = tdist.sample(torch.Generator().manual_seed(0), det if isinstance(det, bool) else torch.from_numpy(det))
    assert tsample.shape == (2, 3, 20)
    np.testing.assert_array_equal(tsample.numpy(), jsample)
    if deterministic == "random":  # the draws do differ from the argmax
        assert (jsample != np.asarray(jdist.sample(key, True))).any()
    np.testing.assert_allclose(tdist.log_prob(tsample).numpy(), np.asarray(jdist.log_prob(jnp.asarray(jsample))), **TOL)


def test_multi_categorical_sample_is_straight_through():
    """The random sample's gradient is the probabilities' (JAX:
    probs + stop_gradient(one_hot - probs)); the argmax's is none."""
    logits = torch.from_numpy(np.random.RandomState(0).normal(size=(2, 3, 4)).astype(np.float32)).requires_grad_()
    w = torch.arange(12.0).reshape(1, 12)
    probs = torch.softmax(logits, -1)
    (TD.MultiCategorical(probs).sample(torch.Generator().manual_seed(1), False) * w).sum().backward()
    expect = torch.autograd.grad((torch.softmax(logits, -1).reshape(2, 12) * w).sum(), logits)[0]
    torch.testing.assert_close(logits.grad, expect)
    assert not TD.MultiCategorical(probs.detach()).sample(None, True).requires_grad


def test_multi_categorical_repeat():
    probs, valid = _probs(1), np.array([[True, False, True], [False, True, True]])
    j = JD.MultiCategorical(jnp.asarray(probs), jnp.asarray(valid)).repeat(3, axis=0)
    t = TD.MultiCategorical(torch.from_numpy(probs), torch.from_numpy(valid)).repeat(3, axis=0)
    np.testing.assert_array_equal(t.probs.numpy(), np.asarray(j.probs))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


def test_kl_multi_categorical():
    p, q = _probs(2), _probs(3)
    p[0, 1, 2] = np.eye(5)[1]  # zero probabilities on both sides of the log
    j = JD.kl_multi_categorical(JD.MultiCategorical(jnp.asarray(p)), JD.MultiCategorical(jnp.asarray(q)))
    t = TD.kl_multi_categorical(TD.MultiCategorical(torch.from_numpy(p)), TD.MultiCategorical(torch.from_numpy(q)))
    assert t.shape == (2, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("alpha", [-1.0, 0.8])
@pytest.mark.parametrize("free_nats", [-1.0, 0.05])
def test_balanced_kl_of_multi_categoricals_value_and_gradients(alpha, free_nats):
    rs = np.random.RandomState(4)
    lp, lq = rs.normal(size=(2, 2, 3, 4, 5)).astype(np.float32)
    weight = np.arange(6.0, dtype=np.float32).reshape(2, 3)

    def j_fn(lp, lq):
        post = JD.MultiCategorical(jax.nn.softmax(lp, -1))
        prior = JD.MultiCategorical(jax.nn.softmax(lq, -1))
        return jnp.sum(JL.balanced_kl(post, prior, alpha, free_nats) * weight)

    jv, jg = jax.value_and_grad(j_fn, argnums=(0, 1))(lp, lq)
    ts = [torch.from_numpy(a).requires_grad_() for a in (lp, lq)]
    post, prior = (TD.MultiCategorical(torch.softmax(t, -1)) for t in ts)
    tv = (TL.balanced_kl(post, prior, alpha, free_nats) * torch.from_numpy(weight)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    for t, j in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)
        assert np.abs(np.asarray(j)).sum() > 0


@pytest.mark.parametrize("dcfg", [
    DistEncoderConfig(dist_type="cat", n_cat=4),
    DistEncoderConfig(dist_type="cat", n_cat=2, use_layernorm=True),
    DistEncoderConfig(dist_type="diag_gaus", log_std=None),
    DistEncoderConfig(dist_type="std_gaus", log_std=None),
], ids=["cat", "cat_layernorm", "learned_log_std", "std_gaus_default_log_std"])
def test_dist_encoder_matches_jax(dcfg):
    rs = np.random.RandomState(5)
    x = rs.normal(size=(2, 3, 32)).astype(np.float32)
    valid = rs.rand(2, 3) < 0.7
    jm = JDistEncoder(cfg=dcfg, hidden_dim=32, out_dim=8)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid))["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(1), a.shape), params)
    j = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(valid))
    tm = TDistEncoder(config_from_dict(dataclasses.asdict(dcfg), TDistEncoderConfig), 32, 8)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        t = tm(torch.from_numpy(x), torch.from_numpy(valid))
    assert type(t).__name__ == type(j).__name__
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    if dcfg.dist_type == "cat":
        assert t.probs.shape == (2, 3, dcfg.n_cat, 8 // dcfg.n_cat)
        np.testing.assert_allclose(t.probs.numpy(), np.asarray(j.probs), **TOL)
    else:
        np.testing.assert_allclose(t.mean.detach().numpy(), np.asarray(j.mean), **TOL)
        np.testing.assert_allclose(t.stddev.detach().numpy(), np.asarray(j.stddev), **TOL)


def _latent_cfg(**le_kw):
    cfg = tiny_config()
    le = dataclasses.replace(cfg.model.latent_encoder, **le_kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, latent_encoder=le))


CAT = DistEncoderConfig(dist_type="cat", n_cat=2)
LEARNED = DistEncoderConfig(log_std=None)
LATENT_OPTIONS = {
    "cat": dict(latent_post=CAT, latent_prior=CAT),
    "learned_log_std": dict(latent_post=LEARNED, latent_prior=LEARNED),
    "unshared_as2pl_as2tl": dict(shared_transformer_as=False),
    "shared_post_prior_net": dict(shared_post_prior_net=True),
}


@pytest.fixture(scope="module", params=sorted(LATENT_OPTIONS))
def latent_model(request):
    cfg = _latent_cfg(**LATENT_OPTIONS[request.param])
    batch = tiny_batch(cfg, n_scene=2, seed=0)
    jmodel, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tmodel = TO.make_model(config_from_dict(config_to_dict(cfg)), device="cpu")
    load_jax_params(tmodel, params_np)
    jb = j_pre({k: jnp.asarray(v) for k, v in batch.items()}, cfg.model, training=True)
    tb = t_pre(to_torch(batch, "cpu"), cfg.model, training=True)
    jf = JO.encode_episode_features(jmodel, params, jb, training=False, key=None)
    with torch.no_grad():
        tf = TO.encode_episode_features(tmodel, tb)
    return dict(name=request.param, cfg=cfg, jmodel=jmodel, params=params, params_np=params_np,
                tmodel=tmodel, jf=jf, tf=tf)


@pytest.mark.parametrize("posterior", [True, False])
def test_latent_encoder_option_matches_jax(latent_model, posterior):
    s = latent_model
    view = "latent_post" if posterior else "latent_prior"
    j = s["jmodel"].apply({"params": s["params"]}, method="latent", posterior=posterior, **s["jf"][view])
    with torch.no_grad():
        t = s["tmodel"].latent(posterior=posterior, **s["tf"][view])
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    if s["name"] == "cat":
        assert isinstance(t, TD.MultiCategorical) and t.probs.shape[-2:] == (2, 4)
        np.testing.assert_allclose(t.probs.numpy(), np.asarray(j.probs), **TOL)
    else:
        np.testing.assert_allclose(t.mean.detach().numpy(), np.asarray(j.mean), **TOL)
        np.testing.assert_allclose(t.stddev.detach().numpy(), np.asarray(j.stddev), **TOL)


def test_latent_encoder_option_loads_strictly_both_ways(latent_model):
    """The option's own subtrees are read by name, each once: dropping one
    raises KeyError, a stray array next to them raises ValueError."""
    s = latent_model
    le = s["params_np"]["latent_encoder"]
    sub = {"cat": ("post_dist", "mlp_logits"), "learned_log_std": ("prior_dist", "mlp_log_std"),
           "unshared_as2pl_as2tl": ("as2tl",), "shared_post_prior_net": ("interaction_post",)}[s["name"]]
    names = {n for n, _ in s["tmodel"].named_parameters()}
    assert any(n.startswith("latent_encoder." + ".".join(sub)) for n in names)
    if s["name"] == "shared_post_prior_net":
        assert "temporal_prior" not in le and not any("_prior." in n for n in names)
    dropped = dict(le)
    if len(sub) == 1:
        del dropped[sub[0]]
    else:
        dropped[sub[0]] = {k: v for k, v in le[sub[0]].items() if k != sub[1]}
    m = TO.make_model(config_from_dict(config_to_dict(s["cfg"])), device="cpu")
    with pytest.raises(KeyError, match="/".join(sub)):
        load_jax_params(m, dict(s["params_np"], latent_encoder=dropped))
    stray = dict(le, temporal_prior=le["temporal_post"]) if s["name"] == "shared_post_prior_net" else \
        dict(le, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_params(m, dict(s["params_np"], latent_encoder=stray))
