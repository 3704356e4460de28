"""The training-input augmentations of the port against the JAX package's, on
the CPU at the tests/tiny.py widths: history dropout (`dropout_p_history`)
and the SE(2) perturbation of the latent inputs (`perturb_input_to_latent`),
each alone and both together.

Random draws: the JAX side runs with `jax.random.uniform` and
`jax.random.bernoulli` wrapped to record the [0, 1) uniforms they draw (a
Bernoulli draw is `uniform < p`), in call order; the port gets the same
arrays, in the same order, through `distributions.standard_uniform`, and
must ask for each one's shape.

- `sc_input`, `sc_latent` and `pre_processing` (training) give JAX's keys,
  key by key: the masks exactly, the floats within 1e-6. The SE(2)-perturbed
  latent views are the exception, for a reason of rounding: the rotation's
  cos and sin differ from XLA's by an ulp on about 5% of inputs, so their
  rotated coordinates (up to ~120 m) differ by up to 3 ulp (2.3e-5 m). Those
  are held within 1e-6 of the key's largest magnitude, and their positional
  encodings, sin/cos of those coordinates, within 1e-4 (the coordinate gap
  times the largest frequency, 1); every encoding the port computes there is
  also held within 1e-6 of JAX's `pose_pe` (eager) on the port's own inputs.
  With both options off, pre-processing draws nothing.
- `encode_episode_features` on a perturbed batch encodes the map once a
  view (three map encodes) and gives JAX's features
  (`share_map_encoding=False`) on the same pre-processed numbers within
  1e-5; without the `latent_perturbed` marker it encodes the map once and
  every view shares it.
- One training step with both options on (model dropout 0, the latent
  noise injected as tests/test_torch_training.py injects it): the loss and
  metrics within rtol 1e-5 and each gradient within a relative norm error
  of 1e-4 of `jax.value_and_grad` of JAX's step, three map encodes.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.data import preprocessing as JP  # noqa: E402
import trafficbots_tpu_torch.distributions as TD  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.data import preprocessing as TP  # noqa: E402
from trafficbots_tpu_torch.models import map_encoder as TME  # noqa: E402
from trafficbots_tpu_torch.weights import flax_paths  # noqa: E402

from test_torch_training import flat_flax, inject_latent_noise, no_dropout, port_cfg, port_model  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

OPTIONS = {
    "history_dropout": dict(dropout_p_history=0.2),
    "perturb": dict(perturb_input_to_latent=True),
    "both": dict(dropout_p_history=0.2, perturb_input_to_latent=True),
}
PREFIXES = ("sc/", "gt/", "ref/", "input/", "latent_post/", "latent_prior/", "latent_perturbed")
FLOAT_TOL = dict(atol=1e-6, rtol=1e-6)
PERTURBED_REL = 1e-6  # of the key's largest magnitude: the rotated coordinates
PERTURBED_PE_ATOL = 1e-4  # the encodings of the rotated coordinates
FEAT_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-4
N_HIST = 11


def with_options(cfg, **opts):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **opts))


@contextlib.contextmanager
def recorded_draws():
    """jax.random.uniform / bernoulli record the [0, 1) uniforms they draw,
    in call order (also inside a function jax traces)."""
    draws = []
    uniform0, bernoulli0 = jax.random.uniform, jax.random.bernoulli

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        draws.append(uniform0(key, shape, dtype))
        return uniform0(key, shape, dtype, minval, maxval)

    def bernoulli(key, p=0.5, shape=None):
        draws.append(uniform0(key, shape, jnp.float32))
        return bernoulli0(key, p, shape)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", uniform)
    mp.setattr(jax.random, "bernoulli", bernoulli)
    try:
        yield draws
    finally:
        mp.undo()


def inject_uniforms(mp, draws):
    """distributions.standard_uniform hands out `draws` in order, each only
    for its own shape. -> the queue (empty once every draw was taken)."""
    queue = list(draws)

    def fn(shape, dtype, device, generator=None):
        assert queue, "the port draws more uniforms than the JAX package"
        arr = queue.pop(0)
        assert tuple(shape) == arr.shape, (tuple(shape), arr.shape)
        return torch.tensor(arr, dtype=dtype, device=device)

    mp.setattr(TD, "standard_uniform", fn)
    return queue


def assert_same_keys(t, j):
    keys = sorted(k for k in j if k.startswith(PREFIXES))
    assert keys == sorted(k for k in t if k.startswith(PREFIXES))
    perturbed = "latent_perturbed" in j
    for k in keys:
        jv, tv = np.asarray(j[k]), t[k].numpy()
        assert jv.shape == tv.shape, k
        if jv.dtype == bool or np.issubdtype(jv.dtype, np.integer):
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        elif perturbed and k.startswith("latent_") and k.endswith("_pe"):
            np.testing.assert_allclose(tv, jv, err_msg=k, atol=PERTURBED_PE_ATOL, rtol=0)
        elif perturbed and k.startswith("latent_"):
            np.testing.assert_allclose(tv, jv, err_msg=k, atol=PERTURBED_REL * np.abs(jv).max(), rtol=0)
        else:
            np.testing.assert_allclose(tv, jv, err_msg=k, **FLOAT_TOL)


@contextlib.contextmanager
def pose_pe_checked():
    """The port's pre-processing `pose_pe` calls, each held within 1e-6 of
    the JAX package's `pose_pe` on the same inputs. -> the count."""
    from trafficbots_tpu.geometry import pose_pe

    j_pose_pe = pose_pe
    n = [0]
    t_pose_pe = TP.pose_pe

    def checked(pos, direction, mode, dim):
        out = t_pose_pe(pos, direction, mode, dim)
        ref = np.asarray(j_pose_pe(jnp.asarray(pos.numpy()), jnp.asarray(direction.numpy()), mode, dim))
        np.testing.assert_allclose(out.numpy(), ref, **FLOAT_TOL)
        n[0] += 1
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(TP, "pose_pe", checked)
    try:
        yield n
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def raw():
    cfg = tiny_config(n_step=31, time_step_end=20)
    return cfg, tiny_batch(cfg, n_scene=2, seed=0)


STAGES = ("sc_input", "sc_latent", "pre_processing")


@pytest.fixture(scope="module")
def jax_stages(raw):
    """option -> stage -> (the stage's input, JAX's output, JAX's draws).
    A stage's input comes from the stages before it (sc_latent's from an
    eval sc_input: no draws). The JAX stages run eagerly, op by op: under
    jax.jit XLA fuses the rotation into FMAs and the encodings' sin/cos
    into other code, which moves them by more ulps from the port's."""
    cache = {}

    def get(option):
        if option not in cache:
            cfg = with_options(raw[0], **OPTIONS[option])

            b = {k: jnp.asarray(v) for k, v in raw[1].items()}
            sc = JP.scene_centric(b, N_HIST, True)
            inputs = dict(sc_input=sc, sc_latent=JP.sc_input(sc, cfg.model, N_HIST, False), pre_processing=b)
            out = {}
            for stage in STAGES:
                with recorded_draws() as draws:
                    out[stage] = (inputs[stage], run_stage(stage, JP, cfg, inputs[stage], jax.random.PRNGKey(11)),
                                  draws)
            cache[option] = jax.tree_util.tree_map(np.asarray, out)
        return cache[option]

    return get


def run_stage(stage, side, cfg, b, rng):
    if stage == "pre_processing":
        if side is JP:
            return JP.pre_processing(b, cfg.model, N_HIST, True, key=rng)
        return TP.pre_processing(b, cfg.model, N_HIST, True, generator=rng)
    if stage == "sc_input":
        return side.sc_input(b, cfg.model, N_HIST, True, rng)
    return side.sc_latent(b, cfg.model, True, rng)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("stage", STAGES)
def test_pre_processing_stages_match_jax_with_its_draws(raw, jax_stages, stage, option):
    pcfg = port_cfg(with_options(raw[0], **OPTIONS[option]))
    jb, jout, draws = jax_stages(option)[stage]
    tb = {k: torch.from_numpy(v) for k, v in jb.items()}
    perturbed = stage != "sc_input" and "perturb_input_to_latent" in OPTIONS[option]
    mp = pytest.MonkeyPatch()
    queue = inject_uniforms(mp, draws)
    try:
        with pose_pe_checked() if perturbed else contextlib.nullcontext([1]) as n_pe:
            tout = run_stage(stage, TP, pcfg, tb, torch.Generator().manual_seed(11))
    finally:
        mp.undo()
    assert queue == [] and n_pe[0] > 0
    assert ("latent_perturbed" in tout) == ("latent_perturbed" in jout) == perturbed
    assert_same_keys(tout, jout)
    if "dropout_p_history" in OPTIONS[option] and stage != "sc_latent":
        kept = tout["input/map_valid"].sum() / tout["sc/map_valid"].sum()
        assert 0.5 < kept < 1.0  # the dropout did drop


def test_pre_processing_draws_nothing_with_both_options_off(raw):
    cfg, batch = raw
    pcfg = port_cfg(cfg)
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    a = TP.pre_processing(tb, pcfg.model, N_HIST, True, generator=g)
    b = TP.pre_processing(tb, pcfg.model, N_HIST, True)
    assert torch.equal(g.get_state(), state) and "latent_perturbed" not in a
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@contextlib.contextmanager
def counted_map_encodes():
    """Counts the port's map encodes (MapEncoder.forward calls)."""
    n = [0]
    forward = TME.MapEncoder.forward

    def counting(self, *a, **kw):
        n[0] += 1
        return forward(self, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(TME.MapEncoder, "forward", counting)
    try:
        yield n
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def model(raw):
    cfg, batch = raw
    cfg = no_dropout(with_options(cfg, **OPTIONS["both"]), p_training_rollout_prior=0.0)
    jmodel, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)
    return dict(cfg=cfg, batch=batch, jmodel=jmodel, params=params)


@pytest.fixture(scope="module")
def encoded(model):
    """A batch the port pre-processed with both augmentations (its own
    draws), and JAX's eval encode of the same numbers with the map once a
    view (the pre-processing's rounding is held by the stage test above)."""
    tpre = TP.pre_processing({k: torch.from_numpy(v) for k, v in model["batch"].items()},
                             port_cfg(model["cfg"]).model, N_HIST, True, generator=torch.Generator().manual_seed(2))
    jpre = {k: jnp.asarray(v.numpy()) for k, v in tpre.items()}
    jfeat = jax.jit(lambda p, b: JO.encode_episode_features(model["jmodel"], p, b, training=False, key=None,
                                                            share_map_encoding=False))(model["params"], jpre)
    return dict(jfeat=jfeat, tpre=tpre, tmodel=port_model(model["cfg"], model["params"]))


def test_encode_episode_features_once_a_view_matches_jax(encoded):
    """The perturbed batch's views encoded in eval mode, the map once a view
    (the batch's `latent_perturbed` marker decides)."""
    jfeat = encoded["jfeat"]
    with counted_map_encodes() as n, torch.no_grad():
        tfeat = TO.encode_episode_features(encoded["tmodel"], encoded["tpre"])
    assert n[0] == 3
    assert tfeat.keys() == jfeat.keys() == {"input", "latent_post", "latent_prior"}
    for view in tfeat:
        assert tfeat[view].keys() == jfeat[view].keys()
        for k, v in jfeat[view].items():
            np.testing.assert_allclose(tfeat[view][k].numpy(), np.asarray(v), err_msg=f"{view}/{k}", **FEAT_TOL)
    # the perturbed latent views do see another map than the input view's
    assert not np.allclose(tfeat["latent_prior"]["map_feature"], tfeat["input"]["map_feature"], atol=1e-3)


def test_encode_episode_features_shares_the_map_without_the_marker(model, encoded):
    """History dropout alone leaves every view on one map: without the
    `latent_perturbed` marker the map is encoded once and shared."""
    pcfg = port_cfg(with_options(model["cfg"], perturb_input_to_latent=False))
    tpre = TP.pre_processing({k: torch.from_numpy(v) for k, v in model["batch"].items()}, pcfg.model, N_HIST, True,
                             generator=torch.Generator().manual_seed(2))
    assert "latent_perturbed" not in tpre
    with counted_map_encodes() as n, torch.no_grad():
        tfeat = TO.encode_episode_features(encoded["tmodel"], tpre)
    assert n[0] == 1
    assert tfeat.keys() == {"input", "latent_post", "latent_prior"}
    for view in tfeat:
        assert tfeat[view]["map_feature"] is tfeat["input"]["map_feature"]


@pytest.fixture(scope="module")
def step(model):
    """Loss, metrics and gradients of one training step with both
    augmentations, posterior branch, on both sides."""
    cfg, batch = model["cfg"], model["batch"]
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    eps = np.random.RandomState(7).normal(size=(2, cfg.data.n_agent, cfg.model.latent_encoder.latent_dim))
    mp = pytest.MonkeyPatch()
    inject_latent_noise(mp, eps.astype(np.float32))
    try:
        draws = []
        pre_processing = JO.pre_processing

        def recorded_pre_processing(*a, **kw):  # the step's pre-processing draws
            with recorded_draws() as d:
                out = pre_processing(*a, **kw)
            draws.extend(d)
            return out

        def loss_fn(p):
            loss, metrics = JO.training_step(cfg, model["jmodel"], p, jb, key)
            return loss, (metrics, draws)

        mp.setattr(JO, "pre_processing", recorded_pre_processing)
        (jloss, (jmetrics, draws)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(model["params"])
        draws = [np.asarray(d) for d in draws]
        tmodel = port_model(cfg, model["params"])
        queue = inject_uniforms(mp, draws)
        with counted_map_encodes() as n:
            loss, metrics = TO.training_step(port_cfg(cfg), tmodel, TP.to_torch(batch, "cpu"),
                                             torch.Generator().manual_seed(3))
        loss.backward()
    finally:
        mp.undo()
    return dict(jloss=jloss, jmetrics=jmetrics, jgrads=flat_flax(jgrads), loss=loss, metrics=metrics,
                tmodel=tmodel, map_encodes=n[0], left=queue, n_draws=len(draws))


def test_augmented_training_step_loss_and_metrics_match_jax(step):
    s = step
    assert s["left"] == [] and s["n_draws"] == 9  # 3 input masks, yaw, offset, 4 latent-view masks
    assert s["map_encodes"] == 3
    np.testing.assert_allclose(s["loss"].item(), float(s["jloss"]), **TOL)
    assert s["metrics"].keys() == s["jmetrics"].keys()
    for k, v in s["jmetrics"].items():
        np.testing.assert_allclose(s["metrics"][k].detach().numpy(), np.asarray(v), err_msg=k, **TOL)


def test_augmented_training_step_gradients_match_jax(step):
    s = step
    paths = flax_paths(s["tmodel"])
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in s["tmodel"].named_parameters()}
    scale = max(np.linalg.norm(g) for g in s["jgrads"].values())
    bad = {}
    for name, (path, transposed) in paths.items():
        t = grads[name].numpy()
        j = s["jgrads"][path].T if transposed else s["jgrads"][path]
        err, ref = np.linalg.norm(t - j), np.linalg.norm(j)
        if err > GRAD_RTOL * max(ref, 1e-3 * scale):
            bad[path] = (err, ref)
    assert not bad, bad
    assert grads["map_encoder.densetnt.wq"].abs().sum() > 0
