"""Port geometry, pre-processing and distributions against the JAX package (CPU).

Inputs come from a numpy seed and go through both functions. Tolerance:
atol = rtol = 1e-5 in fp32 (sin/cos and atan2 may differ by an ulp between
the two CPU math libraries; everything else is the same arithmetic).
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import geometry as jg
from trafficbots_tpu import distributions as jd
from trafficbots_tpu.data import preprocessing as jp
from trafficbots_tpu_torch import geometry as tg
from trafficbots_tpu_torch import distributions as td
from trafficbots_tpu_torch.data import preprocessing as tp

from tiny import tiny_batch, tiny_config

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(kw or TOL))


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(0)


def test_cast_rad_sign_convention(rng):
    a = rng.uniform(-20, 20, size=(64,)).astype(np.float32)
    a[:4] = [-math.pi, math.pi, 3 * math.pi, -3 * math.pi]
    _close(tg.cast_rad(torch.from_numpy(a)), jg.cast_rad(jnp.asarray(a)))


def test_se2_transforms(rng):
    pos = rng.uniform(-100, 100, size=(3, 5, 7, 2)).astype(np.float32)
    lpos = rng.uniform(-100, 100, size=(3, 5, 1, 2)).astype(np.float32)
    yaw = rng.uniform(-4, 4, size=(3, 5)).astype(np.float32)
    T = torch.from_numpy
    rot_t, rot_j = tg.rad2rot(T(yaw)), jg.rad2rot(jnp.asarray(yaw))
    _close(rot_t, rot_j)
    _close(tg.pos2local(T(pos), T(lpos), rot_t), jg.pos2local(jnp.asarray(pos), jnp.asarray(lpos), rot_j), atol=1e-4)
    _close(tg.pos2global(T(pos), T(lpos), rot_t), jg.pos2global(jnp.asarray(pos), jnp.asarray(lpos), rot_j), atol=1e-4)
    _close(tg.dir2local(T(pos), rot_t), jg.dir2local(jnp.asarray(pos), rot_j), atol=1e-4)
    _close(tg.rad2local(T(yaw), T(yaw[:, 0])), jg.rad2local(jnp.asarray(yaw), jnp.asarray(yaw[:, 0])))


@pytest.mark.parametrize("mode", ["pe_xy_yaw", "pe_xy_dir", "pe_xy_unit_dir", "xy_dir", "mpa_pl"])
@pytest.mark.parametrize("dir_dim", [1, 2])
def test_pose_pe(rng, mode, dir_dim):
    xy = rng.uniform(-80, 80, size=(2, 6, 5, 2)).astype(np.float32)
    d = rng.uniform(-1, 1, size=(2, 6, 5, dir_dim)).astype(np.float32)
    for pe_dim in (32, 33):  # 33: the unpacked pe_xy_yaw branch
        t = tg.pose_pe(torch.from_numpy(xy), torch.from_numpy(d), mode, pe_dim)
        j = jg.pose_pe(jnp.asarray(xy), jnp.asarray(d), mode, pe_dim)
        assert t.shape == j.shape
        _close(t, j)
        assert tg.pose_pe_out_dim(mode, pe_dim) == jg.pose_pe_out_dim(mode, pe_dim)


def test_pre_processing_eval_views():
    cfg = tiny_config(n_step=91, time_step_end=90)
    b = tiny_batch(cfg, n_scene=2, seed=3)
    jb = jp.pre_processing({k: jnp.asarray(v) for k, v in b.items()}, cfg.model, training=False)
    tb = tp.pre_processing(tp.to_torch(b, "cpu"), cfg.model, training=False)
    prefixes = ("sc/", "gt/", "ref/", "input/", "latent_post/", "latent_prior/")
    keys = sorted(k for k in jb if k.startswith(prefixes))
    assert keys == sorted(k for k in tb if k.startswith(prefixes))
    for k in keys:
        j, t = np.asarray(jb[k]), tb[k].numpy()
        assert j.shape == t.shape, k
        if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=k)
        else:
            np.testing.assert_allclose(t, j, err_msg=k, **TOL)
    assert tp.extract(tb, "input").keys() == jp.extract(jb, "input").keys()


def test_agent_attr_and_pe():
    cfg = tiny_config()
    rs = np.random.RandomState(1)
    args = [rs.uniform(-30, 30, size=(2, 4, n)).astype(np.float32) for n in (2, 1, 2, 1, 1, 1, 3)]
    atype = np.eye(3, dtype=bool)[rs.randint(0, 3, size=(2, 4))]
    ta, tpe = tp.agent_attr_and_pe(cfg.model, *map(torch.from_numpy, args), torch.from_numpy(atype))
    ja, jpe = jp.agent_attr_and_pe(cfg.model, *map(jnp.asarray, args), jnp.asarray(atype))
    _close(ta, ja)
    _close(tpe, jpe)


def test_training_branches_not_ported():
    cfg = tiny_config()
    b = tp.to_torch(tiny_batch(cfg), "cpu")
    from dataclasses import replace

    with pytest.raises(NotImplementedError, match="training slice"):
        tp.pre_processing(b, replace(cfg.model, dropout_p_history=0.1), training=True)


def test_diag_gaussian(rng):
    mean = rng.normal(size=(3, 4, 8)).astype(np.float32)
    log_std = rng.normal(size=(3, 4, 8)).astype(np.float32) * 0.3
    x = rng.normal(size=(3, 4, 8)).astype(np.float32)
    t = td.DiagGaussian(torch.from_numpy(mean), torch.from_numpy(log_std))
    j = jd.DiagGaussian(jnp.asarray(mean), jnp.asarray(log_std))
    _close(t.sample(None, True), j.sample(jax.random.PRNGKey(0), True))
    _close(t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)))
    _close(t.stddev, j.stddev)
    r = t.repeat(3, 0)
    _close(r.mean, j.repeat(3, 0).mean)
    # a per-row deterministic mask keeps the mean on those rows only
    det = torch.tensor([True, False, True])
    s = t.sample(torch.Generator().manual_seed(0), det)
    assert torch.equal(s[0], t.mean[0]) and not torch.equal(s[1], t.mean[1])


def test_diag_gaussian_sampling_statistics():
    """Stochastic samples cannot match jax.random bit for bit; their
    distribution must: mean and std of 200k draws within 1%."""
    t = td.DiagGaussian(torch.tensor([[1.5, -2.0]]), torch.log(torch.tensor([[0.5, 2.0]])))
    g = torch.Generator().manual_seed(0)
    s = torch.stack([t.sample(g, False)[0] for _ in range(1)] + [t.mean[0]])
    draws = t.repeat(200_000, 0).sample(g, False)
    np.testing.assert_allclose(draws.mean(0).numpy(), [1.5, -2.0], atol=0.02)
    np.testing.assert_allclose(draws.std(0).numpy(), [0.5, 2.0], rtol=0.01)
    assert s.shape == (2, 2)


def test_dummy_latent():
    z = td.DummyLatent(torch.ones(2, 3, 4))
    assert torch.equal(z.sample(None, False), torch.zeros(2, 3, 4))
    assert torch.equal(z.log_prob(torch.ones(2, 3, 4)), torch.zeros(2, 3))
