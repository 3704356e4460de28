"""The port's validation media against the JAX package's, on the CPU at the
tests/tiny.py widths (31 steps: a 30-step replay).

One JAX compile serves the file: `evaluation_loop._vis_device_step` under
one `jax.jit`, placed in the JAX package's own cache of the media program,
so its `render_validation_media` reuses it.

- The reactive replay with attention collection: validity exactly; the
  collected `attn_pl`, `attn_tl` and `attn_agent` ([B, A, S, n_tgt]) with
  their zeros exactly where JAX's are 0 (padded targets, invalid agents)
  and within atol 1e-5 over the first 20 steps; preds as the eval slice
  holds them (1e-4 m over 20 steps). The port's collecting replay gives
  the preds of its non-collecting one (the plain core either way on the
  CPU: bitwise).
- The device step's destination probabilities within 1e-5; its joint
  futures (JAX's draws injected through `distributions.standard_gumbel` /
  `standard_normal`, as tests/test_torch_validation.py does): validity
  exactly, preds within 1e-4 m over 20 steps, the scores within 1e-5.
- `render_validation_media` at `n_video_batch=1` writes JAX's file names,
  each file non-empty; with `_HAS_CV2` patched to False it returns [],
  says so, and does no device work.
"""
import dataclasses
import os
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("cv2")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import evaluation_loop as JE  # noqa: E402
from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.config import config_to_dict  # noqa: E402
from trafficbots_tpu_torch import evaluation_loop as TE  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import pre_processing, to_torch  # noqa: E402
from trafficbots_tpu_torch.sim.teacher_forcing import teacher_forcing_mask  # noqa: E402
from trafficbots_tpu_torch.utils import vis as TV  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

from test_torch_validation import inject, jax_draws  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_ATOL = 1e-5
HELD = 20  # steps held at 1e-4 m, as the eval slice holds them
KEY = 5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def media():
    jcfg = tiny_config()
    cfg = config_from_dict(config_to_dict(jcfg))
    batch = tiny_batch(jcfg, n_scene=2, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, list)}
    jmodel, params = JO.init_params(jcfg, jax.random.PRNGKey(0), jb)
    jfn = jax.jit(lambda p, b, k: JE._vis_device_step(jcfg, jmodel, p, b, k))
    JE._VIS_JIT_CACHE[jcfg] = (weakref.ref(jmodel), jfn)  # JAX's renderer reuses this program
    jout = jax.tree_util.tree_map(np.asarray, jfn(params, jb, jax.random.PRNGKey(KEY)))
    tmodel = TO.make_model(cfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    mp = pytest.MonkeyPatch()
    inject(mp, *jax_draws(jcfg, 2, jax.random.PRNGKey(KEY)))
    try:
        tout = TE._vis_device_step(cfg, tmodel, to_torch(batch, "cpu"), torch.Generator().manual_seed(0))
    finally:
        mp.undo()
    return dict(jcfg=jcfg, cfg=cfg, batch=batch, jmodel=jmodel, params=params, jout=jout, tout=tout,
                tmodel=tmodel)


def test_collecting_replay_matches_jax(media):
    t, j = media["tout"][0], media["jout"][0]
    np.testing.assert_array_equal(_np(t.valid), j.valid)
    np.testing.assert_allclose(_np(t.preds)[:, :, :HELD], j.preds[:, :, :HELD], atol=1e-4, rtol=0)
    assert t.step_future_start == j.step_future_start


@pytest.mark.parametrize("name", ["attn_pl", "attn_tl", "attn_agent"])
def test_collected_attention_matches_jax(media, name, record_property):
    t, j = _np(media["tout"][0].attn[name]), media["jout"][0].attn[name]
    cfg = media["cfg"]
    n_tgt = {"attn_pl": cfg.data.n_pl, "attn_tl": cfg.data.n_tl, "attn_agent": cfg.data.n_agent}[name]
    assert t.shape == j.shape == (2, cfg.data.n_agent, cfg.time_step_end, n_tgt)
    assert set(media["tout"][0].attn) == set(media["jout"][0].attn)
    np.testing.assert_array_equal(t[:, :, :HELD] == 0, j[:, :, :HELD] == 0)
    np.testing.assert_allclose(t[:, :, :HELD], j[:, :, :HELD], atol=ATTN_ATOL, rtol=0)
    # each valid row sums to 1 over its targets
    rows = j.sum(-1)
    assert np.all((np.abs(rows - 1) < 1e-5) | (rows == 0)) and (rows > 0).any()
    record_property(f"{name}_max_abs_diff_all_steps", float(np.abs(t - j).max()))


def test_collecting_replay_equals_the_plain_replay(media):
    """The port's replay with and without collection: the same preds and
    validity (on the CPU both run the plain attention core)."""
    cfg, model = media["cfg"], media["tmodel"]
    pb = pre_processing(to_torch(media["batch"], "cpu"), cfg.model, n_step_hist=cfg.time_step_current + 1,
                        training=False)
    with torch.no_grad():
        feats = TO.encode_episode_features(model, pb)
        goal, goal_valid = TO.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
        latent = model.latent(posterior=True, **feats["latent_post"])
        mask_tf = teacher_forcing_mask(TO.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])
        a, b = (TO.reactive_replay(cfg, model, pb, feats["input"], latent, goal, goal_valid, mask_tf,
                                   collect_attention=c) for c in (True, False))
    assert b.attn is None and set(a.attn) == {"attn_pl", "attn_tl", "attn_agent"}
    assert torch.equal(a.preds, b.preds) and torch.equal(a.valid, b.valid)
    assert torch.equal(a.preds, media["tout"][0].preds)


def test_dest_probs_match_jax(media):
    t, j = media["tout"][1], media["jout"][1]
    assert t.shape == j.shape == (2, media["cfg"].data.n_agent, media["cfg"].data.n_pl)
    np.testing.assert_allclose(_np(t), j, **TOL)


def test_joint_futures_and_scores_match_jax(media):
    (_, _, tbuf, tscore), (_, _, jbuf, jscore) = media["tout"], media["jout"]
    K = media["cfg"].n_joint_future
    assert tbuf.preds.shape == jbuf.preds.shape == (2, media["cfg"].data.n_agent, K, media["cfg"].time_step_end, 4)
    np.testing.assert_array_equal(_np(tbuf.valid), jbuf.valid)
    np.testing.assert_allclose(_np(tbuf.preds)[..., :HELD, :], jbuf.preds[..., :HELD, :], atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(tscore), jscore, **TOL)


def test_render_validation_media_writes_the_jax_file_names(media, tmp_path):
    jpaths = JE.render_validation_media(media["jcfg"], media["jmodel"], media["params"],
                                        lambda: iter([media["batch"]]), jax.random.PRNGKey(1),
                                        out_dir=str(tmp_path / "jax"), n_batches=1)
    tpaths = TE.render_validation_media(dataclasses.replace(media["cfg"], n_video_batch=1), media["tmodel"],
                                        lambda: iter([media["batch"]]), torch.Generator().manual_seed(1),
                                        out_dir=str(tmp_path / "port"))
    names = [os.path.basename(p) for p in tpaths]
    assert names == [os.path.basename(p) for p in jpaths]
    assert {"attn_pl_0-0.mp4", "dest_prob_0-1.png", "joint_future_K5_0-1.mp4", "reactive_replay_0-0.mp4"} <= set(names)
    assert all(p.startswith(str(tmp_path / "port")) and os.path.getsize(p) > 0 for p in tpaths)


def test_render_validation_media_without_cv2_writes_nothing(media, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(TV, "_HAS_CV2", False)

    def no_device_work(*a, **kw):
        raise AssertionError("the device step ran without cv2")

    monkeypatch.setattr(TE, "_vis_device_step", no_device_work)
    out = TE.render_validation_media(media["cfg"], media["tmodel"], lambda: iter([media["batch"]]),
                                     torch.Generator().manual_seed(1), out_dir=str(tmp_path))
    assert out == [] and os.listdir(tmp_path) == []
    assert "cv2 is not installed, no media written" in capsys.readouterr().out
