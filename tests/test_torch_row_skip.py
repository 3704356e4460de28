"""The dead-query-row skip (`model.attn_row_block >= 0` in eval, always in
training) against the JAX package, on the CPU.

- `ops.fused_attention.row_live`, the port's copy, against JAX's
  `ops/kernel_common.row_live` on random masks.
- K1's plain version with `src_invalid` against the JAX
  `fused_attention_core` in Pallas interpret mode at `row_block` 0, 16 and
  -1 (the shapes of tests/test_fused_attention.py's skip test), on fp32 and
  on bf16 q/k/v. The JAX kernel zeroes whole dead blocks of its grid and
  computes the dead rows of a partly live block; the port zeroes every dead
  row. So live rows are held at tests/test_torch_kernels.py's tolerances
  (atol = rtol = 1e-5 in fp32, a relative norm error of 1e-4 in bf16),
  every row JAX writes as 0 is 0 in the port, and every dead row is 0.
- The eval rollout of a narrow config whose rollout as2pl (32 agents, 24
  of them padding, over 64 polylines) and latent as2pl are K1 sites: at
  `attn_row_block` 0 and 16 bitwise the rollout at -1 (every dead row is
  zeroed before any consumer, and every later operation is row-wise), and
  against JAX's eval program (one jit compile, shared by a module-scoped
  fixture) within tests/test_torch_slice.py's holds: booleans exactly,
  log-probs within 1e-5, preds within 1e-4 m over the first 20 steps and
  1e-3 m over the rest (30 steps here). On the CPU JAX runs its XLA
  attention, which no row block changes.
- The other entry points on that config at `attn_row_block = 0`, in fp32
  and under `precision="bf16"`: one `Validator.step` bitwise the step at
  -1 on the same generator seed (the reactive replay, the K joint futures
  and their scores), one `make_train_step` update finite, and `run.py`
  fit with `model.attn_row_block=0`.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.data.preprocessing import pre_processing as j_pre  # noqa: E402
from trafficbots_tpu.ops import fused_attention as jfa  # noqa: E402
from trafficbots_tpu.ops.kernel_common import row_live as j_row_live  # noqa: E402
from trafficbots_tpu.sim.teacher_forcing import teacher_forcing_mask as j_tf_mask  # noqa: E402
from trafficbots_tpu_torch import evaluation_loop as EL  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch import run as TR  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu_torch.models import modules as TM  # noqa: E402
from trafficbots_tpu_torch.ops import fused_attention as tfa  # noqa: E402
from trafficbots_tpu_torch.training import train as TT  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

from trafficbots_tpu.config import config_to_dict  # noqa: E402
from test_torch_cli import TINY  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_RTOL = 1e-4
HELD_STEPS = 20  # preds within 1e-4 m over these, 1e-3 m over the whole 30 (test_torch_slice.py)


def test_row_live_matches_jax():
    rs = np.random.RandomState(0)
    invalid = rs.rand(3, 40, 50) < 0.9
    invalid[0, :5] = True  # rows with no allowed target
    src_invalid = rs.rand(3, 40) < 0.3
    for src in (None, src_invalid):
        j = np.asarray(j_row_live(jnp.asarray(invalid), None if src is None else jnp.asarray(src)))
        t = tfa.row_live(torch.from_numpy(invalid), None if src is None else torch.from_numpy(src))
        np.testing.assert_array_equal(t.numpy(), j)


def skip_inputs(seed=7, B=2, S=64, T=32, D=16):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.normal(size=s).astype(np.float32) for s in ((B, S, D), (B, T, D), (B, T, D)))
    invalid = rs.rand(B, S, T) < 0.3
    invalid[0, 2] = True  # a live-prefix row with no allowed target
    src_invalid = np.arange(S)[None, :] >= np.array([[16], [40]])  # live prefixes
    return q, k, v, invalid, src_invalid


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("row_block", [0, 16, -1])
def test_k1_plain_with_src_invalid_matches_jax_kernel(row_block, bf16):
    q, k, v, invalid, src_invalid = skip_inputs()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if bf16:
        tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    j = jfa.fused_attention_core(*(jnp.asarray(t.float().numpy()).astype(jdt) for t in (tq, tk, tv)),
                                 jnp.asarray(invalid), jnp.asarray(src_invalid), 2, row_block)
    t = tfa.attention_core_plain(tq, tk, tv, torch.from_numpy(invalid), 2, torch.from_numpy(src_invalid))
    assert t.dtype == tq.dtype
    jf, tf = np.asarray(j.astype(jnp.float32)), t.float().numpy()
    live = tfa.row_live(torch.from_numpy(invalid), torch.from_numpy(src_invalid)).numpy()
    if bf16:
        assert rel_norm(tf[live], jf[live]) <= BF16_RTOL
    else:
        np.testing.assert_allclose(tf[live], jf[live], **TOL)
    assert (tf[(jf == 0).all(-1)] == 0).all()  # every row JAX writes as 0
    assert (tf[~live] == 0).all()  # every dead row
    if row_block == 16:  # the TPU's own zeros: rows 48.. are dead in both scenes of its one scene group
        assert (jf[:, 48:] == 0).all()


def skip_config(row_block: int):
    """A narrow config whose rollout as2pl (S = 32 agents, T = 64 polylines)
    and latent as2pl (S = 30 x 32) are K1 sites; synthetic data leaves 24
    agents and 56 polylines as padding."""
    cfg = tiny_config(n_step=31, time_step_end=30)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_agent=32, n_pl=64),
                              model=dataclasses.replace(cfg.model, attn_row_block=row_block))
    return cfg


@pytest.fixture(scope="module")
def rollouts():
    """JAX's eval program (bench.py's eval_rollout) under one jax.jit, and
    the port's eval_rollout at attn_row_block -1, 0 and 16 on the same
    weights and batch, with the K1 calls that carried `src_invalid`
    counted."""
    cfg = skip_config(-1)
    batch = tiny_batch(cfg, n_scene=2, seed=0)
    assert (~batch["agent/valid"].any(1)).sum() > 0  # padding agents
    jm, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)

    def ev(params, b):
        pb = j_pre(b, cfg.model, training=False)
        feats = JO.encode_episode_features(jm, params, pb, training=False, key=None)
        goal, goal_valid = JO.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
        latent = jm.apply({"params": params}, method="latent", posterior=True, **feats["latent_post"])
        mask_tf = j_tf_mask(JO.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])
        return JO.reactive_replay(cfg, jm, params, pb, feats["input"], latent, goal, goal_valid, mask_tf,
                                  jax.random.PRNGKey(1), deterministic_latent=True, deterministic_action=True)

    jbuf = jax.jit(ev)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    params_np = jax.tree_util.tree_map(np.asarray, params)
    port, skips = {}, {}
    core = TM.fused_attention_core

    def counted(*a, src_invalid=None, **kw):
        skips[rb] += src_invalid is not None
        return core(*a, src_invalid=src_invalid, **kw)

    TM.fused_attention_core = counted
    try:
        for rb in (-1, 0, 16):
            skips[rb] = 0
            pcfg = config_from_dict(config_to_dict(skip_config(rb)))
            model = TO.make_model(pcfg, device="cpu")
            load_jax_params(model, params_np)
            port[rb] = TO.eval_rollout(pcfg, model, batch, device="cpu")
    finally:
        TM.fused_attention_core = core
    return jbuf, port, skips


@pytest.mark.parametrize("row_block", [0, 16])
def test_eval_rollout_with_the_skip_is_bitwise_the_rollout_without(rollouts, row_block):
    _, port, skips = rollouts
    # the latent as2pl once, the rollout as2pl at each of the 30 steps
    assert (skips[-1], skips[row_block]) == (0, 31)
    a, b = port[row_block], port[-1]
    for name in ("preds", "valid", "override_masks", "diffbar_rewards", "diffbar_rewards_valid", "latent_log_probs",
                 "action_log_probs"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for k, v in b.violations.items():
        assert torch.equal(a.violations[k], v), k


def test_eval_rollout_with_the_skip_matches_jax(rollouts):
    jbuf, port, _ = rollouts
    t = port[0]
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(jbuf.valid))
    np.testing.assert_array_equal(t.override_masks.numpy(), np.asarray(jbuf.override_masks))
    for k, v in jbuf.violations.items():
        np.testing.assert_array_equal(t.violations[k].numpy(), np.asarray(v), err_msg=k)
    tp, jp = t.preds.numpy(), np.asarray(jbuf.preds)
    assert np.isfinite(tp).all()
    np.testing.assert_allclose(tp[:, :, :HELD_STEPS], jp[:, :, :HELD_STEPS], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp, jp, atol=1e-3, rtol=0)
    np.testing.assert_allclose(t.latent_log_probs.numpy(), np.asarray(jbuf.latent_log_probs), **TOL)
    np.testing.assert_allclose(t.action_log_probs.numpy(), np.asarray(jbuf.action_log_probs), **TOL)


def tensors(x):
    """Every tensor of a nested output, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors(v)]
    return [t for v in getattr(x, "__dict__", {}).values() for t in tensors(v)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_validator_and_training_step_with_the_skip(precision):
    batch = tiny_batch(skip_config(-1), n_scene=2, seed=0)
    outs = {}
    for rb in (-1, 0):
        cfg = dataclasses.replace(config_from_dict(config_to_dict(skip_config(rb))), precision=precision)
        model = TO.make_model(cfg, device="cpu", seed=0)
        model.eval()
        outs[rb] = tensors(EL.Validator(cfg, model, device="cpu").step(batch, torch.Generator().manual_seed(2)))
    assert len(outs[0]) == len(outs[-1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[-1]))
    metrics = TT.make_train_step(cfg, model, TT.make_optimizer(cfg, model))(batch, seed=1)
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())


def test_run_fit_with_the_skip(tmp_path):
    out = TR.main(["action=fit", f"run_dir={tmp_path}", "n_epochs=1", "n_video_batch=0"] + TINY
                  + ["data.n_agent=32", "data.n_pl=64", "model.attn_row_block=0"])
    snap = TR.parse_args([f"run_dir={tmp_path}", "resume=last", "device=cpu"])[1]
    assert snap.model.attn_row_block == 0 and snap.data.n_agent == 32
    assert out is not None
