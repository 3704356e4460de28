"""The port's attention cores and eval slice against the JAX package past
1,024 keys (`data.n_pl` > 1,024), on the CPU.

- K1: `attention_core_plain` against the JAX `fused_attention_core` (its
  Pallas kernel in interpret mode, as tests/test_fused_attention.py runs
  it; its custom VJP) at T = 1,152 and 1,536: fp32 q/k/v forward within
  atol = rtol = 1e-5 and dq, dk, dv within a relative norm error of 1e-5
  of autograd through the plain version; with `src_invalid` (the skip) on
  the live rows; K1-bf16's function (bf16 q/k/v) within a relative norm
  error of 1e-4, as tests/test_torch_kernels.py holds it at 70 keys.
- K3: `attention_train_plain` against the JAX `fused_attention_train` at
  p = 0 (interpret mode), forward and `jax.vjp`, at the same T: forward
  within 1e-5, gradients within a relative norm error of 1e-5.
- The eval reactive replay at the tests/tiny.py widths with `n_pl` =
  1,152 (every attention over the map then has T = 1,152), 20 steps, as
  tests/test_torch_slice.py holds it: booleans exactly, log-probs within
  1e-5, preds within 1e-4 m. One JAX compile, shared by a module fixture.

On the card the kernels are held against these plain versions
(tests/test_torch_cuda_emu_long.py on the CPU emulator, tests/test_torch_cuda.py
and chip_smoke.py --long-map on an H100).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import orchestration as JO  # noqa: E402
from trafficbots_tpu.data.preprocessing import pre_processing as j_pre  # noqa: E402
from trafficbots_tpu.ops import attention_train as jat  # noqa: E402
from trafficbots_tpu.ops import fused_attention as jfa  # noqa: E402
from trafficbots_tpu.sim.teacher_forcing import teacher_forcing_mask as j_tf_mask  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.ops import attention_train as tat  # noqa: E402
from trafficbots_tpu_torch.ops import fused_attention as tfa  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

from test_torch_cuda import attn_inputs  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def plain_grads(fn, q, k, v, g):
    """fn's output and autograd's dq, dk, dv through it, as numpy."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


@pytest.mark.parametrize("T", [1152, 1536])
def test_k1_plain_matches_jax_at_long_T(T):
    B, S, D, H = 2, 40, 32, 2
    q, k, v, invalid = attn_inputs(B, S, T, D, seed=T)
    g = np.random.RandomState(T + 1).normal(size=(B, S, D)).astype(np.float32)
    jout, vjp = jax.vjp(lambda *a: jfa.fused_attention_core(*a, jnp.asarray(invalid), None, H),
                        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    inv = torch.from_numpy(invalid)
    out, *grads = plain_grads(lambda *a: tfa.attention_core_plain(*a, inv, H), q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    assert (out[0, 2] == 0).all() and (out[1] == 0).all()
    for name, t, j in zip("qkv", grads, jgrads):
        assert rel_norm(t, j) < 1e-5, f"d{name}"
    # the skip: rows 24.. of scene 0 dead (JAX computes a partly live block's dead rows; compare the live ones)
    src = np.zeros((B, S), bool)
    src[0, 24:] = True
    js = jfa.fused_attention_core(*map(jnp.asarray, (q, k, v, invalid, src)), H, 8)
    ts = tfa.attention_core_plain(*map(torch.from_numpy, (q, k, v)), inv, H, torch.from_numpy(src)).numpy()
    live = tfa.row_live(inv, torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(ts[live], np.asarray(js)[live], **TOL)
    assert (ts[~live] == 0).all()


@pytest.mark.parametrize("T", [1152, 1536])
def test_k1_bf16_plain_matches_jax_kernel_at_long_T(T, record_property):
    q, k, v, invalid = attn_inputs(2, 40, T, 64, seed=T + 2)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    j = jfa.fused_attention_core(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (qb, kb, vb)),
                                 jnp.asarray(invalid), None, 4)
    t = tfa.attention_core_plain(qb, kb, vb, torch.from_numpy(invalid), 4)
    err = rel_norm(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    record_property("k1_bf16_rel_norm_err", err)
    assert err <= 1e-4, err


@pytest.mark.parametrize("T", [1152, 1536])
def test_k3_plain_matches_jax_at_long_T(T):
    B, S, D, H = 2, 40, 32, 2
    q, k, v, invalid = attn_inputs(B, S, T, D, seed=T + 3)
    g = np.random.RandomState(T + 4).normal(size=(B, S, D)).astype(np.float32)

    def f(q_, k_, v_):
        return jat.fused_attention_train(q_, k_, v_, jnp.asarray(invalid), jnp.zeros((), jnp.int32), H, 0.0)

    jout, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    inv = torch.from_numpy(invalid)
    out, *grads = plain_grads(lambda *a: tat.attention_train_plain(*a, inv, H, 0.0, 0, 0), q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    for name, t, j in zip("qkv", grads, jgrads):
        assert rel_norm(t, j) < 1e-5, f"d{name}"


N_PL = 1152
N_STEP = 20


@pytest.fixture(scope="module")
def long_map_rollouts():
    """JAX's eval program (as tests/test_torch_slice.py's) under one
    jax.jit and the port's eval_rollout, on a 1,152-polyline map with 1,000
    valid polylines, the same weights."""
    cfg = tiny_config(n_step=N_STEP + 1, time_step_end=N_STEP)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_pl=N_PL))
    batch = tiny_batch(cfg, n_scene=2, seed=0, n_valid_pl=1000)
    jm, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)
    tmodel = TO.make_model(cfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))

    def ev(params, b):
        pb = j_pre(b, cfg.model, training=False)
        feats = JO.encode_episode_features(jm, params, pb, training=False, key=None)
        goal, goal_valid = JO.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
        latent = jm.apply({"params": params}, method="latent", posterior=True, **feats["latent_post"])
        mask_tf = j_tf_mask(JO.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])
        return JO.reactive_replay(cfg, jm, params, pb, feats["input"], latent, goal, goal_valid, mask_tf,
                                  jax.random.PRNGKey(1), deterministic_latent=True, deterministic_action=True)

    jbuf = jax.jit(ev)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return jbuf, TO.eval_rollout(cfg, tmodel, batch, device="cpu")


def test_long_map_eval_rollout_matches_jax(long_map_rollouts, record_property):
    jbuf, tbuf = long_map_rollouts
    assert tbuf.preds.shape == (2, 4, N_STEP, 4)
    np.testing.assert_array_equal(tbuf.valid.numpy(), np.asarray(jbuf.valid))
    np.testing.assert_array_equal(tbuf.override_masks.numpy(), np.asarray(jbuf.override_masks))
    for k, v in jbuf.violations.items():
        np.testing.assert_array_equal(tbuf.violations[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_allclose(tbuf.latent_log_probs.numpy(), np.asarray(jbuf.latent_log_probs), **TOL)
    np.testing.assert_allclose(tbuf.action_log_probs.numpy(), np.asarray(jbuf.action_log_probs), **TOL)
    tp, jp = tbuf.preds.numpy(), np.asarray(jbuf.preds)
    assert np.isfinite(tp).all()
    record_property("preds_max_abs_diff_m", float(np.abs(tp - jp).max()))
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
