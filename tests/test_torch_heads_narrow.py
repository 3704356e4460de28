"""d_head 8 and 4 on the CPU: the port's plain attention cores and a short
eval rollout against the JAX package.

The kernels at d_head 8 and 4 (hidden 128 with 16 or 32 heads, hidden 64
with 8 or 16) are held against these plain versions in the emulator
(tests/test_torch_cuda_emu.py, tests/test_torch_cuda_emu_long.py) and on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 3a); here the
plain versions are held against JAX's:

- K1's `attention_core_plain` against `fused_attention_core` (Pallas
  interpret mode) at d_model 64 with 16 and 8 heads and at 128 with 32 and
  16, fp32 and on bf16 q/k/v (the TPU kernel's bf16 function), with an
  all-masked row and a scene whose targets are all masked;
- K3's `attention_train_plain` at p = 0 against `fused_attention_train`
  and its custom VJP (interpret mode): the output and dq, dk, dv, with dead
  query rows;
- an eval rollout (`orchestration.eval_rollout`, the posterior latent, GT
  goals) of the tests/tiny.py model at hidden 64 with 16 heads (d_head 4
  in every attention and in the node stack) against JAX's
  `reactive_replay` under one jit on the JAX params loaded into the port.

Tolerances are tests/test_torch_heads128.py's: the attention cores atol =
rtol = 1e-5 (fp32, the sums in another order; the bf16 function within a
relative norm error of 1e-4); the rollout's booleans exactly, its preds
within 1e-4 m over its 20 steps (10 teacher-forced, 10 closed-loop).
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
WIDTHS = [(64, 16), (64, 8), (128, 32), (128, 16)]  # (d_model, n_head): d_head 4 and 8


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("D,H", WIDTHS)
@pytest.mark.parametrize("bf16", [False, True])
def test_k1_plain_matches_jax_kernel_at_narrow_heads(D, H, bf16, record_property):
    q, k, v, invalid = attn_inputs(B=2, S=40, T=70, D=D, seed=D + H)
    if bf16:  # K1-bf16's function: bf16 q/k/v, weights rounded to bf16, a bf16 output
        qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
        j = jfa.fused_attention_core(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (qb, kb, vb)),
                                     jnp.asarray(invalid), None, H)
        t = tfa.attention_core_plain(qb, kb, vb, torch.from_numpy(invalid), H)
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        err = rel_norm(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
        record_property("rel_norm_err", err)
        assert err < 1e-4, err
    else:
        j = jfa.fused_attention_core(*map(jnp.asarray, (q, k, v, invalid)), None, H)
        t = tfa.attention_core_plain(*map(torch.from_numpy, (q, k, v, invalid)), H)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert (t[0, 2] == 0).all() and (t[1] == 0).all()


@pytest.mark.parametrize("D,H", WIDTHS)
def test_k3_plain_matches_jax_kernels_at_narrow_heads(D, H):
    B, S, T = 2, 40, 96
    rs = np.random.RandomState(D + H)
    q, k, v, g = (rs.normal(size=s).astype(np.float32) for s in ((B, S, D), (B, T, D), (B, T, D), (B, S, D)))
    invalid = rs.rand(B, S, T) < 0.3
    invalid[0, 3] = True  # an all-masked row
    src_invalid = np.zeros((B, S), bool)
    src_invalid[1, 32:] = True  # dead rows
    g = np.where(src_invalid[..., None], 0.0, g).astype(np.float32)  # callers zero dead rows

    def f(q_, k_, v_):
        return jat.fused_attention_train(q_, k_, v_, jnp.asarray(invalid), jnp.zeros((), jnp.int32), H, 0.0,
                                         jnp.asarray(src_invalid))

    jout, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tat.attention_train_plain(tq, tk, tv, torch.from_numpy(invalid), H, 0.0, 0, 0,
                                    src_invalid=torch.from_numpy(src_invalid))
    out.backward(torch.from_numpy(g))
    live = ~src_invalid
    np.testing.assert_allclose(out.detach().numpy()[live], np.asarray(jout)[live], **TOL)
    assert (out[0, 3] == 0).all() and (out[torch.from_numpy(src_invalid)] == 0).all()
    for name, t, j in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=f"d{name}", **TOL)


def test_eval_rollout_at_hidden_64_with_16_heads_matches_jax():
    """The tiny model at hidden 64 with 16 heads (d_head 4 in the
    attention layers and the node stack), 20 steps."""
    cfg = tiny_config(n_step=21, time_step_end=20)
    tf = dataclasses.replace(cfg.model.tf_cfg, d_model=64, n_head=16)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hidden_dim=64, tf_cfg=tf))
    batch = tiny_batch(cfg, n_scene=2, seed=3)
    jm, params = JO.init_params(cfg, jax.random.PRNGKey(0), batch)
    tmodel = TO.make_model(cfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    assert tmodel.map_encoder.densetnt.n_head == 16 and tmodel.map_encoder.densetnt.d_model == 64

    def ev(params, b):
        pb = j_pre(b, cfg.model, training=False)
        feats = JO.encode_episode_features(jm, params, pb, training=False, key=None)
        goal, goal_valid = JO.get_gt_goal(cfg, pb["input/agent_valid"], pb["gt/goal"], pb["gt/dest"])
        latent = jm.apply({"params": params}, method="latent", posterior=True, **feats["latent_post"])
        mask_tf = j_tf_mask(JO.tf_cfg_to_sim(cfg.tf_reactive_replay), pb["gt/valid"])
        return JO.reactive_replay(cfg, jm, params, pb, feats["input"], latent, goal, goal_valid, mask_tf,
                                  jax.random.PRNGKey(1), deterministic_latent=True, deterministic_action=True)

    jbuf = jax.jit(ev)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tbuf = TO.eval_rollout(cfg, tmodel, batch, device="cpu")
    assert tbuf.preds.shape == (2, 4, 20, 4) and np.isfinite(tbuf.preds.numpy()).all()
    np.testing.assert_array_equal(tbuf.valid.numpy(), np.asarray(jbuf.valid))
    np.testing.assert_array_equal(tbuf.override_masks.numpy(), np.asarray(jbuf.override_masks))
    np.testing.assert_allclose(tbuf.preds.numpy(), np.asarray(jbuf.preds), atol=1e-4, rtol=0)
