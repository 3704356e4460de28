"""K3's plain version (`ops.attention_train.attention_train_plain`) against the
JAX package's `fused_attention_train`, on the CPU.

At p = 0 the JAX kernels run in Pallas interpret mode, as
tests/test_attention_train.py runs them: the forward, and dq/dk/dv from
`jax.vjp` of the custom VJP (the backward kernels), on a dense shape and on
a query-blocked one (where `_pick_block` gives None), with an all-masked row
and dead query rows (`src_invalid`, whose blocks the TPU kernels skip; the
port's plain version takes the same `src_invalid` and zeroes every dead
row, which the JAX kernels do only for whole dead blocks). With
dropout live (p = 0.1) the TPU's bits cannot be reproduced, so the port's
masks are fed into a JAX softmax-times-mask expression written here, and the
forward and gradients compared. Tolerance: atol = rtol = 1e-5 (fp32; the
sums run in another order), 2e-5 on the query-blocked gradients (sums over
768 query rows).
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu.ops import attention_train as jat  # noqa: E402
from trafficbots_tpu_torch.ops import attention_train as tat  # noqa: E402
from trafficbots_tpu_torch.ops.dropout import dropout_mask_plain  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def inputs(B, S, T, D, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.normal(size=s).astype(np.float32) for s in ((B, S, D), (B, T, D), (B, T, D)))
    invalid = rs.rand(B, S, T) < 0.3
    invalid[0, 3] = True  # an all-masked row
    g = rs.normal(size=(B, S, D)).astype(np.float32)
    return q, k, v, invalid, g


def port(q, k, v, invalid, g, n_head, p=0.0, seed=0, site=0, src_invalid=None):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    src = None if src_invalid is None else torch.from_numpy(src_invalid)
    out = tat.attention_train_plain(tq, tk, tv, torch.from_numpy(invalid), n_head, p, seed, site, src_invalid=src)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


@pytest.mark.parametrize("B,S,T,D,H,qb", [(4, 40, 288, 64, 4, False), (2, 768, 1536, 64, 4, True)])
def test_plain_matches_jax_kernels_at_p0(B, S, T, D, H, qb):
    q, k, v, invalid, g = inputs(B, S, T, D, seed=S)
    assert (jat._pick_block(B, S, T, D) is None) == qb
    src_invalid = np.zeros((B, S), bool)
    src_invalid[0, : (256 if qb else 8)] = True  # dead rows (a whole query block when qb)
    g = np.where(src_invalid[..., None], 0.0, g).astype(np.float32)  # callers zero dead rows

    def f(q_, k_, v_):
        return jat.fused_attention_train(q_, k_, v_, jnp.asarray(invalid), jnp.zeros((), jnp.int32), H, 0.0,
                                         jnp.asarray(src_invalid))

    jout, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    out, *grads = port(q, k, v, invalid, g, H, src_invalid=src_invalid)
    live = ~src_invalid
    np.testing.assert_allclose(out[live], np.asarray(jout)[live], **TOL)
    assert (out[0, 3] == 0).all() and (out[src_invalid] == 0).all()  # every dead row
    gtol = dict(atol=2e-5, rtol=2e-5) if qb else TOL
    for name, t, j in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(t, np.asarray(j), err_msg=f"d{name}", **gtol)


def masked_attention_jax(q, k, v, invalid, mask, n_head):
    """softmax(q kᵀ / sqrt(dh), masked) ⊙ mask, then v: the all-masked row
    guard as the JAX modules write it."""
    B, S, D = q.shape
    T = k.shape[1]
    dh = D // n_head
    qh, kh, vh = q.reshape(B, S, n_head, dh), k.reshape(B, T, n_head, dh), v.reshape(B, T, n_head, dh)
    logits = jnp.einsum("bshd,bthd->bhst", qh, kh)
    no_valid = jnp.all(invalid, axis=-1)
    use_mask = invalid & ~no_valid[..., None]
    logits = jnp.where(use_mask[:, None], -jnp.inf, logits)
    attn = jax.nn.softmax(logits / math.sqrt(dh), axis=-1) * mask
    out = jnp.einsum("bhst,bthd->bshd", attn, vh).reshape(B, S, D)
    return jnp.where(no_valid[..., None], 0.0, out)


def test_plain_with_dropout_matches_jax_on_the_same_masks():
    B, S, T, D, H = 3, 33, 260, 64, 2
    q, k, v, invalid, g = inputs(B, S, T, D, seed=1)
    invalid[1] = True  # a scene with every target masked
    seed, site, p = 2**50 + 7, 3, 0.1
    mask = dropout_mask_plain((B, H, S, T), seed, site, p).numpy()
    assert 0 < (mask == 0).mean() < 0.2
    jout, vjp = jax.vjp(lambda a, b, c: masked_attention_jax(a, b, c, jnp.asarray(invalid), jnp.asarray(mask), H),
                        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    out, *grads = port(q, k, v, invalid, g, H, p, seed, site)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    assert (out[1] == 0).all() and (grads[0][1] == 0).all()
    for name, t, j in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(t, np.asarray(j), err_msg=f"d{name}", **TOL)


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v, invalid, _ = (torch.from_numpy(a) for a in inputs(2, 32, 256, 64, seed=2))
    before = (tat.LAUNCHES_FWD, tat.LAUNCHES_BWD)
    out = tat.attention_train(q, k, v, invalid, 2, 0.1, 5, 0)
    assert (tat.LAUNCHES_FWD, tat.LAUNCHES_BWD) == before
    assert torch.equal(out, tat.attention_train_plain(q, k, v, invalid, 2, 0.1, 5, 0))
