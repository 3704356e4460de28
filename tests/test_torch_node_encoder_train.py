"""K4's plain version (`ops.node_encoder_train.node_encoder_train_plain`)
against the JAX package's `node_encoder_train_pooled`, on the CPU.

At p = 0 the JAX kernels run in Pallas interpret mode: the pooled forward,
dx and all 18 weight gradients from `jax.vjp` of the custom VJP (the
hand-derived backward kernel), with an all-invalid polyline and a polyline
whose nodes tie in the max (the cotangent splits evenly among ties, as
JAX's reduce_max VJP does). With dropout live (p = 0.1), JAX's
`reference_forward_with_masks` (the kernels' math with masks supplied)
under `jax.grad`, fed the port's per-polyline masks on the block diagonal
of its [G, L, H, R, R] layout. Tolerance: atol = rtol = 1e-5 on the
forward; 2e-5 on the gradients (three layers of 16-wide sums over 16
polylines, in another order).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu.ops import node_encoder_train as jnt  # noqa: E402
from trafficbots_tpu.ops.node_encoder import FusedNodeEncoder as JNodeEncoder  # noqa: E402
from trafficbots_tpu_torch.ops import node_encoder as tne  # noqa: E402
from trafficbots_tpu_torch.ops import node_encoder_train as tnt  # noqa: E402
from trafficbots_tpu_torch.ops.dropout import dropout_mask_plain  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

D, H, L, N, BP, BLK = 16, 2, 3, 5, 16, 8
TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def case():
    rs = np.random.RandomState(0)
    x = rs.normal(size=(BP, N, D)).astype(np.float32)
    valid = rs.rand(BP, N) < 0.8
    valid[0] = False  # an all-invalid polyline
    valid[1] = True
    x[1, 3] = x[1, 2]  # two equal nodes: they tie in every column of the max at p = 0
    x = np.where(valid[..., None], x, 0.0).astype(np.float32)
    jmod = JNodeEncoder(d_model=D, n_head=H, n_layer=L, d_feedforward=D, dropout_p=0.0)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(valid))["params"]
    params = {k: np.asarray(v) + (0.1 * rs.normal(size=v.shape).astype(np.float32) if v.ndim == 2 else 0)
              for k, v in params.items()}  # non-trivial LayerNorm scales and biases
    g = rs.normal(size=(BP, D)).astype(np.float32)
    tmod = tne.FusedNodeEncoder(D, H, L, D)
    load_jax_params(tmod, params)
    return dict(x=x, valid=valid, params=params, g=g, tmod=tmod)


def port(case, p, seed):
    tmod = case["tmod"]
    tmod.zero_grad()
    x = torch.from_numpy(case["x"]).requires_grad_()
    valid = torch.from_numpy(case["valid"])
    out = tnt.node_encoder_train_plain(tmod, x, valid, p, seed)
    pl = valid.any(-1)
    torch.where(pl[:, None], out, torch.zeros_like(out)).backward(torch.from_numpy(case["g"]))
    return out.detach().numpy(), x.grad.numpy(), [getattr(tmod, n).grad.numpy() for n in tne.W_NAMES]


def jax_loss(fwd, case):
    pl = jnp.asarray(case["valid"].any(-1))

    def loss(x, weights):
        pooled = fwd(x, weights)
        return jnp.sum(jnp.where(pl[:, None], pooled, 0.0) * jnp.asarray(case["g"])), pooled

    return loss


def check(case, fwd, p, seed):
    weights = tuple(jnp.asarray(case["params"][n]) for n in jnt.W_NAMES)
    (_, jout), (jdx, jdw) = jax.value_and_grad(jax_loss(fwd, case), argnums=(0, 1), has_aux=True)(
        jnp.asarray(case["x"]), weights)
    out, dx, dw = port(case, p, seed)
    pl = case["valid"].any(-1)
    np.testing.assert_allclose(out[pl], np.asarray(jout)[pl], **TOL)
    assert (out[~pl] == np.float32(tne.NEG)).all()
    np.testing.assert_allclose(dx, np.asarray(jdx), err_msg="dx", **GTOL)
    for name, t, j in zip(jnt.W_NAMES, dw, jdw):
        np.testing.assert_allclose(t, np.asarray(j), err_msg=name, **GTOL)
    return out, dx


def test_plain_matches_jax_kernels_at_p0(case):
    vf = jnp.asarray(case["valid"].astype(np.float32)[..., None])

    def fwd(x, weights):
        return jnt.node_encoder_train_pooled(x, vf, weights, jnp.zeros((), jnp.int32), L, H, BLK, 0.0, True)

    _, dx = check(case, fwd, 0.0, 0)
    np.testing.assert_array_equal(dx[1, 2], dx[1, 3])  # the tied nodes share the cotangent
    assert (dx[0] == 0).all()


def test_tied_max_splits_the_cotangent_evenly():
    x = torch.tensor([[[1.0, 5.0], [1.0, 2.0], [0.5, 5.0]]], requires_grad=True)
    valid = torch.tensor([[True, True, True]])
    tnt.max_pool_ties(x, valid).backward(torch.tensor([[6.0, 4.0]]))
    assert x.grad.tolist() == [[[3.0, 2.0], [3.0, 0.0], [0.0, 2.0]]]


def test_plain_with_dropout_matches_jax_on_the_same_masks(case):
    p, seed = 0.1, 2**45 + 3
    R, G = BLK * N, BP // BLK
    attn = np.ones((G, L, H, R, R), np.float32)  # off the block diagonal: cross-polyline weights are 0
    m1, m2, m3 = (np.empty((G, L, R, D), np.float32) for _ in range(3))
    for l in range(L):
        a = dropout_mask_plain((BP, H, N, N), seed, 4 * l, p).numpy()
        for gi in range(G):
            for i in range(BLK):
                attn[gi, l, :, i * N:(i + 1) * N, i * N:(i + 1) * N] = a[gi * BLK + i]
        for k, m in ((1, m1), (2, m2), (3, m3)):
            m[:, l] = dropout_mask_plain((BP, N, D), seed, 4 * l + k, p).numpy().reshape(G, R, D)
    masks = tuple(map(jnp.asarray, (attn, m1, m2, m3)))
    vf = jnp.asarray(case["valid"].astype(np.float32)[..., None])

    def fwd(x, weights):
        return jnt.reference_forward_with_masks(x, vf, weights, masks, L, H, BLK)

    check(case, fwd, p, seed)


def test_wrapper_on_cpu_is_the_plain_version(case):
    x, valid = torch.from_numpy(case["x"]), torch.from_numpy(case["valid"])
    before = (tnt.LAUNCHES_FWD, tnt.LAUNCHES_BWD)
    with torch.no_grad():
        out = tnt.node_encoder_train(case["tmod"], x, valid, 0.1, 9)
        assert torch.equal(out, tnt.node_encoder_train_plain(case["tmod"], x, valid, 0.1, 9))
    assert (tnt.LAUNCHES_FWD, tnt.LAUNCHES_BWD) == before
