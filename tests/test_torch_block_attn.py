"""K6, the hybrid node encoder's attention core, on the CPU against the JAX
package.

`block_attn_core_plain` against the Pallas `_block_attn_kernel` run in
interpret mode, and the port's `FusedNodeEncoder.encode_pooled_hybrid`
against the JAX `encode_pooled_hybrid` (interpret mode, as
tests/test_node_encoder.py runs it), at D = 16, H = 2, L = 3, N = 5, BP = 16
with one all-invalid polyline. The TPU kernel lifts the mask of a polyline
without a valid node over its whole 8-polyline block, the port over the
polyline's own nodes: those rows are discarded by the caller, so only the
live rows are compared (the dead ones must be finite). Tolerance atol =
rtol = 1e-5 (fp32, ulp-level summation-order differences). The map
encoder's switches: "hybrid" and "fused" give the same map features,
`kernel_matmul_bf16` raises.
"""
import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from trafficbots_tpu.ops import node_encoder as jne  # noqa: E402
from trafficbots_tpu.config import config_to_dict  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu_torch.data.preprocessing import pre_processing, to_torch  # noqa: E402
from trafficbots_tpu_torch.ops import block_attn as tba  # noqa: E402
from trafficbots_tpu_torch.ops import node_encoder as tne  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402

from tiny import tiny_batch, tiny_config  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
D, H, L, N, BP = 16, 2, 3, 5, 16


def inputs(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(BP, N, D)).astype(np.float32)
    valid = rs.rand(BP, N) < 0.7
    valid[0] = False  # an all-invalid polyline
    valid[1] = True
    valid[9] = [True] + [False] * (N - 1)  # one valid node
    return np.where(valid[..., None], x, 0.0).astype(np.float32), valid


def jax_block_attn(q, k, v, valid, n_head, blk=8):
    """The Pallas kernel of the JAX package, called as encode_pooled_hybrid
    calls it, in interpret mode."""
    spec = pl.BlockSpec((blk, N, D), lambda b: (b, 0, 0))
    return pl.pallas_call(
        functools.partial(jne._block_attn_kernel, n_head=n_head, n_node=N, blk=blk, bf16=False),
        out_shape=jax.ShapeDtypeStruct((BP, N, D), jnp.float32), grid=(BP // blk,),
        in_specs=[spec, spec, spec, pl.BlockSpec((blk, N, 1), lambda b: (b, 0, 0))],
        out_specs=spec, interpret=True,
    )(q, k, v, valid.astype(jnp.float32)[..., None])


@pytest.mark.parametrize("n_head", [1, 2, 4])
def test_k6_plain_matches_jax_kernel_interpret(n_head):
    _, valid = inputs(1)
    rs = np.random.RandomState(2)
    q, k, v = (rs.normal(size=(BP, N, D)).astype(np.float32) for _ in range(3))
    j = np.asarray(jax_block_attn(*map(jnp.asarray, (q, k, v, valid)), n_head))
    t = tba.block_attn_core_plain(*map(torch.from_numpy, (q, k, v, valid)), n_head).numpy()
    live = valid.any(-1)
    np.testing.assert_allclose(t[live], j[live], **TOL)
    assert np.isfinite(t).all()


def test_k6_wrapper_on_cpu_is_the_plain_version():
    _, valid = inputs(3)
    q, k, v = (torch.randn(BP, N, D, generator=torch.Generator().manual_seed(i)) for i in range(3))
    before = tba.LAUNCHES
    out = tba.block_attn_core(q, k, v, torch.from_numpy(valid), H)
    assert tba.LAUNCHES == before
    assert torch.equal(out, tba.block_attn_core_plain(q, k, v, torch.from_numpy(valid), H))


@pytest.fixture(scope="module")
def encoders():
    x, valid = inputs(4)
    jmod = jne.FusedNodeEncoder(d_model=D, n_head=H, n_layer=L, d_feedforward=D, dropout_p=0.0)
    p = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(valid))["params"]
    rs = np.random.RandomState(5)  # non-trivial LayerNorm and bias parameters
    p = {k: (v + 0.1 * rs.normal(size=v.shape).astype(np.float32) if v.ndim == 2 else v) for k, v in p.items()}
    j = np.asarray(jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid), method="encode_pooled_hybrid"))
    tmod = tne.FusedNodeEncoder(D, H, L, D)
    load_jax_params(tmod, jax.tree_util.tree_map(np.asarray, p))
    return x, valid, j, tmod


def test_hybrid_matches_jax_hybrid_interpret(encoders):
    x, valid, j, tmod = encoders
    with torch.no_grad():
        t = tmod.encode_pooled_hybrid(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    live = valid.any(-1)
    np.testing.assert_allclose(t[live], j[live], **TOL)
    assert (t[~live] == np.float32(tne.NEG)).all() and (j[~live] == np.float32(tne.NEG)).all()


def test_hybrid_equals_the_fused_plain_version(encoders):
    """The hybrid layout and the fused stack compute the same function."""
    x, valid, _, tmod = encoders
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    with torch.no_grad():
        hyb = tmod.encode_pooled_hybrid(xt, vt)
        torch.testing.assert_close(hyb, tmod.pooled_plain(xt, vt), **TOL)
        assert torch.equal(hyb, tmod.encode_pooled_hybrid(xt, vt, plain=True))


def test_k6_shared_memory_limit_matches_the_kernel():
    src = (Path(tba.__file__).parent.parent / "csrc" / "block_attn.cu").read_text()
    assert int(re.search(r"constexpr int MAXN = (\d+);", src).group(1)) == tba.KERNEL_MAX_NODES
    assert int(re.search(r"constexpr int MAXD = (\d+);", src).group(1)) == tba.KERNEL_MAX_D
    assert int(re.search(r"constexpr int SMEM_OPTIN = (\d+);", src).group(1)) == tba.SMEM_LIMIT
    assert tba.smem_bytes(tba.KERNEL_MAX_NODES, tba.KERNEL_MAX_D, 4) <= tba.SMEM_LIMIT


def map_cfg(**kw):
    cfg = config_from_dict(config_to_dict(tiny_config()))
    me = dataclasses.replace(cfg.model.map_encoder, **kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, map_encoder=me))


def test_map_encoder_honours_node_encoder_impl():
    """Eval: "hybrid" and "fused" give the same map features; another value
    raises; kernel_matmul_bf16 raises on both eval paths (the kernels are fp32)."""
    batch = tiny_batch(tiny_config(), n_scene=2, seed=0)
    feats = {}
    for impl in ("fused", "hybrid"):
        cfg = map_cfg(node_encoder_impl=impl)
        model = TO.make_model(cfg, device="cpu", seed=0)
        pb = pre_processing(to_torch(batch, "cpu"), cfg.model)
        with torch.no_grad():
            feats[impl] = TO.encode_episode_features(model, pb, views=("input",))["input"]["map_feature"]
        bf16 = TO.make_model(map_cfg(node_encoder_impl=impl, kernel_matmul_bf16=True), device="cpu", seed=0)
        with pytest.raises(NotImplementedError, match="kernel_matmul_bf16"), torch.no_grad():
            TO.encode_episode_features(bf16, pb, views=("input",))
    torch.testing.assert_close(feats["hybrid"], feats["fused"], **TOL)
    with pytest.raises(ValueError, match="node_encoder_impl"):
        TO.make_model(map_cfg(node_encoder_impl="xla"), device="cpu")
