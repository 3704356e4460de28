"""The two ported kernels' plain versions against the JAX kernels, and the
CUDA kernels against those plain versions.

CPU (here): `attention_core_plain` (K1) against the JAX package's
`fused_attention_core` run in Pallas interpret mode, and against
`_xla_reference` with a bf16 K/V cache; `FusedNodeEncoder.pooled_plain`
(K2) against the JAX `FusedNodeEncoder.encode_pooled` in interpret mode.
Tolerance: atol = rtol = 1e-5 (fp32; ulp-level summation-order
differences between the CPU backends). The bf16 variants of K1 and K2
against the same Pallas kernels on bf16 operands (`matmul_bf16=True` for
K2): a relative norm error of 1e-4, each measured value recorded as a
junit property.

On a CPU tensor the port's wrappers must take the plain version and count
no launch. The kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu.ops import fused_attention as jfa
from trafficbots_tpu.ops.node_encoder import FusedNodeEncoder as JNodeEncoder
from trafficbots_tpu_torch.ops import fused_attention as tfa
from trafficbots_tpu_torch.ops import node_encoder as tne
from trafficbots_tpu_torch.weights import load_jax_params

from test_torch_cuda import attn_inputs as _attn_inputs, node_inputs as _node_inputs
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_head", [1, 2, 4])
def test_k1_plain_matches_jax_kernel_interpret(n_head):
    q, k, v, invalid = _attn_inputs()
    j = jfa.fused_attention_core(*map(jnp.asarray, (q, k, v, invalid)), None, n_head)
    t = tfa.attention_core_plain(*map(torch.from_numpy, (q, k, v, invalid)), n_head)
    assert torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert (t[0, 2] == 0).all() and (t[1] == 0).all()


def test_k1_plain_bf16_kv_matches_xla_reference():
    """bf16 storage, fp32 from the load: the JAX XLA path up-casts K/V."""
    q, k, v, invalid = _attn_inputs(B=2, S=6, T=70, D=32, seed=1)
    kb, vb = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    j = jfa._xla_reference(jnp.asarray(q), kb.astype(jnp.float32), vb.astype(jnp.float32), jnp.asarray(invalid), 2)
    tk = torch.from_numpy(k).bfloat16()
    tv = torch.from_numpy(v).bfloat16()
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(kb.astype(jnp.float32)))
    t = tfa.attention_core_plain(torch.from_numpy(q), tk, tv, torch.from_numpy(invalid), 2)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_head", [2, 4])
def test_k1_bf16_plain_matches_jax_kernel_interpret(n_head, record_property):
    """K1's bf16 variant: `attention_core_plain` on bf16 q/k/v against the
    Pallas `_attn_kernel` on the same bf16 arrays in interpret mode (fp32
    logits and softmax, the weights rounded to bf16, a bf16 output). Held to
    a relative norm error of 1e-4; the few elements where the two CPU
    backends' fp32 rounding puts a weight or an output on the other side of
    a bf16 rounding boundary make up all of it (recorded; measured 0 at
    both head counts, with the logits scaled by the fp32 1/sqrt(d_head) as
    the kernel does)."""
    q, k, v, invalid = _attn_inputs(B=2, S=40, T=70, D=64, seed=5)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    j = jfa.fused_attention_core(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (qb, kb, vb)),
                                 jnp.asarray(invalid), None, n_head)
    assert j.dtype == jnp.bfloat16
    t = tfa.attention_core_plain(qb, kb, vb, torch.from_numpy(invalid), n_head)
    assert t.dtype == torch.bfloat16
    jf, tf = np.asarray(j.astype(jnp.float32)), t.float().numpy()
    err = rel_norm(tf, jf)
    record_property("k1_bf16_rel_norm_err", err)
    record_property("k1_bf16_elements_differing", int((tf != jf).sum()))
    assert err <= 1e-4, err
    live = ~invalid.all(-1)
    assert (tf[~live] == 0).all() and (jf[~live] == 0).all()
    # the variant's own function: not the fp32 path's
    assert rel_norm(tfa.attention_core_plain(*map(torch.from_numpy, (q, k, v, invalid)), n_head).numpy(), tf) > 1e-3


def test_k1_wrapper_on_cpu_is_the_plain_version():
    q, k, v, invalid = map(torch.from_numpy, _attn_inputs(B=2, S=32, T=64, D=32, seed=2))
    before = tfa.LAUNCHES
    out = tfa.fused_attention_core(q, k, v, invalid[:, :1].expand_as(invalid), 2)
    assert tfa.LAUNCHES == before
    assert torch.equal(out, tfa.attention_core_plain(q, k, v, invalid[:, :1].expand_as(invalid), 2))


@pytest.mark.parametrize("n_head,d_model,d_ff", [pytest.param(2, 64, 64, id="2"), pytest.param(4, 64, 64, id="4"),
                                                 pytest.param(2, 32, 64, id="2-d32-f64"),
                                                 pytest.param(4, 96, 160, id="4-d96-f160")])
def test_k2_plain_matches_jax_kernel_interpret(n_head, d_model, d_ff):
    """The last two cases: a rectangular FFN (w1 [32, 64], w2 [64, 32]),
    and widths that are not powers of two (d_model 96, d_ff 160)."""
    x, valid = _node_inputs(D=d_model)
    D = x.shape[-1]
    jmod = JNodeEncoder(d_model=D, n_head=n_head, n_layer=3, d_feedforward=d_ff, dropout_p=0.0, pipeline_blocks=2)
    p = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid))["params"]
    # non-trivial LayerNorm and bias parameters (init leaves them 1 and 0)
    rs = np.random.RandomState(4)
    p = {k: (v + 0.1 * rs.normal(size=v.shape).astype(np.float32) if v.ndim == 2 else v) for k, v in p.items()}
    j = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid), method="encode_pooled")
    tmod = tne.FusedNodeEncoder(D, n_head, 3, d_ff)
    load_jax_params(tmod, jax.tree_util.tree_map(np.asarray, p))
    with torch.no_grad():
        t = tmod.pooled_plain(torch.from_numpy(x), torch.from_numpy(valid))
    pv = valid.any(-1)
    np.testing.assert_allclose(t.numpy()[pv], np.asarray(j)[pv], **TOL)
    assert (t.numpy()[~pv] == np.float32(tne.NEG)).all()
    assert (np.asarray(j)[~pv] == np.float32(tne.NEG)).all()


def test_k2_bf16_plain_matches_jax_kernel_interpret(record_property):
    """K2's bf16 variant: `pooled_plain(bf16=True)` against the JAX
    `FusedNodeEncoder(matmul_bf16=True).encode_pooled` in interpret mode,
    within a relative norm error of 1e-4 over the live polylines
    (recorded; measured 7.8e-6)."""
    x, valid = _node_inputs()
    D = x.shape[-1]
    jmod = JNodeEncoder(d_model=D, n_head=4, n_layer=3, d_feedforward=D, dropout_p=0.0, pipeline_blocks=2,
                        matmul_bf16=True)
    p = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid))["params"]
    rs = np.random.RandomState(4)
    p = {k: (v + 0.1 * rs.normal(size=v.shape).astype(np.float32) if v.ndim == 2 else v) for k, v in p.items()}
    j = np.asarray(jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid), method="encode_pooled"))
    tmod = tne.FusedNodeEncoder(D, 4, 3, D)
    load_jax_params(tmod, jax.tree_util.tree_map(np.asarray, p))
    with torch.no_grad():
        t = tmod.pooled_plain(torch.from_numpy(x), torch.from_numpy(valid), bf16=True).numpy()
        t32 = tmod.pooled_plain(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    pv = valid.any(-1)
    err = rel_norm(t[pv], j[pv])
    record_property("k2_bf16_rel_norm_err", err)
    assert err <= 1e-4, err
    assert rel_norm(t32[pv], t[pv]) > 1e-3  # bf16 operands move the output
    assert (t[~pv] == np.float32(tne.NEG)).all()


def test_k2_node_limit_is_the_shared_memory_edge():
    """The wrapper's limits are the kernel's: MAXN nodes (a thread's
    attention scores in registers, csrc/node_layer.cuh) and ROWS valid nodes
    a block (rows_fit, mirrored by `kernel_rows`: 64 at d_model = d_ff =
    128, 32 at a width of 256); at each width the block's row buffers and
    weight ring fit one sm_90 block's shared memory with room for its row
    map (`BLOCK_BYTES`, the size of struct Block at RCAP rows), and a block
    twice as tall would not."""
    csrc = Path(tne.__file__).parent.parent / "csrc"
    layer, k2 = (csrc / "node_layer.cuh").read_text(), (csrc / "node_encoder.cu").read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", layer).group(1))
             for name in ("MAXN", "SMEM_OPTIN", "RCAP", "KT", "CW")}
    assert const["MAXN"] == tne.KERNEL_MAX_NODES and const["SMEM_OPTIN"] == tne.SMEM_LIMIT
    assert "constexpr int ROWS = rows_fit(NBUF * LDS, RING_BYTES + sizeof(Block), RCAP);" in k2
    rcap = const["RCAP"]
    # struct Block: N, R, np; grow[RCAP] (8-byte aligned); rseg, rnode; seg0[RCAP + 1]; spoly[RCAP]; nrow
    assert tne.BLOCK_BYTES == 16 + 8 * rcap + 4 * rcap * 2 + (4 * (rcap + 1) + 4) + 8 * rcap + 4 * rcap
    assert (tne.kernel_rows(128, 128), tne.kernel_rows(256, 128), tne.kernel_rows(128, 256)) == (rcap, 32, 32)
    for d_model, d_ff in ((128, 128), (256, 128), (128, 256), (256, 256)):
        smem = tne.smem_bytes(d_model, d_ff)
        assert tne.kernel_rows(d_model, d_ff) >= tne.KERNEL_MAX_NODES
        assert smem + tne.BLOCK_BYTES <= tne.SMEM_LIMIT < 2 * smem
        assert smem == 4 * (5 * tne.kernel_rows(d_model, d_ff) * (max(d_model, d_ff) + 4) + 3 * const["KT"] * const["CW"])


def test_k2_wrapper_on_cpu_is_the_plain_version():
    x, valid = map(torch.from_numpy, _node_inputs(BP=8, N=5, D=16))
    tmod = tne.FusedNodeEncoder(16, 2, 2, 16)
    before = tne.LAUNCHES
    with torch.no_grad():
        out = tmod.encode_pooled(x, valid)
        assert torch.equal(out, tmod.pooled_plain(x, valid))
    assert tne.LAUNCHES == before
