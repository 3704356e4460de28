"""The two ported kernels' plain versions against the JAX kernels, and the
CUDA kernels against those plain versions.

CPU (here): `attention_core_plain` (K1) against the JAX package's
`fused_attention_core` run in Pallas interpret mode, and against
`_xla_reference` with a bf16 K/V cache; `FusedNodeEncoder.pooled_plain`
(K2) against the JAX `FusedNodeEncoder.encode_pooled` in interpret mode.
Tolerance: atol = rtol = 1e-5 (fp32; ulp-level summation-order
differences between the CPU backends).

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


def test_k1_wrapper_on_cpu_is_the_plain_version():
    q, k, v, invalid = map(torch.from_numpy, _attn_inputs(B=2, S=32, T=64, D=32, seed=2))
    before = tfa.LAUNCHES
    out = tfa.fused_attention_core(q, k, v, invalid[:, :1].expand_as(invalid), 2)
    assert tfa.LAUNCHES == before
    assert torch.equal(out, tfa.attention_core_plain(q, k, v, invalid[:, :1].expand_as(invalid), 2))


@pytest.mark.parametrize("n_head", [2, 4])
def test_k2_plain_matches_jax_kernel_interpret(n_head):
    x, valid = _node_inputs()
    D = x.shape[-1]
    jmod = JNodeEncoder(d_model=D, n_head=n_head, n_layer=3, d_feedforward=D, dropout_p=0.0, pipeline_blocks=2)
    p = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid))["params"]
    # non-trivial LayerNorm and bias parameters (init leaves them 1 and 0)
    rs = np.random.RandomState(4)
    p = {k: (v + 0.1 * rs.normal(size=v.shape).astype(np.float32) if v.ndim == 2 else v) for k, v in p.items()}
    j = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid), method="encode_pooled")
    tmod = tne.FusedNodeEncoder(D, n_head, 3, D)
    load_jax_params(tmod, jax.tree_util.tree_map(np.asarray, p))
    with torch.no_grad():
        t = tmod.pooled_plain(torch.from_numpy(x), torch.from_numpy(valid))
    pv = valid.any(-1)
    np.testing.assert_allclose(t.numpy()[pv], np.asarray(j)[pv], **TOL)
    assert (t.numpy()[~pv] == np.float32(tne.NEG)).all()
    assert (np.asarray(j)[~pv] == np.float32(tne.NEG)).all()


def test_k2_node_limit_is_the_shared_memory_edge():
    """The wrapper's node limit is the kernel's MAXN, the most nodes whose
    shared memory fits one sm_90 block."""
    src = (Path(tne.__file__).parent.parent / "csrc" / "node_encoder.cu").read_text()
    assert int(re.search(r"constexpr int MAXN = (\d+);", src).group(1)) == tne.KERNEL_MAX_NODES
    assert int(re.search(r"constexpr int SMEM_OPTIN = (\d+);", src).group(1)) == tne.SMEM_LIMIT
    assert tne.smem_bytes(tne.KERNEL_MAX_NODES) <= tne.SMEM_LIMIT < tne.smem_bytes(tne.KERNEL_MAX_NODES + 1)


def test_k2_wrapper_on_cpu_is_the_plain_version():
    x, valid = map(torch.from_numpy, _node_inputs(BP=8, N=5, D=16))
    tmod = tne.FusedNodeEncoder(16, 2, 2, 16)
    before = tne.LAUNCHES
    with torch.no_grad():
        out = tmod.encode_pooled(x, valid)
        assert torch.equal(out, tmod.pooled_plain(x, valid))
    assert tne.LAUNCHES == before
