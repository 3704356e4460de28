"""The port's K1 and K3 call sites take the plain version exactly where the
JAX package runs XLA in place of its Pallas kernel, on the CPU.

`ops.fused_attention.jax_kernel_fits` copies the query block choice of
the JAX package's `_pallas_forward` (its VMEM budget), and
`ops.attention_train.jax_kernel_fits` its `fused_attention_train_fits`.
K1's is held against the JAX package by tracing its `fused_attention_core`
abstractly (`jax.eval_shape`, nothing compiled or run) with a spy on its
XLA fallback; K3's against the JAX predicate itself. The shapes cover the
port's sites and widths past both budgets.
"""
import jax
import jax.numpy as jnp
import pytest

from trafficbots_tpu.ops import attention_train as JK3
from trafficbots_tpu.ops import fused_attention as JK1
from trafficbots_tpu_torch.ops import attention_train as K3
from trafficbots_tpu_torch.ops import fused_attention as K1

K1_SHAPES = [  # S, T, D, kv_bytes, row_block
    (64, 1024, 128, 4, -1),  # the rollout as2pl
    (1024, 1024, 128, 4, -1),  # the map self-attention
    (1216, 1024, 128, 4, -1),  # the latent as2pl (its whole S does not fit: a divisor)
    (1024, 1024, 256, 2, -1),
    (64, 16384, 128, 4, -1),  # k and v alone past the budget
    (64, 16384, 128, 2, -1),
    (4096, 4096, 256, 4, -1),
    (1000, 6000, 128, 4, -1),  # no divisor of S in [32, S / 2] fits
    (64, 1024, 128, 4, 0),  # the dead-row skip's automatic block
    (1024, 8192, 128, 4, 0),
    (1000, 9000, 64, 4, 0),
    (64, 1024, 128, 4, 32),
    (1024, 8000, 128, 4, 512),  # an explicit block that does not fit: the automatic one
    (12, 40000, 32, 4, 0),
]


@pytest.mark.parametrize("S,T,D,kv_bytes,row_block", K1_SHAPES)
def test_k1_site_follows_the_jax_kernels_fallback(monkeypatch, S, T, D, kv_bytes, row_block):
    fell_back = []
    xla = JK1._xla_reference

    def spy(*a, **kw):
        fell_back.append(True)
        return xla(*a, **kw)

    monkeypatch.setattr(JK1, "_xla_reference", spy)
    kv = jnp.bfloat16 if kv_bytes == 2 else jnp.float32
    args = (jax.ShapeDtypeStruct((1, S, D), kv), jax.ShapeDtypeStruct((1, T, D), kv),
            jax.ShapeDtypeStruct((1, T, D), kv), jax.ShapeDtypeStruct((1, S, T), bool),
            jax.ShapeDtypeStruct((1, S), bool))
    jax.eval_shape(lambda q, k, v, inv, src: JK1.fused_attention_core(q, k, v, inv, src, 4, row_block), *args)
    assert K1.jax_kernel_fits(S, T, D, kv_bytes, row_block) == (not fell_back)


K3_SHAPES = [  # B, S, T, D
    (8, 64, 1024, 128), (8, 1024, 1024, 128), (8, 1216, 1024, 128), (8, 1024, 1024, 256),
    (2, 1000, 1000, 128),  # one scene past the budget, S no multiple of 32
    (2, 4096, 4096, 256), (1, 4096, 8192, 256), (4, 256, 256, 64), (3, 96, 20000, 128),
]


@pytest.mark.parametrize("B,S,T,D", K3_SHAPES)
def test_k3_site_follows_the_jax_kernels_fit(B, S, T, D):
    assert K3.jax_kernel_fits(S, T, D) == JK3.fused_attention_train_fits(B, S, T, D)


def test_the_shapes_reach_both_answers():
    assert {K1.jax_kernel_fits(*s) for s in K1_SHAPES} == {True, False}
    assert {K3.jax_kernel_fits(*s[1:]) for s in K3_SHAPES} == {True, False}
