"""The map encoder's other paths against the JAX package's, on the CPU in
fp32 eval mode (flax `MapEncoder` initialised from a seed,
`weights.load_jax_params` into the port's, strict both ways; the same numpy
inputs; atol = rtol = 1e-5).

- VectorNet (`densetnt_vectornet=False`): the `vn_mlp{i}` stack with the
  -inf fill, the max-and-concatenate, the last layer's end activation only
  under post-norm; with and without its LayerNorms;
- the "mean" pool (eps in the denominator) and the "first" pool over the
  un-pooled default node stack;
- the generic `TransformerBlock` node stack that a non-default layer
  recipe takes (another activation, no biases, an out-LayerNorm), under
  the max and the mean pools.

The polylines include padded nodes and wholly padded polylines (zeroed,
and masked in the polyline self-attention); one scene has a single valid
polyline.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu.config import InputPeEncoderConfig, MapEncoderConfig, TransformerConfig  # noqa: E402
from trafficbots_tpu.models.map_encoder import MapEncoder as JMapEncoder  # noqa: E402
from trafficbots_tpu_torch import config as TC  # noqa: E402
from trafficbots_tpu_torch.models.map_encoder import MapEncoder  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)
HIDDEN, PE, ATTR = 64, 32, 7
B, P, N = 2, 12, 10

PATHS = {
    "vectornet": (dict(densetnt_vectornet=False), {}),
    "vectornet_post_norm": (dict(densetnt_vectornet=False), dict(norm_first=False)),
    "vectornet_layernorm": (dict(densetnt_vectornet=False, mlp_use_layernorm=True), {}),
    "mean_pool": (dict(pool_mode="mean"), {}),
    "first_pool": (dict(pool_mode="first"), {}),
    "generic_gelu": ({}, dict(activation="gelu")),
    "generic_no_bias_mean_pool": (dict(pool_mode="mean"), dict(bias=False)),
    "generic_out_layernorm": ({}, dict(out_layernorm=True)),
    "generic_post_norm_no_feedforward": ({}, dict(norm_first=False, d_feedforward=0)),
}


def inputs():
    rs = np.random.RandomState(0)
    valid = rs.rand(B, P, N) < 0.7
    valid[:, -3:] = False  # wholly padded polylines
    valid[1, 1:] = False  # scene 1: one valid polyline
    valid[1, 0, :2] = True
    attr = rs.normal(size=(B, P, N, ATTR)).astype(np.float32)
    pe = rs.normal(size=(B, P, N, PE)).astype(np.float32)
    return valid, attr, pe


def port_cfg(cls, jcfg):
    return getattr(TC, cls.__name__)(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_map_encoder_paths_match_jax(path):
    me, tf = PATHS[path]
    cfg = MapEncoderConfig(n_layer=2, mlp_dropout_p=0.0, **me)
    tf_cfg = TransformerConfig(**dict(dict(d_model=HIDDEN, n_head=2, d_feedforward=HIDDEN, dropout_p=0.0), **tf))
    pe_cfg = InputPeEncoderConfig(mlp_dropout_p=0.0)
    valid, attr, pe = inputs()
    jmod = JMapEncoder(hidden_dim=HIDDEN, pe_dim=PE, cfg=cfg, pe_cfg=pe_cfg, tf_cfg=tf_cfg)
    jin = tuple(jnp.asarray(a) for a in (valid, attr, pe))
    params = jmod.init(jax.random.PRNGKey(1), *jin)["params"]
    jfeat, jvalid = jmod.apply({"params": params}, *jin)
    port = MapEncoder(ATTR, HIDDEN, PE, port_cfg(MapEncoderConfig, cfg), port_cfg(InputPeEncoderConfig, pe_cfg),
                      port_cfg(TransformerConfig, tf_cfg))
    load_jax_params(port, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        feat, pl_valid = port(*(torch.from_numpy(a) for a in (valid, attr, pe)))
    assert torch.isfinite(feat).all()
    np.testing.assert_array_equal(pl_valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), **TOL)
    if me.get("densetnt_vectornet", True) is False:
        assert {n.split(".")[0] for n, _ in port.named_parameters()} == {"input_pe", "vn_mlp0", "vn_mlp1",
                                                                         "self_attn"}
