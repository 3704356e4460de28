"""Port building blocks (models/modules.py) against their flax counterparts (CPU).

Each flax module is initialised from a seed, its params go through
`weights.load_jax_params` into the port's module, and both run on the same
numpy inputs. Tolerance: atol = rtol = 1e-5 in fp32 (the two CPU backends
sum matmuls in different orders; the results differ by a few ulp).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu.models import modules as jm
from trafficbots_tpu_torch.models import modules as tm
from trafficbots_tpu_torch.weights import load_jax_params

TOL = dict(atol=1e-5, rtol=1e-5)
D = 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(module, params):
    load_jax_params(module, _np(params))
    return module.eval()


def _rs(seed=0):
    return np.random.RandomState(seed)


def _x(rs, *shape):
    return rs.normal(size=shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("layernorm", [False, True])
@pytest.mark.parametrize("end_act", [False, True])
def test_mlp_masks_before_end_activation(layernorm, end_act):
    rs = _rs()
    x, valid = _x(rs, 3, 5, 12), rs.rand(3, 5) < 0.6
    jmod = jm.MLP([D, 16], dropout_p=None, use_layernorm=layernorm, end_layer_activation=end_act)
    p = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    j = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(valid), fill_invalid=-3.0)
    t = _port(tm.MLP(12, [D, 16], use_layernorm=layernorm, end_layer_activation=end_act), p)(
        torch.from_numpy(x), torch.from_numpy(valid), fill_invalid=-3.0
    )
    _close(t, j)


@pytest.mark.parametrize("masks", ["none", "padding", "padding+attn"])
def test_attention_nan_guard_and_masks(masks):
    rs = _rs(1)
    B, S, T = 2, 6, 9
    src, tgt = _x(rs, B, S, D), _x(rs, B, T, D)
    pad = rs.rand(B, T) < 0.4
    pad[1] = True  # scene 1: every target padded -> all rows zero
    am = rs.rand(B, S, T) < 0.3
    am[0, 2] = True  # one all-masked row
    kw = {}
    if masks != "none":
        kw["tgt_padding_mask"] = pad
    if masks == "padding+attn":
        kw["attn_mask"] = am
    jmod = jm.Attention(d_model=D, n_head=4, dropout_p=0.0)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    p = jmod.init(jax.random.PRNGKey(1), jnp.asarray(src), jnp.asarray(tgt), **jkw)["params"]
    j, _ = jmod.apply({"params": p}, jnp.asarray(src), jnp.asarray(tgt), **jkw)
    t = _port(tm.Attention(D, 4), p)(torch.from_numpy(src), torch.from_numpy(tgt),
                                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert torch.isfinite(t).all()
    _close(t, j)


def test_attention_cached_kv_bf16():
    """The rollout's as2pl form: K/V precomputed with return_kv, stored in
    bf16 and used in fp32 (the JAX XLA path), S >= 32 and T >= 64 so the
    port routes the core through fused_attention_core."""
    rs = _rs(2)
    B, S, T = 2, 32, 64
    src, tgt, pad = _x(rs, B, S, D), _x(rs, B, T, D), rs.rand(B, T) < 0.3
    jmod = jm.Attention(d_model=D, n_head=2, dropout_p=0.0)
    p = jmod.init(jax.random.PRNGKey(2), jnp.asarray(src), jnp.asarray(tgt))["params"]
    jk, jv = jmod.apply({"params": p}, jnp.asarray(src), jnp.asarray(tgt), return_kv=True)
    jkv = (jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16))
    j, _ = jmod.apply({"params": p}, jnp.asarray(src), tgt_padding_mask=jnp.asarray(pad), tgt_kv=jkv)
    tmod = _port(tm.Attention(D, 2), p)
    tk, tv = tmod(torch.from_numpy(src), torch.from_numpy(tgt), return_kv=True)
    tkv = (tk.bfloat16(), tv.bfloat16())
    np.testing.assert_array_equal(tkv[0].float().detach().numpy(), np.asarray(jkv[0].astype(jnp.float32)))
    t = tmod(torch.from_numpy(src), tgt_padding_mask=torch.from_numpy(pad), tgt_kv=tkv)
    _close(t, j)


@pytest.mark.parametrize("n_layer", [1, 2])
def test_transformer_block_cross_and_kv_cache(n_layer):
    rs = _rs(3)
    B, S, T = 2, 5, 7
    src, tgt = _x(rs, B, S, D), _x(rs, B, T, D)
    spad, tpad = rs.rand(B, S) < 0.3, rs.rand(B, T) < 0.3
    jmod = jm.TransformerBlock(d_model=D, n_head=2, d_feedforward=48, n_layer=n_layer, dropout_p=0.0)
    args = (jnp.asarray(src), jnp.asarray(spad), jnp.asarray(tgt), jnp.asarray(tpad))
    p = jmod.init(jax.random.PRNGKey(3), *args)["params"]
    j, _ = jmod.apply({"params": p}, *args)
    tmod = _port(tm.TransformerBlock(D, 2, 48, n_layer=n_layer), p)
    targs = tuple(map(torch.from_numpy, (src, spad, tgt, tpad)))
    _close(tmod(*targs), j)
    jkv = jmod.apply({"params": p}, None, tgt=jnp.asarray(tgt), return_tgt_kv=True)
    tkv = tmod(None, tgt=targs[2], return_tgt_kv=True)
    for (a, b), (c, d) in zip(tkv, jkv):
        _close(a, c)
        _close(b, d)
    _close(tmod(targs[0], targs[1], tgt_padding_mask=targs[3], tgt_kv=tkv), j)


@pytest.mark.parametrize("pe_mode", ["cat", "input", "add"])
def test_input_pe_encoder(pe_mode):
    rs = _rs(4)
    hidden, pe_dim = 64, (64 if pe_mode == "add" else 24)
    attr, pe, valid = _x(rs, 2, 3, 5, 11), _x(rs, 2, 3, 5, pe_dim), rs.rand(2, 3, 5) < 0.7
    jmod = jm.InputPeEncoder(hidden_dim=hidden, pe_dim=pe_dim, pe_mode=pe_mode, mlp_dropout_p=None)
    a = tuple(map(jnp.asarray, (valid, attr, pe)))
    p = jmod.init(jax.random.PRNGKey(4), *a)["params"]
    t = _port(tm.InputPeEncoder(11, hidden, pe_dim, pe_mode=pe_mode), p)(
        *map(torch.from_numpy, (valid, attr, pe))
    )
    _close(t, jmod.apply({"params": p}, *a))


@pytest.mark.parametrize("mode", ["max", "last", "max_valid", "last_valid", "mean_valid"])
def test_temporal_aggregate(mode):
    rs = _rs(5)
    x, valid = _x(rs, 2, 7, 4, 6), rs.rand(2, 7, 4) < 0.5
    valid[0, :, 0] = False
    t, tv = tm.temporal_aggregate(torch.from_numpy(x), torch.from_numpy(valid), mode)
    j, jv = jm.temporal_aggregate(jnp.asarray(x), jnp.asarray(valid), mode)
    _close(t, j)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("seq", [False, True])
def test_stacked_gru(seq):
    rs = _rs(6)
    L = 2
    jmod = jm.StackedGRU(hidden_dim=D, num_layers=L, dropout=0.0)
    if seq:
        x, valid = _x(rs, 2, 6, 3, D), rs.rand(2, 6, 3) < 0.7
        a = (jnp.asarray(x), jnp.asarray(valid))
        p = jmod.init(jax.random.PRNGKey(6), *a)["params"]
        j, _ = jmod.apply({"params": p}, *a)
        t, _ = _port(tm.StackedGRU(D, L), p)(torch.from_numpy(x), torch.from_numpy(valid))
        _close(t, j)
        return
    x, valid, h = _x(rs, 2, 3, D), rs.rand(2, 3) < 0.7, _x(rs, L, 2, 3, D)
    a = (jnp.asarray(x), jnp.asarray(valid), jnp.asarray(h))
    p = jmod.init(jax.random.PRNGKey(6), *a)["params"]
    # b_hn is zero at init: set it so the term inside r * (...) is exercised
    p = jax.tree_util.tree_map(lambda v: v, p)
    p["gru0"]["b_hn"] = jnp.asarray(_x(rs, D))
    j, jh = jmod.apply({"params": p}, *a)
    t, th = _port(tm.StackedGRU(D, L), p)(*map(torch.from_numpy, (x, valid, h)))
    _close(t, j)
    _close(th, jh)


@pytest.mark.parametrize("seq", [False, True])
def test_multi_agent_tf_single_agent_rows(seq):
    rs = _rs(7)
    shape = (2, 3, 5) if seq else (3, 5)
    fma, f, valid = _x(rs, *shape, D), _x(rs, *shape, D), rs.rand(*shape) < 0.6
    valid.reshape(-1, 5)[0] = [True, False, False, False, False]  # one valid agent: raw input kept
    kw = dict(d_feedforward=D, n_head=2, dropout_p=0.0)
    jmod = jm.MultiAgentTF(hidden_dim=D, n_layer=2, tf_kwargs=kw)
    a = tuple(map(jnp.asarray, (fma, f, valid)))
    p = jmod.init(jax.random.PRNGKey(7), *a)["params"]
    j, _ = jmod.apply({"params": p}, *a)
    t = _port(tm.MultiAgentTF(D, n_layer=2, tf_kwargs=dict(d_feedforward=D, n_head=2)), p)(
        *map(torch.from_numpy, (fma, f, valid))
    )
    _close(t, j)


@pytest.mark.parametrize("mode,res_add", [("cat", True), ("add", False), ("mul", True)])
def test_add_latent_goal_and_precompute(mode, res_add):
    rs = _rs(8)
    x, xv, z, zv = _x(rs, 2, 4, D), rs.rand(2, 4) < 0.8, _x(rs, 2, 4, 8), rs.rand(2, 4) < 0.6
    jmod = jm.AddLatentGoal(hidden_dim=D, in_dim=8, mode=mode, res_add=res_add, mlp_dropout_p=0.0,
                            mlp_in_use_layernorm=True)
    a = tuple(map(jnp.asarray, (x, xv, z, zv)))
    p = jmod.init(jax.random.PRNGKey(8), *a)["params"]
    j = jmod.apply({"params": p}, *a)
    tmod = _port(tm.AddLatentGoal(D, 8, mode=mode, res_add=res_add, mlp_in_use_layernorm=True), p)
    ta = tuple(map(torch.from_numpy, (x, xv, z, zv)))
    _close(tmod(*ta), j)
    _close(tmod(*ta, z_pre=tmod.precompute_z(ta[2], ta[3])), j)


def test_action_head_type_branches():
    rs = _rs(9)
    x, valid = _x(rs, 2, 5, D), rs.rand(2, 5) < 0.8
    atype = np.eye(3, dtype=bool)[rs.randint(0, 3, size=(2, 5))]
    jmod = jm.ActionHead(hidden_dim=D)
    a = tuple(map(jnp.asarray, (x, valid, atype)))
    p = jmod.init(jax.random.PRNGKey(9), *a)["params"]
    jmean, jlog = jmod.apply({"params": p}, *a)
    tmean, tlog = _port(tm.ActionHead(D), p)(*map(torch.from_numpy, (x, valid, atype)))
    _close(tmean, jmean)
    _close(tlog, jlog)
