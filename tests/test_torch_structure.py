"""The model-structure options the port once refused, against the JAX
package on the CPU, in fp32 eval mode.

Module by module (flax init from a seed, `weights.load_jax_params` into the
port, the same numpy inputs; atol = rtol = 1e-5, as tests/test_torch_modules.py):

- `TransformerBlock` pre- and post-norm, with a feed-forward and without
  one (the DenseTNT/VectorNet activation residual), with the K/V cache of
  `return_tgt_kv`, and the attention weights of `need_weights`;
- per-query (KNN) targets: `Attention` on k/v [B, S, T, D] with rows whose
  targets are all masked;
- the action head's variants: unbranched, LayerNorm'd branches, a learned
  log_std MLP;
- `distributions.Gaussian`: `sample` with JAX's normals injected through
  `distributions.standard_normal`, per-row deterministic masks, `log_prob`
  (a triangular solve) and `repeat`.

tests/test_torch_structure_model.py holds a whole model with these options.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu import distributions as JD  # noqa: E402
from trafficbots_tpu.models import modules as jm  # noqa: E402
import trafficbots_tpu_torch.distributions as TD  # noqa: E402
from trafficbots_tpu_torch.models import modules as tm  # noqa: E402
from trafficbots_tpu_torch.weights import load_jax_params  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = dict(atol=1e-5, rtol=1e-5)
D = 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(module, params):
    load_jax_params(module, _np(params))
    return module.eval()


def _x(rs, *shape):
    return rs.normal(size=shape).astype(np.float32)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


@pytest.mark.parametrize("d_ff", [32, 0])
@pytest.mark.parametrize("norm_first", [True, False])
def test_transformer_block_layer_recipes_match_jax(norm_first, d_ff):
    rs = np.random.RandomState(3)
    B, S, T = 2, 5, 7
    src, tgt = _x(rs, B, S, D), _x(rs, B, T, D)
    src_pad, tgt_pad = rs.rand(B, S) < 0.3, rs.rand(B, T) < 0.3
    tgt_pad[1, :] = True  # scene 1: no valid target
    kw = dict(d_model=D, n_head=2, d_feedforward=d_ff, n_layer=2, norm_first=norm_first)
    jmod = jm.TransformerBlock(dropout_p=0.0, **kw)
    jin = dict(src_padding_mask=jnp.asarray(src_pad), tgt=jnp.asarray(tgt), tgt_padding_mask=jnp.asarray(tgt_pad))
    p = jmod.init(jax.random.PRNGKey(2), jnp.asarray(src), **jin)["params"]
    j, jw = jmod.apply({"params": p}, jnp.asarray(src), need_weights=True, **jin)
    jkv = jmod.apply({"params": p}, None, tgt=jnp.asarray(tgt), return_tgt_kv=True)
    jc, _ = jmod.apply({"params": p}, jnp.asarray(src), src_padding_mask=jin["src_padding_mask"],
                       tgt_padding_mask=jin["tgt_padding_mask"], tgt_kv=jkv)
    port = _port(tm.TransformerBlock(**kw), p)
    tin = dict(src_padding_mask=torch.from_numpy(src_pad), tgt=torch.from_numpy(tgt),
               tgt_padding_mask=torch.from_numpy(tgt_pad))
    with torch.no_grad():
        t, tw = port(torch.from_numpy(src), need_weights=True, **tin)
        tkv = port(None, tgt=torch.from_numpy(tgt), return_tgt_kv=True)
        tc = port(torch.from_numpy(src), src_padding_mask=tin["src_padding_mask"],
                  tgt_padding_mask=tin["tgt_padding_mask"], tgt_kv=tkv)
    _close(t, j)
    _close(tw, jw)
    _close(tc, jc)
    names = {n.split(".")[1] for n, _ in port.named_parameters()}
    assert names == ({"attn", "norm1", "norm_tgt"} if norm_first else {"attn", "norm1_post"}) | (
        ({"norm2", "linear1", "linear2"} if norm_first else {"norm2_post", "linear1", "linear2"}) if d_ff else set())


@pytest.mark.parametrize("masks", ["padding", "padding+attn"])
def test_knn_attention_matches_jax(masks):
    rs = np.random.RandomState(4)
    B, S, T = 2, 5, 6
    src, tgt = _x(rs, B, S, D), _x(rs, B, S, T, D)
    pad = rs.rand(B, S, T) < 0.4
    pad[0, 1] = True  # a row with no valid target
    am = rs.rand(B, S, T) < 0.3
    kw = {"tgt_padding_mask": pad}
    if masks == "padding+attn":
        kw["attn_mask"] = am
    jmod = jm.Attention(d_model=D, n_head=4, dropout_p=0.0)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    p = jmod.init(jax.random.PRNGKey(5), jnp.asarray(src), jnp.asarray(tgt), **jkw)["params"]
    j, jw = jmod.apply({"params": p}, jnp.asarray(src), jnp.asarray(tgt), need_weights=True, **jkw)
    with torch.no_grad():
        t, tw = _port(tm.Attention(D, 4), p)(torch.from_numpy(src), torch.from_numpy(tgt), need_weights=True,
                                             **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert torch.isfinite(t).all() and (t[0, 1] == 0).all()
    _close(t, j)
    _close(tw, jw)


HEADS = {
    "unbranched": dict(branch_type=False),
    "branch_layernorm": dict(use_layernorm=True),
    "learned_log_std_mlp": dict(log_std=None),
    "unbranched_layernorm_log_std_mlp": dict(branch_type=False, use_layernorm=True, log_std=None),
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_action_head_variants_match_jax(head):
    o = dict(dict(log_std=-2.0, branch_type=True, use_layernorm=False), **HEADS[head])
    rs = np.random.RandomState(6)
    B, A = 2, 7
    x, valid = _x(rs, B, A, D), rs.rand(B, A) < 0.7
    agent_type = np.eye(3, dtype=bool)[rs.randint(0, 3, size=(B, A))]
    kw = dict(use_layernorm=o["use_layernorm"], log_std_init=o["log_std"], branch_type=o["branch_type"])
    jmod = jm.ActionHead(hidden_dim=D, **kw)
    jargs = (jnp.asarray(x), jnp.asarray(valid), jnp.asarray(agent_type))
    p = jmod.init(jax.random.PRNGKey(7), *jargs)["params"]
    jmean, jlog = jmod.apply({"params": p}, *jargs)
    with torch.no_grad():
        tmean, tlog = _port(tm.ActionHead(D, **kw), p)(*(torch.from_numpy(a) for a in (x, valid, agent_type)))
    _close(tmean, jmean)
    _close(tlog, jlog)


def test_gaussian_matches_jax(monkeypatch):
    rs = np.random.RandomState(8)
    B, A, d = 3, 4, 3
    mean = _x(rs, B, A, d)
    tril = np.tril(_x(rs, B, A, d, d) * 0.5)
    idx = np.arange(d)
    tril[..., idx, idx] = np.abs(tril[..., idx, idx]) + 0.5
    x = _x(rs, B, A, d)
    jg = JD.Gaussian(mean=jnp.asarray(mean), tril=jnp.asarray(tril))
    tg = TD.Gaussian(mean=torch.from_numpy(mean), tril=torch.from_numpy(tril))
    _close(tg.log_prob(torch.from_numpy(x)), jg.log_prob(jnp.asarray(x)))
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(key, mean.shape, dtype=jnp.float32))

    def standard_normal(shape, dtype, device, generator=None):
        assert tuple(shape) == eps.shape
        return torch.tensor(eps, dtype=dtype, device=device)

    monkeypatch.setattr(TD, "standard_normal", standard_normal)
    det = rs.rand(B, A) < 0.5
    for d_arg in (False, det):
        t = tg.sample(torch.Generator(), deterministic=d_arg if d_arg is False else torch.from_numpy(det))
        j = jg.sample(key, deterministic=d_arg if d_arg is False else jnp.asarray(det))
        _close(t, j)
    np.testing.assert_array_equal(tg.sample(deterministic=True).numpy(), mean)
    jr, tr = jg.repeat(2, axis=0), tg.repeat(2, axis=0)
    np.testing.assert_array_equal(tr.mean.numpy(), np.asarray(jr.mean))
    np.testing.assert_array_equal(tr.tril.numpy(), np.asarray(jr.tril))
    x2 = np.repeat(x, 2, axis=0)
    _close(tr.log_prob(torch.from_numpy(x2)), jr.log_prob(jnp.asarray(x2)))
