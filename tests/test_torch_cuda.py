"""The hand-written CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc (the kernels have no CPU or
interpret mode): they are marked `cuda` and skip without one. On a machine
with an H100:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

The file imports nothing of JAX, so it runs where JAX is not installed. The
input helpers are shared with tests/test_torch_kernels.py, which holds the
plain versions against the JAX kernels on the CPU.

Tolerances: K1 atol = rtol = 1e-5 and K2 1e-4 (fp32 on both sides, the sums
in another order: a few ulp of outputs of order 1-10, more for the 3-layer
node stack); rollouts: the first 30 steps within 1e-3 m (see chip_smoke.py).
The training kernels run with dropout live on the same seeds as their plain
versions (K5's masks are bit-equal, checked here): K3's output within 1e-5
and its gradients within a relative norm error of 1e-5; K4's pooled output
within 1e-4 and its dx and 18 weight gradients within a relative norm error
of 1e-3 (K3's sums run over up to 1216 query rows in another order; the
node stack's fp32 gradients are themselves ~1e-4 from fp64: max-pool
near-ties move a column's whole cotangent, see chip_smoke.py).
The backward kernels are bitwise the same run to run. K6 (the hybrid node
encoder's attention core) within 1e-5 of its plain version on the rows of
polylines with a valid node, every row finite; the hybrid node encoder
(K6) against the fused one (K2) within 1e-4, as K2 against its plain
version.
"""
import dataclasses

import numpy as np
import pytest
import torch

from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.config import ExperimentConfig
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch
from trafficbots_tpu_torch.ops import attention_train as tat
from trafficbots_tpu_torch.ops import block_attn as tba
from trafficbots_tpu_torch.ops import dropout as tdo
from trafficbots_tpu_torch.ops import fused_attention as tfa
from trafficbots_tpu_torch.ops import node_encoder as tne
from trafficbots_tpu_torch.ops import node_encoder_train as tnt
from trafficbots_tpu_torch.weights import init_params


def attn_inputs(B=3, S=8, T=16, D=16, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.normal(size=s).astype(np.float32) for s in ((B, S, D), (B, T, D), (B, T, D)))
    invalid = rs.rand(B, S, T) < 0.3
    invalid[0, 2] = True  # an all-masked row
    invalid[1] = True  # a scene with every target masked
    return q, k, v, invalid


def node_inputs(BP=32, N=10, D=64, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(BP, N, D)).astype(np.float32)
    valid = rs.rand(BP, N) < 0.8
    valid[0] = False  # an all-invalid polyline
    valid[1] = [True] * 3 + [False] * (N - 3)  # a partly valid one
    valid[16:] = False  # an all-padding block at the TPU's 8-polyline blocking
    x = np.where(valid[..., None], x, 0.0).astype(np.float32)
    return x, valid


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,bf16", [(4, 64, 1024, True), (2, 1024, 1024, False), (2, 1216, 1024, False), (8, 64, 100, False)])
def test_k1_kernel_matches_plain(cuda, B, S, T, bf16):
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, T, 128, seed=5))
    if bf16:
        k, v = k.bfloat16(), v.bfloat16()
    pad = invalid[:, 0]
    for inv in (pad[:, None, :].expand(B, S, T), invalid):
        before = tfa.LAUNCHES
        out = tfa.fused_attention_core(q, k, v, inv, 4)
        torch.cuda.synchronize()
        assert tfa.LAUNCHES == before + 1
        ref = tfa.attention_core_plain(q, k, v, inv, 4)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [20, tne.KERNEL_MAX_NODES])
def test_k2_kernel_matches_plain(cuda, N):
    x, valid = (torch.from_numpy(a).to(cuda) for a in node_inputs(BP=1024, N=N, D=128, seed=6))
    tmod = tne.FusedNodeEncoder(128, 4, 3, 128)
    init_params(tmod, 0)
    tmod = tmod.to(cuda)
    with torch.no_grad():
        out = tmod.encode_pooled(x, valid)
        torch.cuda.synchronize()
        ref = tmod.pooled_plain(x, valid)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_k2_wrapper_refuses_more_nodes_than_fit(cuda):
    x, valid = (torch.from_numpy(a).to(cuda) for a in node_inputs(BP=32, N=tne.KERNEL_MAX_NODES + 1, D=128))
    tmod = tne.FusedNodeEncoder(128, 4, 3, 128).to(cuda)
    before = tne.LAUNCHES
    with torch.no_grad(), pytest.raises(ValueError, match="nodes"):
        tmod.encode_pooled(x, valid)
    assert tne.LAUNCHES == before


@pytest.mark.cuda
def test_eval_rollout_on_the_card_launches_both_kernels(cuda):
    """A small config at the model's full width (hidden 128, 4 heads): the
    card's run goes through both kernels and agrees with the CPU's plain run
    over the 10 warm-up and the first 20 closed-loop steps (chip_smoke.py's
    HELD_STEPS)."""
    cfg = ExperimentConfig()
    data = dataclasses.replace(cfg.data, n_agent=32, n_pl=128, n_tl=16, n_tl_stop=8)
    cfg = dataclasses.replace(cfg, data=data)
    batch = synthetic_episode_batch(data, n_scene=2, seed=1, n_valid_pl=96, n_valid_agent=20)
    tfa.LAUNCHES = tne.LAUNCHES = 0
    out = TO.eval_rollout(cfg, TO.make_model(cfg, device=cuda, seed=1), batch, device=cuda)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES > 0 and tne.LAUNCHES > 0
    ref = TO.eval_rollout(cfg, TO.make_model(cfg, device="cpu", seed=1), batch, device="cpu")
    p = out.preds.cpu()
    assert torch.isfinite(p).all()
    np.testing.assert_allclose(p[:, :, :30].numpy(), ref.preds[:, :, :30].numpy(), atol=1e-3, rtol=0)
    assert torch.equal(out.valid[:, :, :30].cpu(), ref.valid[:, :, :30])


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 37, 130), (2, 4, 64, 1024)])
def test_k5_masks_equal_the_plain_bits(cuda, shape):
    seed = 2**61 + 12345  # a key with both words live
    before = tdo.LAUNCHES
    out = tdo.dropout(torch.ones(shape, device=cuda), 0.1, seed, 7)
    torch.cuda.synchronize()
    assert tdo.LAUNCHES == before + 1
    assert torch.equal(out, tdo.dropout_mask_plain(shape, seed, 7, 0.1, device=cuda))


def k3_case(cuda, B, S, T, full_mask, seed=11):
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, T, 128, seed=seed))
    if not full_mask:
        invalid = invalid[:, 0][:, None, :].expand(B, S, T)
    g = torch.randn(B, S, 128, generator=torch.Generator().manual_seed(seed)).to(cuda)
    return q, k, v, invalid, g


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,full_mask", [(4, 64, 1024, False), (2, 1216, 1024, False), (2, 48, 300, True)])
def test_k3_kernels_match_plain_with_dropout(cuda, B, S, T, full_mask):
    q, k, v, invalid, g = k3_case(cuda, B, S, T, full_mask)

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv, invalid, 4, 0.1, 987654321, 3)
        out.backward(g)
        torch.cuda.synchronize()
        return out.detach(), qq.grad, kk.grad, vv.grad

    f0, b0 = tat.LAUNCHES_FWD, tat.LAUNCHES_BWD
    got = run(tat.attention_train)
    assert (tat.LAUNCHES_FWD, tat.LAUNCHES_BWD) == (f0 + 1, b0 + 1)
    ref = run(tat.attention_train_plain)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert rel_err(a, b) < 1e-5, name
    again = run(tat.attention_train)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if full_mask:
        assert (got[0][0, 2] == 0).all() and (got[0][1] == 0).all() and (got[1][1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_k4_kernels_match_plain(cuda, p):
    x, valid = node_inputs(BP=1024, N=20, D=128, seed=8)
    x[2, 5] = x[2, 4]  # two equal nodes: with p = 0 they tie in every column of the max
    valid[2, 4:6] = True
    x, valid = torch.from_numpy(x).to(cuda), torch.from_numpy(valid).to(cuda)
    enc = tne.FusedNodeEncoder(128, 4, 3, 128)
    init_params(enc, 0)
    with torch.no_grad():
        for name in tne.W_NAMES:
            if getattr(enc, name).ndim == 2:
                getattr(enc, name).add_(0.1 * torch.randn(getattr(enc, name).shape, generator=torch.Generator().manual_seed(1)))
    enc = enc.to(cuda)
    g = torch.randn(1024, 128, generator=torch.Generator().manual_seed(2)).to(cuda)
    pl = valid.any(-1)

    def run(fn):
        enc.zero_grad()
        xx = x.clone().requires_grad_()
        out = fn(enc, xx, valid, p, 2**40 + 5)
        torch.where(pl[:, None], out, torch.zeros_like(out)).backward(g)
        torch.cuda.synchronize()
        return [out.detach(), xx.grad] + [getattr(enc, n).grad.clone() for n in tne.W_NAMES]

    got = run(tnt.node_encoder_train)
    ref = run(tnt.node_encoder_train_plain)
    torch.testing.assert_close(got[0][pl], ref[0][pl], atol=1e-4, rtol=1e-4)
    assert (got[0][~pl] == tne.NEG).all()
    # bk has an exact gradient of 0 (a per-row constant does not move the
    # softmax): both sides give rounding noise, so each gradient's error is
    # held to 1e-3 of its own norm or of 1e-3 of the largest gradient's
    scale = max(b.norm().item() for b in ref[1:])
    errs = {name: ((a - b).norm().item(), b.norm().item())
            for name, a, b in zip(["dx"] + list(tne.W_NAMES), got[1:], ref[1:])}
    print("K4 gradient errors (abs, ref norm):", errs)
    assert all(e <= 1e-3 * max(nb, 1e-3 * scale) for e, nb in errs.values()), errs
    assert (got[1][~pl] == 0).all()
    if p == 0:
        assert torch.equal(got[1][2, 4], got[1][2, 5])  # the tied nodes share the cotangent
    again = run(tnt.node_encoder_train)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def perturbed_encoder(seed=1):
    enc = tne.FusedNodeEncoder(128, 4, 3, 128)
    init_params(enc, 0)
    with torch.no_grad():
        for name in tne.W_NAMES:
            p = getattr(enc, name)
            if p.ndim == 2:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)))
    return enc


@pytest.mark.cuda
@pytest.mark.parametrize("N,H", [(20, 4), (tba.KERNEL_MAX_NODES, 4), (20, 1), (7, 8)])
def test_k6_kernel_matches_plain(cuda, N, H):
    _, valid = node_inputs(BP=1024, N=N, D=128, seed=9)
    rs = np.random.RandomState(10)
    q, k, v = (torch.from_numpy(rs.normal(size=(1024, N, 128)).astype(np.float32)).to(cuda) for _ in range(3))
    valid = torch.from_numpy(valid).to(cuda)
    before = tba.LAUNCHES
    out = tba.block_attn_core(q, k, v, valid, H)
    torch.cuda.synchronize()
    assert tba.LAUNCHES == before + 1
    ref = tba.block_attn_core_plain(q, k, v, valid, H)
    live = valid.any(-1)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[live], ref[live], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_k6_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(8, tba.KERNEL_MAX_NODES + 1, 128, device=cuda)
    valid = torch.ones(q.shape[:2], dtype=torch.bool, device=cuda)
    before = tba.LAUNCHES
    with pytest.raises(ValueError, match="nodes"):
        tba.block_attn_core(q, q, q, valid, 4)
    with pytest.raises(TypeError):
        tba.block_attn_core(q[:, :20].double(), q[:, :20].double(), q[:, :20].double(), valid[:, :20], 4)
    assert tba.LAUNCHES == before


@pytest.mark.cuda
def test_hybrid_node_encoder_matches_fused(cuda):
    """The same pooled features through K6 (hybrid) and K2 (fused)."""
    x, valid = (torch.from_numpy(a).to(cuda) for a in node_inputs(BP=1024, N=20, D=128, seed=11))
    enc = perturbed_encoder().to(cuda)
    k2, k6 = tne.LAUNCHES, tba.LAUNCHES
    with torch.no_grad():
        hyb = enc.encode_pooled_hybrid(x, valid)
        fused = enc.encode_pooled(x, valid)
        torch.cuda.synchronize()
    assert (tne.LAUNCHES, tba.LAUNCHES) == (k2 + 1, k6 + 3)
    live = valid.any(-1)
    torch.testing.assert_close(hyb[live], fused[live], atol=1e-4, rtol=1e-4)
    assert (hyb[~live] == tne.NEG).all() and (fused[~live] == tne.NEG).all()
