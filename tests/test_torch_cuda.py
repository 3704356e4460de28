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
"""
import dataclasses

import numpy as np
import pytest
import torch

from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.config import ExperimentConfig
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch
from trafficbots_tpu_torch.ops import fused_attention as tfa
from trafficbots_tpu_torch.ops import node_encoder as tne
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
