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
The bf16 variants (K1, K2, K6 under precision="bf16" / kernel_matmul_bf16)
against their plain versions' bf16 functions within a relative norm error
of 1e-3: the operands are rounded alike, but an intermediate on a bf16
rounding boundary (an attention weight after the card's expf, a sum in
another order) lands one bf16 ulp, 3.9e-3 relative, away (chip_smoke.py
phase 6c prints how many elements differ and the largest gap).
The MMA layout check (csrc/mma.cuh through tests/cuda_emu/mma_check.cu)
within a relative norm error of 1e-6 of torch.matmul: fp32 sums of exact
products in another order (a wrong fragment layout moves C by O(1)). The
backward kernels are bitwise the same run to run; K5's fused entries
(dropout_add, relu_dropout) equal their plain compositions bit for bit. K6 (the hybrid node
encoder's attention core) within 1e-5 of its plain version on the rows of
polylines with a valid node, every row finite; the hybrid node encoder
(K6) against the fused one (K2) within 1e-4, as K2 against its plain
version.
"""
import contextlib
import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch

from trafficbots_tpu_torch import ops
from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.config import ExperimentConfig
from trafficbots_tpu_torch.data.preprocessing import to_torch
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch
from trafficbots_tpu_torch.ops import attention_train as tat
from trafficbots_tpu_torch.ops import cuda_build
from trafficbots_tpu_torch.ops import block_attn as tba
from trafficbots_tpu_torch.ops import dropout as tdo
from trafficbots_tpu_torch.ops import fused_attention as tfa
from trafficbots_tpu_torch.ops import node_encoder as tne
from trafficbots_tpu_torch.ops import node_encoder_train as tnt
from trafficbots_tpu_torch.weights import init_params

from test_torch_cuda_emu_mma import (MMA_RTOL, MMA_SOURCE, mma_operands, pack_inputs, run_mma_check, run_mma_check_k8,
                                    run_pack_check)


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
def test_mma_layout_on_the_card(cuda, tmp_path):
    """tests/cuda_emu/mma_check.cu built by nvcc (csrc/mma.cuh's mma.sync
    and fragment loads, its bf16x2 conversion): the answers the CPU
    emulator's test holds, here from the hardware, so the emulator's
    fragment layout is the card's."""
    lib = tmp_path / "libmma_check.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{cuda_build.CSRC}", "-o", str(lib),
                    str(MMA_SOURCE)], check=True)
    lib = ctypes.CDLL(str(lib))
    stream = torch.cuda.current_stream().cuda_stream
    for M, N, K in ((16, 8, 16), (64, 128, 128)):
        a, b, bt, ref = mma_operands(M, N, K, seed=M + N + K)
        outs = run_mma_check(lib, a.to(cuda), b.to(cuda), bt.to(cuda), stream)
        torch.cuda.synchronize()
        for c in outs:
            assert ((c.cpu() - ref).norm() / ref.norm()).item() <= MMA_RTOL
    for M, N, K in ((16, 8, 8), (32, 128, 8), (64, 24, 40)):  # m16n8k8
        a, _, bt, ref = mma_operands(M, N, K, seed=M + N + K + 1)
        c = run_mma_check_k8(lib, a.to(cuda), bt.to(cuda), stream)
        torch.cuda.synchronize()
        assert ((c.cpu() - ref).norm() / ref.norm()).item() <= MMA_RTOL
    x, want = pack_inputs()
    got = run_pack_check(lib, x.to(cuda), stream)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


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
@pytest.mark.parametrize("B,S,T,H,bf16", [
    (48, 64, 1024, 4, True),  # the joint futures' rollout as2pl: path S, eight ranks
    (2, 37, 1000, 4, False),  # S and T off the tiles, path S
    (2, 37, 1000, 8, True),  # d_head 16, path S
    (2, 100, 300, 2, False),  # d_head 64, path L
    (2, 1024, 1024, 8, True),  # d_head 16, path L
    (2, 70, 1024, 2, True),  # d_head 64, path L
])
def test_k1_kernel_matches_plain_on_both_paths(cuda, B, S, T, H, bf16):
    """K1's two paths (the cluster over T, the 32-row blocks) at every head
    width, with a padding mask (stride 0) and a full mask: within 1e-5 of
    the plain version, two calls bitwise equal."""
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, T, 128, seed=7))
    if bf16:
        k, v = k.bfloat16(), v.bfloat16()
    pad = invalid[:, 0]
    for inv in (pad[:, None, :].expand(B, S, T), invalid):
        out = tfa.fused_attention_core(q, k, v, inv, H)
        again = tfa.fused_attention_core(q, k, v, inv, H)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        torch.testing.assert_close(out, tfa.attention_core_plain(q, k, v, inv, H), atol=1e-5, rtol=1e-5)


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H", [
    (8, 64, 1024, 4),  # the rollout as2pl: path S, eight ranks
    (2, 37, 1000, 8),  # d_head 16, path S
    (2, 1024, 1024, 4),  # the map self-attention: path L, blocks walk the row blocks
    (2, 1216, 1024, 4),  # the latent as2pl
    (2, 70, 1024, 2),  # d_head 64, path L: V in K's place
])
def test_k1_bf16_kernel_matches_plain(cuda, B, S, T, H):
    """K1's bf16 variant on both paths with a padding and a full mask: a
    bf16 output within a relative norm error of 1e-3 of the plain
    version's, all-masked rows 0, two calls bitwise equal, one launch each
    counted in LAUNCHES_BF16 and none in LAUNCHES."""
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, T, 128, seed=8))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    pad = invalid[:, 0]
    for inv in (pad[:, None, :].expand(B, S, T), invalid):
        before, before32 = tfa.LAUNCHES_BF16, tfa.LAUNCHES
        out = tfa.fused_attention_core(q, k, v, inv, H)
        again = tfa.fused_attention_core(q, k, v, inv, H)
        torch.cuda.synchronize()
        assert (tfa.LAUNCHES_BF16, tfa.LAUNCHES) == (before + 2, before32)
        assert out.dtype == torch.bfloat16 and torch.equal(out, again)
        ref = tfa.attention_core_plain(q, k, v, inv, H)
        assert rel_norm(out, ref) < 1e-3
        assert (out[inv.all(-1)] == 0).all()


@pytest.mark.cuda
def test_k2_bf16_kernel_matches_plain(cuda):
    x, valid = (torch.from_numpy(a).to(cuda) for a in node_inputs(BP=1024, N=20, D=128, seed=6))
    tmod = perturbed_encoder().to(cuda)
    before = tne.LAUNCHES_BF16
    with torch.no_grad():
        out = tmod.encode_pooled(x, valid, bf16=True)
        torch.cuda.synchronize()
        ref = tmod.pooled_plain(x, valid, bf16=True)
    assert tne.LAUNCHES_BF16 == before + 1
    live = valid.any(-1)
    assert rel_norm(out[live], ref[live]) < 1e-3
    assert (out[~live] == tne.NEG).all()


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


# (d_model, d_ff, n_head) the node kernels take beside the default
# 128 x 128 at 4 heads: a width of 256 (d_head 64, two threads a (head,
# row)), the FFN rectangular both ways, 2 heads (d_head 64) and 16 heads
# (d_head 8) at 128, and d_head 128 (four threads a (head, row)) at 256 x
# 128 with 2 heads and at 128 x 128 with 1
OTHER_WIDTHS = [(256, 128, 4), (256, 256, 4), (128, 256, 4), (128, 128, 2), (128, 128, 16), (256, 128, 2),
                (128, 128, 1)]


def wide_encoder(D, Fd, H, seed=1):
    enc = tne.FusedNodeEncoder(D, H, 3, Fd)
    init_params(enc, 0)
    with torch.no_grad():
        for name in tne.W_NAMES:
            p = getattr(enc, name)
            if p.ndim == 2:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)))
    return enc


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("widths", OTHER_WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_k2_kernels_match_plain_at_other_widths(cuda, widths, bf16):
    """K2 (atol = rtol = 1e-4) and K2-bf16 (relative norm error 1e-3) at
    the other widths, each width pair's own build, at their 128 x 128
    holds."""
    D, Fd, H = widths
    x, valid = (torch.from_numpy(a).to(cuda) for a in node_inputs(BP=1024, N=20, D=D, seed=6))
    enc = wide_encoder(D, Fd, H).to(cuda)
    before = tne.LAUNCHES_BF16 if bf16 else tne.LAUNCHES
    with torch.no_grad():
        out = enc.encode_pooled(x, valid, bf16=bf16)
        torch.cuda.synchronize()
        ref = enc.pooled_plain(x, valid, bf16=bf16)
    assert (tne.LAUNCHES_BF16 if bf16 else tne.LAUNCHES) == before + 1
    live = valid.any(-1)
    if bf16:
        assert rel_norm(out[live], ref[live]) < 1e-3
    else:
        torch.testing.assert_close(out[live], ref[live], atol=1e-4, rtol=1e-4)
    assert (out[~live] == tne.NEG).all()


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


@pytest.mark.cuda
def test_hidden_256_on_the_card_launches_or_raises(cuda, record_property):
    """hidden_dim 256 with 4 heads (d_head 64) on a small config. The
    hybrid node encoder's eval rollout launches K1 and K6 and agrees with
    the same rollout through the plain versions on the card within 1e-3 m
    over the first 30 steps (the 10 warm-up and 20 closed-loop steps),
    validity equal there: chip_smoke.py's hold. Beside it are recorded the
    one-ulp map nudge of that reference and the CPU's plain run, readings
    of how far the closed loop carries an ulp. A training step with
    fused_train_kernel off (the JAX package's XLA node stack) launches K3
    and not K4, its loss within 1e-5 and its gradients within a relative
    norm error of 1e-2 of the plain versions' (chip_smoke.py's training
    holds). K2 and K4 take d_model 256 at 4 heads and at 2 heads (d_head
    128) and launch; at 1 head (d_head 256) their wrappers raise with their
    predicates' reasons and launch nothing."""
    cfg = ExperimentConfig()
    data = dataclasses.replace(cfg.data, n_agent=32, n_pl=256, n_tl=16, n_tl_stop=8, n_step=41)
    tf = dataclasses.replace(cfg.model.tf_cfg, d_model=256, d_feedforward=256)
    me = dataclasses.replace(cfg.model.map_encoder, node_encoder_impl="hybrid", fused_train_kernel=False)
    cfg = dataclasses.replace(cfg, data=data, time_step_end=40, time_step_gt=40, model=dataclasses.replace(
        cfg.model, hidden_dim=256, tf_cfg=tf, map_encoder=me))
    batch = synthetic_episode_batch(data, n_scene=2, seed=1, n_valid_pl=192, n_valid_agent=20)
    model = TO.make_model(cfg, device=cuda, seed=1)
    tfa.LAUNCHES = tba.LAUNCHES = tne.LAUNCHES = 0
    out = TO.eval_rollout(cfg, model, batch, device=cuda)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES > 0 and tba.LAUNCHES > 0 and tne.LAUNCHES == 0
    with ops.plain_versions():
        ref = TO.eval_rollout(cfg, model, batch, device=cuda)
        nudge = TO.eval_rollout(cfg, model, dict(batch, **{
            "map/pos": np.nextafter(batch["map/pos"], np.float32(np.inf))}), device=cuda)
    cpu = TO.eval_rollout(cfg, TO.make_model(cfg, device="cpu", seed=1), batch, device="cpu")
    p, r = out.preds.cpu(), ref.preds.cpu()
    assert torch.isfinite(p).all()
    record_property("kernels_vs_plain_30_m", (p - r)[:, :, :30].abs().max().item())
    record_property("nudge_vs_plain_30_m", (nudge.preds.cpu() - r)[:, :, :30].abs().max().item())
    record_property("kernels_vs_cpu_30_m", (p - cpu.preds)[:, :, :30].abs().max().item())
    np.testing.assert_allclose(p[:, :, :30].numpy(), r[:, :, :30].numpy(), atol=1e-3, rtol=0)
    assert torch.equal(out.valid[:, :, :30], ref.valid[:, :, :30])

    def step(plain):
        m = TO.make_model(cfg, device=cuda, seed=1)
        with ops.plain_versions() if plain else contextlib.nullcontext():
            loss, _ = TO.training_step(cfg, m, to_torch(batch, cuda), torch.Generator().manual_seed(3))
            loss.backward()
        return loss.item(), {n: q.grad for n, q in m.named_parameters() if q.grad is not None}

    tat.LAUNCHES_FWD = tnt.LAUNCHES_FWD = 0
    lk, gk = step(plain=False)
    assert tat.LAUNCHES_FWD > 0 and tnt.LAUNCHES_FWD == 0
    lp, gp = step(plain=True)
    assert np.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp)
    scale = max(g.norm().item() for g in gp.values())
    for n, g in gp.items():
        assert (gk[n] - g).norm().item() <= 1e-2 * max(g.norm().item(), 1e-3 * scale), n
    enc = model.map_encoder.densetnt
    x = torch.zeros(8, 20, 256, device=cuda)
    valid = torch.ones(8, 20, dtype=torch.bool, device=cuda)
    assert tne.kernel_refusal(20, 256, 256, 4) is None and tnt.kernel_refusal(20, 256, 256, 4) is None
    with torch.no_grad():
        enc.encode_pooled(x, valid)
    tnt.node_encoder_train(enc, x, valid, 0.1, 5)
    torch.cuda.synchronize()
    assert tne.LAUNCHES == 1 and tnt.LAUNCHES_FWD == 1
    enc2 = tne.FusedNodeEncoder(256, 2, 3, 256).to(cuda)
    with torch.no_grad():
        enc2.encode_pooled(x, valid)
    tnt.node_encoder_train(enc2, x, valid, 0.1, 5)
    torch.cuda.synchronize()
    assert tne.LAUNCHES == 2 and tnt.LAUNCHES_FWD == 2
    enc1 = tne.FusedNodeEncoder(256, 1, 3, 256).to(cuda)
    with pytest.raises(ValueError) as e:
        enc1.encode_pooled(x, valid)
    assert str(e.value) == tne.kernel_refusal(20, 256, 256, 1)
    with pytest.raises(ValueError) as e:
        tnt.node_encoder_train(enc1, x, valid, 0.1, 5)
    assert str(e.value) == tnt.kernel_refusal(20, 256, 256, 1)
    assert tne.LAUNCHES == 2 and tnt.LAUNCHES_FWD == 2


@pytest.mark.cuda
def test_bf16_eval_rollout_on_the_card_launches_the_bf16_variants(cuda):
    """precision="bf16" with kernel_matmul_bf16 at the model's full width:
    the card's run launches K1's and K2's bf16 variants and never the fp32
    K1 or K2, its preds are finite, and its validity equals the CPU's plain
    run's over the first 30 steps."""
    cfg = ExperimentConfig(precision="bf16")
    data = dataclasses.replace(cfg.data, n_agent=32, n_pl=128, n_tl=16, n_tl_stop=8)
    me = dataclasses.replace(cfg.model.map_encoder, kernel_matmul_bf16=True)
    cfg = dataclasses.replace(cfg, data=data, model=dataclasses.replace(cfg.model, map_encoder=me))
    batch = synthetic_episode_batch(data, n_scene=2, seed=1, n_valid_pl=96, n_valid_agent=20)
    tfa.LAUNCHES = tfa.LAUNCHES_BF16 = tne.LAUNCHES = tne.LAUNCHES_BF16 = 0
    out = TO.eval_rollout(cfg, TO.make_model(cfg, device=cuda, seed=1), batch, device=cuda)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES_BF16 > 0 and tne.LAUNCHES_BF16 == 1 and tfa.LAUNCHES == tne.LAUNCHES == 0
    ref = TO.eval_rollout(cfg, TO.make_model(cfg, device="cpu", seed=1), batch, device="cpu")
    assert torch.isfinite(out.preds).all()
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 128), (5, 37, 130), (3, 7)])
def test_k5_fused_entries_equal_the_plain_compositions(cuda, shape):
    """dropout_add and relu_dropout against res + dropout_plain(x) and
    relu(dropout_plain(x)), forward and backward, bit for bit (C = 130 and 7:
    rows not a multiple of four, the scalar path); one launch each way."""
    rs = np.random.RandomState(4)
    x, res, g = (torch.from_numpy(rs.normal(size=shape).astype(np.float32)).to(cuda) for _ in range(3))
    seed, site, p = 2**61 + 99, 5, 0.1

    def grads(fn, *inputs):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out.backward(g)
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in leaves]

    before = tdo.LAUNCHES
    got = grads(lambda r, a: tdo.dropout_add(r, a, p, seed, site), res, x)
    assert tdo.LAUNCHES == before + 2
    ref = grads(lambda r, a: r + tdo.dropout_plain(a, p, seed, site), res, x)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    before = tdo.LAUNCHES
    got = grads(lambda a: tdo.relu_dropout(a, p, seed, site), x)
    assert tdo.LAUNCHES == before + 2
    ref = grads(lambda a: torch.relu(tdo.dropout_plain(a, p, seed, site)), x)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with torch.no_grad():  # the bare launches, no autograd Function
        assert torch.equal(tdo.dropout_add(res, x, p, seed, site), res + tdo.dropout_plain(x, p, seed, site))
        assert torch.equal(tdo.relu_dropout(x, p, seed, site), tdo.dropout_plain(torch.relu(x), p, seed, site))
        assert torch.equal(tdo.dropout(x, p, seed, site), tdo.dropout_plain(x, p, seed, site))


def dead_agents(B, S, n_live, device, n_agent=64):
    """src_invalid of agent query rows (row r is agent r % n_agent) with
    agents n_live.. dead, and scene 0 all dead."""
    src = (torch.arange(S) % n_agent >= n_live)[None].repeat(B, 1)
    src[0] = True
    return src.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,bf16", [(8, 64, False), (48, 64, True), (3, 1216, False), (3, 1216, True), (3, 1024, False)])
def test_k1_skip_kernel(cuda, B, S, bf16):
    """K1 with src_invalid (the dead-query-row skip) on both paths, on fp32 q
    with bf16 K/V and on bf16 q/k/v, with a padding mask: dead rows (and a
    scene with every row dead) exactly 0, live rows bitwise K1's without
    src_invalid, within K1's tolerance of the plain version with the same
    src_invalid (bf16: a relative norm error of 1e-3), LAUNCHES_SKIP counted."""
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, 1024, 128, seed=9))
    k, v = k.bfloat16(), v.bfloat16()
    if bf16:
        q = q.bfloat16()
    inv = invalid[:, 0][:, None, :].expand(B, S, 1024)
    src = dead_agents(B, S, 40, cuda)
    before = tfa.LAUNCHES_SKIP
    out = tfa.fused_attention_core(q, k, v, inv, 4, src_invalid=src)
    base = tfa.fused_attention_core(q, k, v, inv, 4)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES_SKIP == before + 1
    live = tfa.row_live(inv, src)
    assert (out[~live] == 0).all() and torch.equal(out[live], base[live])
    ref = tfa.attention_core_plain(q, k, v, inv, 4, src)
    if bf16:
        assert rel_norm(out, ref) < 1e-3
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def k3_case(cuda, B, S, T, full_mask, seed=11):
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, T, 128, seed=seed))
    if not full_mask:
        invalid = invalid[:, 0][:, None, :].expand(B, S, T)
    g = torch.randn(B, S, 128, generator=torch.Generator().manual_seed(seed)).to(cuda)
    return q, k, v, invalid, g


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,full_mask", [
    (8, 64, 1024, False),  # the rollout's as2pl: 16-row dq blocks, four key groups
    (2, 1216, 1024, False),  # the posterior latent's as2pl: 64-row dq blocks
    (2, 1024, 1024, False),  # the map self-attention
    (2, 48, 300, True),  # partial tiles, an all-masked row and scene
    (3, 100, 260, True),
    (48, 64, 1024, False),  # 48 scenes at the rollout's as2pl: path S
    (2, 37, 1000, True),  # S and T off the tiles, path S
])
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
        assert (got[1][0, 2] == 0).all()
        assert (got[2][1] == 0).all() and (got[3][1] == 0).all()  # no row of scene 1 attends: dk, dv 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,D,H", [(8, 64, 1024, 256, 4), (2, 1024, 1024, 256, 4), (2, 1216, 1024, 128, 2)])
def test_k3_kernels_match_plain_at_d_head_64(cuda, B, S, T, D, H):
    """K3 at d_head 64 (hidden 256 with 4 heads, or 2 heads of width 128),
    dropout live, at K3's holds."""
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, T, D, seed=13))
    invalid = invalid[:, 0][:, None, :].expand(B, S, T)
    g = torch.randn(B, S, D, generator=torch.Generator().manual_seed(13)).to(cuda)

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv, invalid, H, 0.1, 987654321, 3)
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


def k1_holds(cuda, B, S, T, D, H, seed):
    """K1 (fp32 and bf16 K/V), K1-bf16 and both skips at one shape, with a
    padding and a full mask: K1 within 1e-5 of the plain version, K1-bf16
    within a relative norm error of 1e-3, two calls bitwise equal; with
    src_invalid dead rows 0 and live rows bitwise the unskipped kernel's."""
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, T, D, seed=seed))
    src = dead_agents(B, S, 40, cuda)
    for inv in (invalid[:, 0][:, None, :].expand(B, S, T), invalid):
        for qq, kv in ((q, torch.float32), (q, torch.bfloat16), (q.bfloat16(), torch.bfloat16)):
            kk, vv = k.to(kv), v.to(kv)
            counts = (tfa.LAUNCHES, tfa.LAUNCHES_BF16, tfa.LAUNCHES_SKIP)
            out = tfa.fused_attention_core(qq, kk, vv, inv, H)
            again = tfa.fused_attention_core(qq, kk, vv, inv, H)
            skip = tfa.fused_attention_core(qq, kk, vv, inv, H, src_invalid=src)
            torch.cuda.synchronize()
            bf16 = qq.dtype == torch.bfloat16
            assert (tfa.LAUNCHES, tfa.LAUNCHES_BF16, tfa.LAUNCHES_SKIP) == (
                counts[0] + 3 * (not bf16), counts[1] + 3 * bf16, counts[2] + 1)
            assert torch.equal(out, again)
            ref = tfa.attention_core_plain(qq, kk, vv, inv, H)
            if bf16:
                assert rel_norm(out, ref) < 1e-3
            else:
                torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
            live = tfa.row_live(inv, src)
            assert (skip[~live] == 0).all() and torch.equal(skip[live], out[live])


def k3_holds(cuda, B, S, T, D, H, seed):
    """K3f, K3b and K3-skip at one shape, dropout live, at K3's holds; the
    forward and backward bitwise the same on a second call."""
    q, k, v, invalid = (torch.from_numpy(a).to(cuda) for a in attn_inputs(B, S, T, D, seed=seed))
    invalid = invalid[:, 0][:, None, :].expand(B, S, T)
    src = dead_agents(B, S, 40, cuda)
    live = tfa.row_live(invalid, src)
    g = torch.randn(B, S, D, generator=torch.Generator().manual_seed(seed)).to(cuda) * live[..., None]

    def run(fn, src_invalid=None):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv, invalid, H, 0.1, 987654321, 3, src_invalid=src_invalid)
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
    assert all(torch.equal(a, b) for a, b in zip(got, run(tat.attention_train)))
    skip = run(tat.attention_train, src)
    assert (skip[0][~live] == 0).all() and torch.equal(skip[0][live], got[0][live])
    for a, b in zip(skip[1:], got[1:]):
        assert torch.equal(a + 0.0, b + 0.0)


# d_head 128 (hidden 256 with 2 heads): the rollout as2pl (path S; K1-bf16
# at B = 48 on path L), the map self-attention and the latent as2pl (path L)
D_HEAD_128 = [(8, 64, 1024), (48, 64, 1024), (2, 1024, 1024), (2, 1216, 1024), (2, 37, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T", D_HEAD_128)
def test_k1_kernels_match_plain_at_d_head_128(cuda, B, S, T):
    """K1 (fp32 and bf16 K/V), K1-bf16 and both skips at d_head 128 (k1_holds)."""
    k1_holds(cuda, B, S, T, 256, 2, seed=17)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T", D_HEAD_128)
def test_k3_kernels_match_plain_at_d_head_128(cuda, B, S, T):
    """K3f, K3b and K3-skip at d_head 128, dropout live (k3_holds)."""
    k3_holds(cuda, B, S, T, 256, 2, seed=19)


# d_head 8 and 4 (hidden 128 with 16 and 32 heads): the rollout as2pl
# (path S; K1-bf16 at B = 48 on path L), the map self-attention and the
# latent as2pl (path L), T = 2,048 (path G; K1-bf16's rounds), and a small
# odd shape
NARROW_HEADS = [(8, 64, 1024, 128, 16), (48, 64, 1024, 128, 32), (2, 1024, 1024, 128, 32), (2, 1216, 1024, 128, 16),
                (2, 1216, 2048, 128, 32), (8, 64, 2048, 128, 16), (2, 37, 300, 128, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,D,H", NARROW_HEADS)
def test_k1_kernels_match_plain_at_narrow_heads(cuda, B, S, T, D, H):
    """K1 (fp32 and bf16 K/V), K1-bf16 and both skips at d_head 8 and 4 (k1_holds)."""
    k1_holds(cuda, B, S, T, D, H, seed=31)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,D,H", NARROW_HEADS)
def test_k3_kernels_match_plain_at_narrow_heads(cuda, B, S, T, D, H):
    """K3f, K3b (its narrow kernels) and K3-skip at d_head 8 and 4, dropout live (k3_holds)."""
    k3_holds(cuda, B, S, T, D, H, seed=37)


# past 1,024 keys (data.n_pl = 2048): the rollout as2pl, the map
# self-attention and the latent as2pl at T = 2048, at d_head 32 (the default
# widths) and 128 (hidden 256 with 2 heads); the rollout as2pl at T = 4096
LONG_T = [(8, 64, 2048, 128, 4), (2, 2048, 2048, 128, 4), (2, 1216, 2048, 128, 4), (4, 64, 4096, 128, 4),
          (8, 64, 2048, 256, 2), (2, 1216, 2048, 256, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,D,H", LONG_T)
def test_k1_kernels_match_plain_at_long_T(cuda, B, S, T, D, H):
    """K1 (fp32 and bf16 K/V, path G), K1-bf16 (its rounds of key tiles)
    and both skips past 1,024 keys (k1_holds)."""
    k1_holds(cuda, B, S, T, D, H, seed=23)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,D,H", LONG_T)
def test_k3_kernels_match_plain_at_long_T(cuda, B, S, T, D, H):
    """K3f (path G), K3b and K3-skip past 1,024 keys, dropout live (k3_holds)."""
    k3_holds(cuda, B, S, T, D, H, seed=29)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T", [(8, 64, 1024), (3, 1024, 1024), (3, 1216, 1024)])
def test_k3_skip_kernels(cuda, B, S, T):
    """K3 with src_invalid, dropout live, the cotangent 0 on dead rows: the
    output's live rows bitwise those without it and dead rows 0; dq, dk, dv
    bitwise those without it (up to the sign of a zero) and within K3's
    holds of autograd through the plain version; the skip counters."""
    q, k, v, invalid, g = k3_case(cuda, B, S, T, False)
    src = (torch.arange(S) >= 3 * S // 4)[None].repeat(B, 1).to(cuda) if S == T else dead_agents(B, S, 40, cuda)
    live = tfa.row_live(invalid, src)
    g = g * live[..., None]

    def run(fn, src_invalid):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv, invalid, 4, 0.1, 987654321, 3, src_invalid=src_invalid)
        out.backward(g)
        torch.cuda.synchronize()
        return out.detach(), qq.grad, kk.grad, vv.grad

    f0, b0 = tat.LAUNCHES_FWD_SKIP, tat.LAUNCHES_BWD_SKIP
    got = run(tat.attention_train, src)
    assert (tat.LAUNCHES_FWD_SKIP, tat.LAUNCHES_BWD_SKIP) == (f0 + 1, b0 + 1)
    base = run(tat.attention_train, None)
    assert (got[0][~live] == 0).all() and torch.equal(got[0][live], base[0][live])
    for a, b in zip(got[1:], base[1:]):
        assert torch.equal(a + 0.0, b + 0.0)
    ref = run(tat.attention_train_plain, src)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
        assert rel_err(a, b) < 1e-5, name


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


@pytest.mark.cuda
@pytest.mark.parametrize("widths", OTHER_WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_k4_kernels_match_plain_at_other_widths(cuda, widths):
    """K4f and K4b at the other widths with dropout live, at the 128 x 128
    holds: the forward within 1e-4, each gradient within 1e-3 of its norm
    (or of 1e-3 of the largest), padding nodes' dx 0, a second backward
    bitwise equal, and K4f at p = 0 K2 to the bit."""
    D, Fd, H = widths
    x, valid = (torch.from_numpy(a).to(cuda) for a in node_inputs(BP=1024, N=20, D=D, seed=8))
    enc = wide_encoder(D, Fd, H).to(cuda)
    g = torch.randn(1024, D, generator=torch.Generator().manual_seed(2)).to(cuda)
    pl = valid.any(-1)

    def run(fn):
        enc.zero_grad()
        xx = x.clone().requires_grad_()
        out = fn(enc, xx, valid, 0.1, 2**40 + 5)
        torch.where(pl[:, None], out, torch.zeros_like(out)).backward(g)
        torch.cuda.synchronize()
        return [out.detach(), xx.grad] + [getattr(enc, n).grad.clone() for n in tne.W_NAMES]

    before = (tnt.LAUNCHES_FWD, tnt.LAUNCHES_BWD)
    got = run(tnt.node_encoder_train)
    assert (tnt.LAUNCHES_FWD, tnt.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    ref = run(tnt.node_encoder_train_plain)
    torch.testing.assert_close(got[0][pl], ref[0][pl], atol=1e-4, rtol=1e-4)
    assert (got[0][~pl] == tne.NEG).all()
    scale = max(b.norm().item() for b in ref[1:])
    errs = {name: ((a - b).norm().item(), b.norm().item())
            for name, a, b in zip(["dx"] + list(tne.W_NAMES), got[1:], ref[1:])}
    print(f"K4 gradient errors at {widths} (abs, ref norm):", errs)
    assert all(e <= 1e-3 * max(nb, 1e-3 * scale) for e, nb in errs.values()), errs
    assert (got[1][~pl] == 0).all()
    again = run(tnt.node_encoder_train)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    weights = [getattr(enc, n) for n in tne.W_NAMES]
    with torch.no_grad():
        assert torch.equal(tnt._launch_fwd(x, valid, 0.0, 5, 3, H, weights), enc.encode_pooled(x, valid))


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
@pytest.mark.parametrize("N,H", [(20, 4), (7, 8)])
def test_k6_bf16_kernel_matches_plain(cuda, N, H):
    _, valid = node_inputs(BP=1024, N=N, D=128, seed=9)
    rs = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rs.normal(size=(1024, N, 128)).astype(np.float32)).to(cuda) for _ in range(3))
    valid = torch.from_numpy(valid).to(cuda)
    before, before32 = tba.LAUNCHES_BF16, tba.LAUNCHES
    out = tba.block_attn_core(q, k, v, valid, H, bf16=True)
    torch.cuda.synchronize()
    assert (tba.LAUNCHES_BF16, tba.LAUNCHES) == (before + 1, before32)
    ref = tba.block_attn_core_plain(q, k, v, valid, H, bf16=True)
    live = valid.any(-1)
    assert torch.isfinite(out).all()
    assert rel_norm(out[live], ref[live]) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("H,bf16", [(4, False), (2, False), (4, True)])
def test_k6_kernels_match_plain_at_d_model_256(cuda, H, bf16):
    """K6 and K6-bf16 at d_model 256, at their D = 128 holds."""
    _, valid = node_inputs(BP=1024, N=20, D=256, seed=9)
    rs = np.random.RandomState(14)
    q, k, v = (torch.from_numpy(rs.normal(size=(1024, 20, 256)).astype(np.float32)).to(cuda) for _ in range(3))
    valid = torch.from_numpy(valid).to(cuda)
    before = tba.LAUNCHES_BF16 if bf16 else tba.LAUNCHES
    out = tba.block_attn_core(q, k, v, valid, H, bf16=bf16)
    torch.cuda.synchronize()
    assert (tba.LAUNCHES_BF16 if bf16 else tba.LAUNCHES) == before + 1
    ref = tba.block_attn_core_plain(q, k, v, valid, H, bf16=bf16)
    live = valid.any(-1)
    assert torch.isfinite(out).all()
    if bf16:
        assert rel_norm(out[live], ref[live]) < 1e-3
    else:
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
