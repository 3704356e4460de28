"""The kernel call sites and the kernels' shape predicates, on the CPU (no
JAX).

A call site sends every kernel site to the kernel's wrapper while
`kernels_enabled()` is True; it takes the plain version only where the JAX
package runs XLA in place of its Pallas kernel (tests/test_torch_jax_paths.py
holds those choices against the JAX package's). Each kernel module's
`kernel_refusal` answers None where its kernel takes a shape and the
reason otherwise, and its wrapper's `_check_inputs` raises with that
reason: on the card a kernel site launches its kernel or raises, never
giving way to the plain version. Kernels stay enabled here (outside
`ops.plain_versions()`), spies on the wrappers record each call's shape and
spies on the sites' plain versions each plain call's; on CPU tensors a
wrapper computes its plain version, so the runs finish.

- At `ExperimentConfig()` model widths (hidden 128, 4 heads, 20 nodes a
  polyline; 32 agents over 64 polylines in eval and 256 in training, so
  every as2pl and self-attention site is a kernel site), fp32 and bf16,
  every kernel site calls its kernel's wrapper, and every predicate admits
  its shape: K1, K2 and K6 in eval, K3 and K4 in training.
- At hidden 256 with 4 heads (d_head 64), at 2 heads of width 128
  (d_head 64), at d_head 128 (hidden 256 with 2 heads and d_ff 128,
  the override `model.hidden_dim=256` with `tf_cfg.n_head=2`; hidden 128
  with 1 head) and at d_head 8 and 4 (hidden 128 with 16 and 32 heads)
  every kernel site still calls its wrapper, and every predicate (K1, K2,
  K3, K4, K6) admits its shape.
- Each predicate refuses exactly the shapes its wrapper's `_check_inputs`
  raises on, with the same reason (meta tensors: every other check passes
  and the device check, last, raises); K2's and K4's admit every
  (d_model, d_ff) in {128, 256}^2 with d_head a multiple of 4 from 4 to
  128 and 1-32 nodes, and nothing else; K1's and K3's admit d_head 4, 8,
  16, 32, 64 and 128 and refuse d_head 1, 2 and 256.
- At `data.n_pl` 1,536 and 2,048 every eval, bf16 eval and training site
  over the map still calls its wrapper, and K1's and K3's predicates
  admit every T up to 12,288 where `jax_kernel_fits` says the JAX package
  runs its Pallas kernel (each refuses T only past its mask bits' limit,
  `LARGEST_T`).
"""
import dataclasses

import pytest
import torch

from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.config import ExperimentConfig
from trafficbots_tpu_torch.data.preprocessing import to_torch
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch
from trafficbots_tpu_torch.models import map_encoder as TME
from trafficbots_tpu_torch.models import modules as TM
from trafficbots_tpu_torch.ops import attention_train as K3
from trafficbots_tpu_torch.ops import block_attn as K6
from trafficbots_tpu_torch.ops import fused_attention as K1
from trafficbots_tpu_torch.ops import node_encoder as K2
from trafficbots_tpu_torch.ops import node_encoder_train as K4
from torch_one_thread import one_torch_thread  # noqa: E402,F401


def site_config(hidden=128, n_head=4, precision="fp32", impl="fused", training=False, d_ff=None):
    """ExperimentConfig() with its model widths (hidden / heads as given),
    32 agents over polylines of 20 nodes, 11 steps: 64 polylines in eval,
    where every attention over the map is a K1 site, 256 in training,
    where every one is a K3 site. Training runs without the transformer
    layers' dropout: the sites do not depend on it, and its masks' plain
    Philox is most of a CPU step's time."""
    cfg = ExperimentConfig()
    data = dataclasses.replace(cfg.data, n_agent=32, n_pl=256 if training else 64, n_step=16)
    m = cfg.model
    me = dataclasses.replace(m.map_encoder, node_encoder_impl=impl, kernel_matmul_bf16=precision == "bf16")
    tf = dataclasses.replace(m.tf_cfg, d_model=hidden, n_head=n_head, d_feedforward=d_ff or hidden,
                             dropout_p=0.0 if training else m.tf_cfg.dropout_p)
    model = dataclasses.replace(m, hidden_dim=hidden, tf_cfg=tf, map_encoder=me)
    return dataclasses.replace(cfg, data=data, model=model, time_step_end=11, time_step_gt=11, precision=precision)


def refusal(kernel, shape):
    """The kernel's predicate at a recorded shape."""
    if kernel.startswith("K1"):
        S, T, D, H, kv_bytes = shape
        return K1.kernel_refusal(T, D, H, kv_bytes, kernel == "K1-bf16")
    if kernel == "K3":
        S, T, D, H, _ = shape
        return K3.kernel_refusal(T, D, H)
    N, D, F, H = shape
    if kernel.startswith("K2"):
        return K2.kernel_refusal(N, D, F, H)
    if kernel == "K4":
        return K4.kernel_refusal(N, D, F, H)
    return K6.kernel_refusal(N, D, H)


def spy_sites(monkeypatch):
    """Record (kernel, shape) of each kernel wrapper call, and (S, T) of
    each plain attention core a site calls in its place."""
    calls, plain = [], []

    def attn(name, fn):
        def spy(q, k, v, invalid, n_head, *a, **kw):
            lowp = q.dtype == torch.bfloat16
            calls.append((name + ("-bf16" if lowp else ""),
                          (q.shape[1], k.shape[1], q.shape[2], n_head, k.element_size())))
            return fn(q, k, v, invalid, n_head, *a, **kw)
        return spy

    def plain_attn(fn):
        def spy(q, k, *a, **kw):
            plain.append((q.shape[1], k.shape[1]))
            return fn(q, k, *a, **kw)
        return spy

    monkeypatch.setattr(TM, "fused_attention_core", attn("K1", TM.fused_attention_core))
    monkeypatch.setattr(TM, "attention_train", attn("K3", TM.attention_train))
    monkeypatch.setattr(TM, "attention_core_plain", plain_attn(TM.attention_core_plain))
    monkeypatch.setattr(TM, "attention_train_plain", plain_attn(TM.attention_train_plain))

    def node(name, fn):
        def spy(enc, x, *a, **kw):  # the method's self, or node_encoder_train's enc
            calls.append((name + ("-bf16" if kw.get("bf16") else ""),
                          (x.shape[1], enc.d_model, enc.d_feedforward, enc.n_head)))
            return fn(enc, x, *a, **kw)
        return spy

    monkeypatch.setattr(K2.FusedNodeEncoder, "encode_pooled", node("K2", K2.FusedNodeEncoder.encode_pooled))
    monkeypatch.setattr(TME, "node_encoder_train", node("K4", TME.node_encoder_train))
    block = K2.block_attn_core

    def k6(q, k, v, valid, n_head, bf16=False):
        calls.append(("K6" + ("-bf16" if bf16 else ""), (q.shape[1], q.shape[2], q.shape[2], n_head)))
        return block(q, k, v, valid, n_head, bf16=bf16)

    monkeypatch.setattr(K2, "block_attn_core", k6)
    return calls, plain


def run_sites(cfg, monkeypatch, training):
    """-> {(kernel, shape): its predicate's answer} of every wrapper call of
    an eval rollout or a training step; no plain attention core at a kernel
    site (S >= 32 and T >= 64 in eval, T >= 256 in training)."""
    calls, plain = spy_sites(monkeypatch)
    batch = synthetic_episode_batch(cfg.data, n_scene=1, seed=0)
    model = TO.make_model(cfg, device="cpu", seed=0)
    if training:
        loss, _ = TO.training_step(cfg, model, to_torch(batch, "cpu"), torch.Generator().manual_seed(3))
        assert torch.isfinite(loss)
    else:
        out = TO.eval_rollout(cfg, model, batch, device="cpu")
        assert torch.isfinite(out.preds).all()
    t_min = 256 if training else 64
    assert not [st for st in plain if st[0] >= 32 and st[1] >= t_min], plain
    return {key: refusal(*key) for key in set(calls)}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("impl", ["fused", "hybrid"])
def test_every_eval_site_takes_its_kernel_at_default_widths(monkeypatch, precision, impl):
    sites = run_sites(site_config(precision=precision, impl=impl), monkeypatch, training=False)
    sfx = "-bf16" if precision == "bf16" else ""
    assert {kernel for kernel, _ in sites} == {"K1" + sfx, ("K6" if impl == "hybrid" else "K2") + sfx}
    assert all(reason is None for reason in sites.values()), sites


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_every_training_site_takes_its_kernel_at_default_widths(monkeypatch, precision):
    sites = run_sites(site_config(precision=precision, training=True), monkeypatch, training=True)
    assert {kernel for kernel, _ in sites} == {"K3", "K4"}
    assert all(reason is None for reason in sites.values()), sites


WIDE = {"hidden256": dict(hidden=256, n_head=4), "heads2": dict(hidden=128, n_head=2),
        "hidden256_heads2": dict(hidden=256, n_head=2, d_ff=128), "heads1": dict(hidden=128, n_head=1),
        "heads16": dict(hidden=128, n_head=16), "heads32": dict(hidden=128, n_head=32)}


@pytest.mark.parametrize("impl", ["fused", "hybrid"])
@pytest.mark.parametrize("widths", sorted(WIDE))
def test_wide_eval_sites_launch_or_raise(monkeypatch, widths, impl):
    """K1 (d_head 4, 8, 64 or 128), K6 (d_model 256, or 1-32 heads) and K2
    (the same) take the shape: every eval site launches its kernel on the
    card."""
    sites = run_sites(site_config(impl=impl, **WIDE[widths]), monkeypatch, training=False)
    kernels = {kernel: reason for (kernel, _), reason in sites.items()}
    assert set(kernels) == {"K1", "K6" if impl == "hybrid" else "K2"}
    assert all(reason is None for reason in kernels.values()), kernels


@pytest.mark.parametrize("widths", sorted(WIDE))
def test_wide_training_sites_launch_or_raise(monkeypatch, widths):
    """K3 takes d_head 4, 8, 64 and 128 and K4 takes d_model 256 and 1-32
    heads: every training site launches its kernel on the card."""
    sites = run_sites(site_config(training=True, **WIDE[widths]), monkeypatch, training=True)
    kernels = {kernel: reason for (kernel, _), reason in sites.items()}
    assert set(kernels) == {"K3", "K4"}
    assert kernels["K3"] is None and kernels["K4"] is None


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def raised(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def assert_predicate_matches_check(reason, check, device_error):
    """The wrapper's check raises the predicate's reason where it refuses,
    and only the (last) device check where it admits."""
    msg = raised(check)
    if reason is None:
        assert device_error in msg, msg
    else:
        assert msg == reason


@pytest.mark.parametrize("bf16", [False, True])
def test_k1_predicate_is_its_check(bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    for T in (64, 1024, 1025, 2048, 4096):
        for D, H in ((128, 4), (256, 4), (128, 2), (256, 2), (128, 1), (256, 1), (64, 4), (96, 4), (128, 3),
                     (128, 16), (128, 32), (64, 16), (256, 64), (128, 64), (128, 128), (96, 16)):
            for kv in ((torch.bfloat16,) if bf16 else (torch.float32, torch.bfloat16)):
                q, k = meta(2, 32, D, dtype=dt), meta(2, T, D, dtype=kv)
                reason = K1.kernel_refusal(T, D, H, k.element_size(), bf16)
                assert_predicate_matches_check(
                    reason, lambda: K1._check_inputs(q, k, k, meta(2, 32, T, dtype=torch.bool), H), "CUDA device")
    assert K1.kernel_refusal(1024, 128, 4, 2, True) is None and K1.kernel_refusal(1025, 128, 4, 2, True) is None
    for kv, bf16 in ((4, False), (2, False), (2, True)):  # d_head 128 past T = 1024 (path G); d_head 256 refused
        assert K1.kernel_refusal(1024, 256, 2, kv, bf16) is None and K1.kernel_refusal(1024, 128, 1, kv, bf16) is None
        assert K1.kernel_refusal(1025, 256, 2, kv, bf16) is None and K1.kernel_refusal(64, 256, 1, kv, bf16)
        for T in (64, 1024, 1025, 2048):  # d_head 8 and 4 wherever d_head 16 is taken; 2 and 1 refused
            if K1.kernel_refusal(T, 128, 8, kv, bf16) is None:
                assert K1.kernel_refusal(T, 128, 16, kv, bf16) is None and K1.kernel_refusal(T, 128, 32, kv, bf16) is None
            assert K1.kernel_refusal(T, 128, 64, kv, bf16) and K1.kernel_refusal(T, 128, 128, kv, bf16)


def test_k3_predicate_is_its_check():
    for T in (256, 1024, 1600, 4096):
        for D, H in ((128, 4), (256, 4), (128, 2), (256, 2), (128, 1), (256, 1), (64, 4), (128, 8), (128, 3),
                     (128, 16), (128, 32), (64, 16), (256, 64), (128, 64), (128, 128), (96, 16)):
            q, k = meta(2, 32, D), meta(2, T, D)
            assert_predicate_matches_check(K3.kernel_refusal(T, D, H),
                                           lambda: K3._check_inputs(q, k, k, meta(2, 32, T, dtype=torch.bool), H),
                                           "CUDA device")
    assert K3.kernel_refusal(1024, 128, 4) is None and K3.kernel_refusal(1024, 256, 4) is None
    assert K3.kernel_refusal(1024, 128, 2) is None and K3.kernel_refusal(1024, 256, 2) is None  # d_head 128
    assert K3.kernel_refusal(1024, 128, 1) is None and K3.kernel_refusal(1025, 256, 2) is None  # path G
    assert K3.kernel_refusal(256, 256, 1)  # d_head 256
    for T in (256, 1024, 1025, 4096):  # d_head 8 and 4 wherever d_head 16 is taken; 2 and 1 refused
        assert K3.kernel_refusal(T, 128, 16) is None and K3.kernel_refusal(T, 128, 32) is None
        assert K3.kernel_refusal(T, 256, 32) is None and K3.kernel_refusal(T, 256, 64) is None
        assert K3.kernel_refusal(T, 128, 64) and K3.kernel_refusal(T, 128, 128)


def test_k2_and_k4_predicates_are_their_checks():
    for N in (1, 20, 32, 33):
        for D, Fd, H in ((128, 128, 4), (128, 128, 8), (128, 128, 16), (128, 128, 2), (256, 256, 4), (128, 256, 4),
                         (256, 128, 4), (256, 128, 2), (256, 128, 1), (128, 128, 1), (512, 512, 8), (128, 128, 3),
                         (128, 128, 64)):
            enc = K2.FusedNodeEncoder(D, H, 1, Fd).to("meta")
            x, valid = meta(8, N, D), meta(8, N, dtype=torch.bool)
            assert_predicate_matches_check(K2.kernel_refusal(N, D, Fd, H), lambda: enc._check_inputs(x, valid),
                                           "CUDA device")
            assert_predicate_matches_check(K4.kernel_refusal(N, D, Fd, H), lambda: K4._check_inputs(enc, x, valid),
                                           "CUDA device")
    # every (d_model, d_ff) in {128, 256}^2 with d_head a multiple of 4 from 4 to 128, 1..32 nodes
    for D in (128, 256):
        for Fd in (128, 256):
            for H in range(1, 129):
                dh_ok = D % H == 0 and (D // H) % 4 == 0 and 4 <= D // H <= 128
                for N in (1, 20, 32, 33):
                    want = dh_ok and N <= 32
                    assert (K2.kernel_refusal(N, D, Fd, H) is None) == want, (N, D, Fd, H)
                    assert (K4.kernel_refusal(N, D, Fd, H) is None) == want, (N, D, Fd, H)
    assert K2.kernel_refusal(20, 128, 128, 16) is None and K4.kernel_refusal(20, 128, 128, 16) is None
    assert K2.kernel_refusal(20, 256, 128, 2) is None and K4.kernel_refusal(20, 256, 128, 2) is None  # d_head 128
    assert K2.kernel_refusal(20, 128, 128, 1) is None and K4.kernel_refusal(20, 128, 128, 1) is None
    assert K2.kernel_refusal(20, 256, 128, 1) and K4.kernel_refusal(20, 256, 256, 1)  # d_head 256
    assert K2.kernel_refusal(20, 512, 512, 8) and K4.kernel_refusal(20, 128, 64, 4)  # widths past the builds'
    assert K4.kernel_refusal(20, 128, 128, 64)  # d_head 2


def test_k6_predicate_is_its_check():
    for N in (1, 20, 32, 33):
        for D, H in ((128, 4), (128, 2), (128, 1), (256, 4), (256, 2), (256, 128), (512, 4), (64, 3), (96, 4)):
            q, valid = meta(8, N, D), meta(8, N, dtype=torch.bool)
            assert_predicate_matches_check(K6.kernel_refusal(N, D, H),
                                           lambda: K6._check_inputs(q, q, q, valid, H), "CUDA device")
    assert K6.kernel_refusal(20, 128, 2) is None and K6.kernel_refusal(20, 256, 4) is None
    assert K6.kernel_refusal(20, 256, 128) and K6.kernel_refusal(20, 512, 4)  # d_head 2 past 128; past MAXD


LONG_T_GRID = sorted({*range(128, 12289, 128), 1025, 1100, 1152, 1409, 1537, 2049, 3000})


@pytest.mark.parametrize("D", [128, 256])
def test_k1_and_k3_take_every_T_jax_runs_its_kernels_at(D):
    """For d_model 128 and 256, the heads giving each d_head the kernels
    take, the three large sites' query counts (the rollout as2pl, S = 64;
    the latent as2pl, S = 1,216; the map self-attention, S = T) and T up to
    12,288 keys: wherever `jax_kernel_fits` says the JAX package runs its
    Pallas K1 (fp32 or bf16 K/V, any row block) or K3, `kernel_refusal` is
    None, for fp32 K/V, bf16 K/V and K1-bf16 alike."""
    checked = 0
    for dh in K1._HEAD_DIMS:
        H = D // dh
        for T in LONG_T_GRID:
            for S in (64, 1216, T):
                for kv in (4, 2):
                    if any(K1.jax_kernel_fits(S, T, D, kv, rb) for rb in (-1, 0, 16)):
                        assert K1.kernel_refusal(T, D, H, kv) is None, (S, T, D, H, kv)
                        if kv == 2:
                            assert K1.kernel_refusal(T, D, H, kv, True) is None, (S, T, D, H, "bf16")
                        checked += 1
                if K3.jax_kernel_fits(S, T, D):
                    assert K3.kernel_refusal(T, D, H) is None, (S, T, D, H)
                    checked += 1
    assert checked > 1000


# the largest T (a multiple of 128) each kernel takes at d_model 128, by d_head:
# path G's mask bits (fp32 forward, K3), K1-bf16's bits and each key tile's row statistics
LARGEST_T = {4: (48512, 34176), 8: (48384, 32768), 16: (48128, 30080), 32: (46592, 24448), 64: (37504, 24064),
             128: (36096, 23424)}


@pytest.mark.parametrize("dh", sorted(LARGEST_T))
def test_largest_T_each_kernel_takes(dh):
    fp32, bf16 = LARGEST_T[dh]
    H = 128 // dh
    assert K1.kernel_refusal(fp32, 128, H) is None and K1.kernel_refusal(fp32 + 128, 128, H)
    assert K3.kernel_refusal(fp32, 128, H) is None and K3.kernel_refusal(fp32 + 128, 128, H)
    assert K1.kernel_refusal(bf16, 128, H, 2, True) is None and K1.kernel_refusal(bf16 + 128, 128, H, 2, True)


@pytest.mark.parametrize("n_pl", [1536, 2048])
@pytest.mark.parametrize("case", ["eval-fp32", "eval-bf16", "training"])
def test_long_map_sites_take_their_kernels(monkeypatch, n_pl, case):
    """At data.n_pl of 1,536 and 2,048 (the default model's widths), every
    eval site (fp32 and bf16) and every training site calls its kernel's
    wrapper, and every predicate admits its shape: no K1, K1-bf16 or K3
    site raises on the card."""
    training = case == "training"
    cfg = site_config(precision="bf16" if case == "eval-bf16" else "fp32", training=training)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_pl=n_pl))
    sites = run_sites(cfg, monkeypatch, training=training)
    attn = {key for key in sites if key[0].startswith(("K1", "K3"))}
    assert {shape[1] for _, shape in attn} == {n_pl}, attn  # every attention over the map has T = n_pl
    assert {kernel for kernel, _ in sites} == ({"K3", "K4"} if training else
                                               {"K1-bf16", "K2-bf16"} if case == "eval-bf16" else {"K1", "K2"})
    assert all(reason is None for reason in sites.values()), sites
