"""The port's counter-based dropout (K5) on the CPU: the plain Philox4x32-10
against a pure-Python integer implementation and the published known-answer
vectors, the keep fraction, independence from how a caller splits a tensor,
and the CPU wrapper. The CUDA entry is held to these bits on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from trafficbots_tpu_torch.ops import dropout as tdo

M32 = 0xFFFFFFFF


def philox_py(c, k):
    """Philox4x32-10 on Python integers (the Random123 definition)."""
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1], p0 & M32]
    return c


@pytest.mark.parametrize("counter,key,expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_known_answers(counter, key, expect):
    assert tuple(philox_py(counter, key)) == expect
    words = tdo.philox4x32_10(*(torch.tensor([c], dtype=torch.long) for c in counter), *key)
    assert tuple(int(w) for w in words) == expect


def test_plain_philox_matches_python_integers_over_the_whole_range():
    rs = np.random.RandomState(0)
    counters = rs.randint(0, 2**32, size=(64, 4), dtype=np.uint64)
    counters[:8] = 2**32 - 1 - counters[:8] % 3  # words at the top of the range
    for key in [(0, 0), (M32, M32), (2**31, 2**31 + 1), tuple(int(x) for x in rs.randint(0, 2**32, 2, dtype=np.uint64))]:
        got = tdo.philox4x32_10(*(torch.from_numpy(counters[:, i].astype(np.int64)) for i in range(4)), *key)
        for n in range(len(counters)):
            assert [int(w[n]) for w in got] == philox_py([int(c) for c in counters[n]], key)


def test_mask_bits_follow_the_counter_layout():
    """Element (row, col) keeps iff word col % 4 of Philox((col // 4, site,
    row lo, row hi), seed) >= threshold; 64-bit rows and seeds."""
    seed, site, p = 2**62 + 977, 5, 0.1
    rows = torch.tensor([[0], [2**31 + 3], [2**40 + 12345]])
    cols = torch.arange(10)[None, :]
    f = tdo.keep_factors(seed, site, p, rows, cols)
    for i, row in enumerate(rows[:, 0].tolist()):
        for col in range(10):
            bits = philox_py([col // 4, site, row & M32, row >> 32], [seed & M32, seed >> 32])[col % 4]
            want = tdo.keep_scale(p) if bits >= tdo.threshold(p) else 0.0
            assert f[i, col].item() == want


def test_keep_fraction_and_scale():
    m = tdo.dropout_mask_plain((256, 4096), 12345, 0, 0.1)
    keep = (m > 0).double().mean().item()
    assert abs(keep - 0.9) < 0.003  # 1M draws: the binomial sd is 3e-4
    assert set(m.unique().tolist()) == {0.0, tdo.keep_scale(0.1)}
    assert tdo.keep_scale(0.1) == np.float32(1 / 0.9)


def test_mask_does_not_depend_on_how_the_tensor_is_split():
    """A logical [B, H, S, T] mask equals its [B*H*S, T] reading, and any
    block of rows and columns computed on its own (a kernel's tile)."""
    seed, site, p = 99, 2, 0.25
    full = tdo.dropout_mask_plain((2, 3, 5, 11), seed, site, p)
    assert torch.equal(full.reshape(30, 11), tdo.dropout_mask_plain((30, 11), seed, site, p))
    rows, cols = torch.arange(30).reshape(30, 1), torch.arange(11).reshape(1, 11)
    for r0, r1, c0, c1 in [(0, 7, 0, 4), (7, 30, 3, 11), (13, 14, 5, 6)]:
        tile = tdo.keep_factors(seed, site, p, rows[r0:r1], cols[:, c0:c1])
        assert torch.equal(tile, full.reshape(30, 11)[r0:r1, c0:c1])
    assert not torch.equal(full, tdo.dropout_mask_plain((2, 3, 5, 11), seed, site + 1, p))
    assert not torch.equal(full, tdo.dropout_mask_plain((2, 3, 5, 11), seed + 1, site, p))


def test_cpu_wrapper_is_the_plain_version_and_its_gradient_is_the_mask():
    x = torch.randn(4, 6, 10, requires_grad=True)
    before = tdo.LAUNCHES
    y = tdo.dropout(x, 0.3, 7, 1)
    assert tdo.LAUNCHES == before
    mask = tdo.dropout_mask_plain((4, 6, 10), 7, 1, 0.3)
    assert torch.equal(y, x * mask)
    y.sum().backward()
    assert torch.equal(x.grad, mask)
    assert tdo.dropout(x, 0.0, 7, 1) is x


def test_dropout_seeds_replay_and_saved_cores():
    a, b = tdo.DropoutSeeds(5), tdo.DropoutSeeds(5)
    seq = [a.next() for _ in range(4)]
    assert seq == [b.next() for _ in range(4)] and len(set(seq)) == 4
    assert all(0 <= s < 2**tdo.SEED_BITS for s in seq)
    saved = tdo.SavedCores()
    assert saved.take() is None
    saved.put((torch.ones(1), torch.zeros(1), torch.zeros(1)))
    tdo.DropoutSeeds(5, saved)  # the recompute rewinds the residuals
    assert saved.take()[0].item() == 1.0 and saved.take() is None


def test_keep_scale_is_the_float32_rounding_for_every_p():
    """keep_scale rounds 1 / (1 - p) to float32 without a tensor; the bits
    are those a float32 tensor holds (the kernels and the plain masks scale
    by this number)."""
    ps = [0.1, 0.2, 0.25, 0.3, 0.5, 1e-7, 0.999] + list(np.random.RandomState(0).uniform(0, 0.99, 200))
    for p in ps:
        want = float(torch.tensor(1.0 / (1.0 - p), dtype=torch.float32))
        assert tdo.keep_scale(float(p)) == want, p
        assert np.float32(tdo.keep_scale(float(p))).tobytes() == np.float32(want).tobytes()


def fused_case(shape, seed=3):
    rs = np.random.RandomState(seed)
    x, res, g = (torch.from_numpy(rs.normal(size=shape).astype(np.float32)) for _ in range(3))
    return x, res, g


@pytest.mark.parametrize("shape", [(4, 6, 10), (3, 7), (2, 5, 128)])
def test_fused_entries_on_cpu_are_their_plain_compositions(shape):
    """dropout_add = res + dropout(x), relu_dropout = relu(dropout(x)) (=
    dropout(relu(x)) value for value), forward and gradients bit for bit."""
    x, res, g = fused_case(shape)
    seed, site, p = 2**40 + 1, 2, 0.3
    before = tdo.LAUNCHES

    xx, rr = x.clone().requires_grad_(), res.clone().requires_grad_()
    out = tdo.dropout_add(rr, xx, p, seed, site)
    out.backward(g)
    xp, rp = x.clone().requires_grad_(), res.clone().requires_grad_()
    ref = rp + tdo.dropout_plain(xp, p, seed, site)
    ref.backward(g)
    assert torch.equal(out, ref) and torch.equal(xx.grad, xp.grad) and torch.equal(rr.grad, rp.grad)

    xx = x.clone().requires_grad_()
    out = tdo.relu_dropout(xx, p, seed, site)
    out.backward(g)
    xp = x.clone().requires_grad_()
    ref = torch.relu(tdo.dropout_plain(xp, p, seed, site))
    ref.backward(g)
    assert torch.equal(out, ref) and torch.equal(xx.grad, xp.grad)
    assert torch.equal(out, tdo.dropout_plain(torch.relu(x), p, seed, site))
    mask = tdo.dropout_mask_plain(shape, seed, site, p)
    assert torch.equal(xx.grad, torch.where(out > 0, g * tdo.keep_scale(p), torch.zeros_like(g)))
    assert 0 < (mask == 0).float().mean() < 0.6
    assert tdo.LAUNCHES == before
    assert torch.equal(tdo.dropout_add(res, x, 0.0, seed, site), res + x)
    assert torch.equal(tdo.relu_dropout(x, 0.0, seed, site), torch.relu(x))


def module_grads(mod, run):
    mod.zero_grad()
    out = run()
    out.backward(torch.ones_like(out))
    return [out.detach()] + [p.grad.clone() for p in mod.parameters() if p.grad is not None]


@pytest.mark.parametrize("which", ["transformer", "mlp", "mlp_layernorm_end_act"])
def test_modules_give_the_same_bits_with_kernels_and_plain_versions(which):
    """The fused K5 call sites (the residual adds and ReLUs beside dropout)
    against the plain compositions inside ops.plain_versions(), on the CPU:
    outputs and every parameter's gradient equal."""
    from trafficbots_tpu_torch import ops
    from trafficbots_tpu_torch.models.modules import MLP, TransformerCrossAttention
    from trafficbots_tpu_torch.weights import init_params

    torch.manual_seed(0)
    rs = np.random.RandomState(1)
    if which == "transformer":
        mod = TransformerCrossAttention(32, 4, 48, dropout_p=0.2)
        src = torch.from_numpy(rs.normal(size=(2, 5, 32)).astype(np.float32))
        tgt = torch.from_numpy(rs.normal(size=(2, 7, 32)).astype(np.float32))
        pad = torch.from_numpy(rs.rand(2, 7) < 0.3)
        spad = torch.from_numpy(rs.rand(2, 5) < 0.2)
        run = lambda: mod(src, src_padding_mask=spad, tgt=tgt, tgt_padding_mask=pad, rng=tdo.DropoutSeeds(4))  # noqa: E731
    else:
        ln_end = which == "mlp_layernorm_end_act"
        mod = MLP(12, [16, 16, 8], use_layernorm=ln_end, end_layer_activation=ln_end, dropout_p=0.25)
        x = torch.from_numpy(rs.normal(size=(3, 6, 12)).astype(np.float32))
        valid = torch.from_numpy(rs.rand(3, 6) < 0.7)
        run = lambda: mod(x, valid, rng=tdo.DropoutSeeds(9))  # noqa: E731
    init_params(mod, 0)
    got = module_grads(mod, run)
    with ops.plain_versions():
        ref = module_grads(mod, run)
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
