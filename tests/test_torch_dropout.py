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
