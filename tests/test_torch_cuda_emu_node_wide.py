"""K2, K2-bf16 and K4 at the other widths they take, as CUDA source run on
the CPU against their plain versions.

As tests/test_torch_cuda_emu_node.py does at d_model = d_ff = 128 and 4
heads: compiles `csrc/node_encoder.cu` and `csrc/node_encoder_train.cu`
with g++ against the CUDA emulator in `tests/cuda_emu/`, once a width pair
(`-DTB_NODE_D`, `-DTB_NODE_F`: ops.node_encoder.build_defines), and holds
the kernels at (d_model, d_ff, n_head) = (256, 128, 4) (d_head 64: two
threads a (head, row), their dot products summed by a lane shuffle),
(256, 256, 8), (128, 256, 4) (the FFN rectangular both ways),
(128, 128, 2) (d_head 64 at the default width), and at d_head 128 (four
threads a (head, row), two levels of shuffles) (256, 128, 2) and
(128, 128, 1) against their plain versions: polylines of 5 nodes, among
which an all-padding and a partly valid one, 2 layers, a few groups of
polylines so that a walk block takes more than one. A build refuses the
widths it was not built for, and d_head 256 (the refusal test keeps its
name from when d_head 128 was refused).

Tolerances as in that file: K2 and K4's forward within atol = rtol = 1e-4
of the plain versions; K2-bf16 within a relative norm error of 1e-3 of its
plain version's bf16 function; K4's backward (dx and the 18 weight
gradients) within a relative norm error of 1e-3 of autograd through the
plain version, each gradient against its own norm or 1e-3 of the largest;
the backward with dropout live bitwise equal over two calls, padding
nodes' dx exactly 0;
K4f at p = 0 K2 to the bit.
"""
import ctypes

import pytest
import torch

from trafficbots_tpu_torch.ops import node_encoder as tne
from trafficbots_tpu_torch.ops import node_encoder_train as tnt

from test_torch_cuda_emu_node import build_emulated, encoder, inputs, k2, k4_bwd, k4_fwd, weight_ptrs

WIDTHS = [(256, 128, 4), (256, 256, 8), (128, 256, 4), (128, 128, 2), (256, 128, 2), (128, 128, 1)]
NL = 2  # layers
BP = 14  # polylines: 3 groups of 6 at a width of 256 (32 rows), 2 of 12 at 128 x 128


def key(d_model, d_ff, name):
    return f"{name}_{d_model}x{d_ff}"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """(name, d_model, d_ff) -> the emulator's build of csrc/<name>.cu at
    those widths."""
    builds = {}
    for d_model, d_ff in sorted({w[:2] for w in WIDTHS}):
        for name in ("node_encoder", "node_encoder_train"):
            builds[key(d_model, d_ff, name)] = (name, list(tne.build_defines(d_model, d_ff)))
    return build_emulated(tmp_path_factory.mktemp("cuda_emu_node_wide"), builds)


def case(widths):
    d_model, d_ff, n_head = widths
    enc = encoder(d_model=d_model, n_head=n_head, n_layer=NL, d_ff=d_ff)
    x, valid, g = inputs(BP, d_model=d_model)
    return enc, x, valid, g


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_k2_wide_emulated_matches_plain(emulated, widths):
    enc, x, valid, _ = case(widths)
    out = k2(emulated[key(*widths[:2], "node_encoder")], enc, x, valid)
    with torch.no_grad():
        ref = enc.pooled_plain(x, valid)
    live = valid.any(-1)
    torch.testing.assert_close(out[live], ref[live], atol=1e-4, rtol=1e-4)
    assert (out[~live] == tne.NEG).all()


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_k2_bf16_wide_emulated_matches_plain(emulated, widths, record_property):
    """Within a relative norm error of 1e-3 of the plain version's bf16
    function over the live polylines (3.4e-4 at d_model 256, where the
    fp32 sums' other order moves a few operands across a bf16 rounding
    boundary; 0 at 128)."""
    enc, x, valid, _ = case(widths)
    out = k2(emulated[key(*widths[:2], "node_encoder")], enc, x, valid, bf16=True)
    with torch.no_grad():
        ref = enc.pooled_plain(x, valid, bf16=True)
        ref32 = enc.pooled_plain(x, valid)
    live = valid.any(-1)
    err = ((out[live] - ref[live]).norm() / ref[live].norm()).item()
    record_property("rel_norm_err", err)
    assert err < 1e-3, err
    # the fp32 function lies past the tolerance (3.2e-3 to 3.4e-3 here), so
    # the hold tells an unrounded product from a rounded one
    assert ((ref32[live] - ref[live]).norm() / ref[live].norm()).item() > 2e-3
    assert (out[~live] == tne.NEG).all()


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_k4_wide_emulated_matches_plain(emulated, widths, p):
    """K4f and K4b (2 walk blocks over 2 or 3 groups) with dropout off and
    live, against the plain version and autograd; K4b with dropout live
    twice, bitwise equal; K4f at p = 0 K2 to the bit."""
    lib, seed = emulated[key(*widths[:2], "node_encoder_train")], 2**40 + 3
    enc, x, valid, g = case(widths)
    live = valid.any(-1)
    g = g * live[:, None]
    out = k4_fwd(lib, enc, x, valid, p, seed)
    xx = x.clone().requires_grad_()
    ref = tnt.node_encoder_train_plain(enc, xx, valid, p, seed)
    torch.testing.assert_close(out[live], ref.detach()[live], atol=1e-4, rtol=1e-4)
    assert (out[~live] == tne.NEG).all()
    if p == 0.0:
        assert torch.equal(out, k2(emulated[key(*widths[:2], "node_encoder")], enc, x, valid))
    leaves = [xx] + [getattr(enc, n) for n in tne.W_NAMES]
    ref_grads = torch.autograd.grad(ref, leaves, g)
    got = k4_bwd(lib, enc, x, valid, g, p, seed, nblocks=2)
    scale = max(r.norm().item() for r in ref_grads)
    for name, a, b in zip(["dx"] + list(tne.W_NAMES), got, ref_grads):
        err = (a - b).norm().item()
        assert err <= 1e-3 * max(b.norm().item(), 1e-3 * scale), (name, err, b.norm().item())
    assert (got[0][~valid] == 0).all()
    if p > 0:  # the dropout keys and the fixed-order sums: the same bits on a second call
        again = k4_bwd(lib, enc, x, valid, g, p, seed, nblocks=2)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_a_build_refuses_other_widths_and_d_head_128(emulated):
    """Each C entry returns cudaErrorInvalidValue (1) for widths its build
    does not hold, and for d_head 256 (256 wide, 1 head), as the
    predicate refuses them; the wrappers never reach a build that would.
    d_head 128 (256 wide with 2 heads, 128 wide with 1), which the
    entries once refused here, they now take."""
    enc, x, valid, _ = case((256, 128, 4))
    wrong = emulated[key(256, 256, "node_encoder")]
    fn = wrong.tb_node_encoder
    fn.argtypes, fn.restype = list(tne._ARGS), ctypes.c_int
    out = torch.empty(BP, 256)
    assert fn(x.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, 5, NL, 4, 256, 128, weight_ptrs(enc), None) == 1
    lib = emulated[key(256, 128, "node_encoder")]
    fn = lib.tb_node_encoder
    fn.argtypes, fn.restype = list(tne._ARGS), ctypes.c_int
    assert fn(x.data_ptr(), valid.data_ptr(), out.data_ptr(), BP, 5, NL, 1, 256, 128, weight_ptrs(enc), None) == 1
    assert tne.kernel_refusal(5, 256, 128, 1) is not None
    assert tne.kernel_refusal(5, 256, 128, 2) is None and tne.kernel_refusal(5, 128, 128, 1) is None
    train = emulated[key(256, 128, "node_encoder_train")]
    fs = train.tb_node_encoder_train_scratch
    fs.argtypes, fs.restype = list(tnt._SCRATCH_ARGS), ctypes.c_int
    n = ctypes.c_longlong()
    assert fs(BP, 5, NL, 1, 256, 128, 2, ctypes.byref(n)) == 1
    assert fs(BP, 5, NL, 4, 128, 128, 2, ctypes.byref(n)) == 1
    assert fs(BP, 5, NL, 64, 256, 128, 2, ctypes.byref(n)) == 0
    assert fs(BP, 5, NL, 2, 256, 128, 2, ctypes.byref(n)) == 0
