"""Port conv path on the CPU: the plain XNOR-popcount GEMM against the
JAX package's Pallas kernel (``interpret=True``, as its own tests run it
on the CPU), the binarized conv against the JAX ``bnn_conv2d``
(``impl="xla"``) and both packages' sign-conv oracles, the quantizers,
and the dispatch rules.

Inputs are made with numpy from fixed seeds and go through both
packages; the JAX results are computed once per test run.  Integer paths
and the integer-valued conv outputs are bit-exact; ``dot_scaled`` is
float32 within DOT_SCALED_RTOL.  The CUDA kernel itself runs only on
the card: ``chip_smoke.py`` holds it against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbin, conv as jconv
from repro.kernels import binarize_pack as jbp, ops as jops, ref as jref
from repro.kernels import xnor_popcount as jxp
from repro_torch.core import binarize, conv, patches
from repro_torch.kernels import binarize_pack as bp, ops, xnor_popcount as xp

torch.set_num_threads(1)

MODES = ("bitcount", "dot", "dot_scaled", "binary_act")
DOT_SCALED_RTOL = 1e-6      # float32 (2z - S) * alpha: one rounding


def _i32(a) -> torch.Tensor:
    """JAX's uint32 words as the port's int32 words (the same bits)."""
    return torch.from_numpy(np.array(a).view(np.int32))


# ------------------------------------------------------ XNOR-popcount GEMM

# M=1 and N=70 (not a multiple of the CUDA kernel's 64-wide tile) occur
# at every S, and S runs over a word edge on both sides; M = 8 / 9
# straddle the kernel's CUDA-core and tensor-core routes and M = 65 its
# 64-row tile; Kw = 1, 2, 5 words are not multiples of 4, Kw = 4 is
GEMM_SHAPES = [(m, n, s) for s in (1, 31, 33, 100, 147)
               for m, n in ((1, 70), (9, 3), (8, 17), (65, 9))]


@pytest.fixture(scope="session")
def gemm_cases():
    """(M, N, S) -> (ip, wp, alpha as numpy, {mode: Pallas output})."""
    out = {}
    for m, n, s in GEMM_SHAPES:
        rng = np.random.default_rng(100 * s + m)
        x = rng.standard_normal((m, s)).astype(np.float32)
        x[0, : min(s, 3)] = 0.0                       # sign(0) = +1
        w = rng.standard_normal((n, s)).astype(np.float32)
        alpha = (rng.random(n) + 0.5).astype(np.float32)
        ip = jref.binarize_pack_ref(jnp.asarray(x))
        wp = jref.binarize_pack_ref(jnp.asarray(w))

        @jax.jit           # one compile per shape for all eight calls
        def both(ip, wp, alpha):
            return ({mode: jxp.xnor_popcount_matmul(
                        ip, wp, s, mode=mode, alpha=alpha, interpret=True)
                     for mode in MODES},
                    {mode: jops.xnor_matmul_xla(ip, wp, s, mode=mode,
                                                alpha=alpha)
                     for mode in MODES})
        pallas, xla = jax.tree.map(np.asarray,
                                   both(ip, wp, jnp.asarray(alpha)))
        out[(m, n, s)] = (ip, wp, alpha, pallas, xla)
    return out


def _assert_mode_equal(got: np.ndarray, want: np.ndarray, mode: str):
    assert got.dtype == want.dtype, mode
    if mode == "dot_scaled":
        np.testing.assert_allclose(got, want, rtol=DOT_SCALED_RTOL, atol=0,
                                   err_msg=mode)
    else:
        np.testing.assert_array_equal(got, want, err_msg=mode)


@pytest.mark.parametrize("m,n,s", GEMM_SHAPES)
def test_xnor_popcount_plain_matches_pallas(gemm_cases, m, n, s):
    ip, wp, alpha, pallas, xla = gemm_cases[(m, n, s)]
    ipt, wpt, at = _i32(ip), _i32(wp), torch.from_numpy(alpha)
    for mode in MODES:
        got = xp.xnor_popcount_matmul_torch(ipt, wpt, s, mode=mode, alpha=at)
        _assert_mode_equal(got.numpy(), pallas[mode], mode)
        # the JAX XLA oracle agrees, and so do the CPU entry points
        _assert_mode_equal(got.numpy(), xla[mode], mode)
        for same in (xp.xnor_popcount_matmul(ipt, wpt, s, mode=mode,
                                             alpha=at),
                     ops.xnor_matmul(ipt, wpt, s, mode=mode, alpha=at),
                     ops.xnor_matmul_torch(ipt, wpt, s, mode=mode, alpha=at)):
            np.testing.assert_array_equal(same.numpy(), got.numpy())
    # alpha defaults to ones, as in the Pallas wrapper
    np.testing.assert_array_equal(
        xp.xnor_popcount_matmul_torch(ipt, wpt, s, mode="dot_scaled").numpy(),
        np.asarray(jxp.xnor_popcount_matmul(ip, wp, s, mode="dot_scaled",
                                            interpret=True)))


@pytest.mark.parametrize("sms", [108, 114, 132])
def test_xnor_plan_covers_the_conv_shapes(sms):
    """The kernel's launch plan at every distinct GEMM shape of the four
    BNNs' groups == 1 layers, for cards of several SM counts: M <= 8 reads
    the packed weight on CUDA cores; K under one binary mma step takes
    the CUDA-core tiles; every other shape launches at least one wave of
    blocks, or its K is too short to split further; a split has parts of
    a multiple of 8 words, none of them empty, over 32-wide tiles."""
    from repro_torch.photonic import workloads as wl
    shapes = {(l.h_out * l.w_out, l.c_out, -(-l.s // 32))
              for make in wl.WORKLOADS.values() for l in make()
              if l.groups == 1}
    assert len(shapes) == 51
    routes = set()
    for m, n, kw in sorted(shapes):
        route, bn, parts, part_words = xp.xnor_plan(m, n, kw, sms)
        routes.add((route, bn, parts > 1))
        if m <= xp.SMALL_M:
            assert (route, parts, part_words) == (xp.ROUTE_READ, 1, kw)
            continue
        if kw < xp.MMA_STEP_WORDS:
            assert (route, parts, part_words) == (xp.ROUTE_TILE, 1, kw)
            continue
        assert route == xp.ROUTE_MMA and bn in (32, 64), (m, n, kw)
        tiles = -(-m // xp.TILE_M) * -(-n // bn)
        assert (parts - 1) * part_words < kw <= parts * part_words
        if parts == 1:
            assert part_words == kw
            assert tiles >= sms or -(-kw // 8) < 2 * xp.MIN_PART_WORDS // 8
        else:
            assert bn == 32 and part_words % 8 == 0
            assert part_words >= xp.MIN_PART_WORDS
            assert tiles * parts >= sms or part_words == xp.MIN_PART_WORDS
        if bn == 32:                        # 64-wide tiles would not fill
            assert -(-m // xp.TILE_M) * -(-n // 64) < sms
    assert routes == {(xp.ROUTE_READ, 0, False), (xp.ROUTE_TILE, 0, False),
                      (xp.ROUTE_MMA, 32, False), (xp.ROUTE_MMA, 32, True)}


def test_pack_activations_matches_jax_pack():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((13, 147)).astype(np.float32)
    x[2, :5] = 0.0
    want = np.asarray(jref.binarize_pack_ref(jnp.asarray(x)))
    for impl in ("auto", "torch"):
        got = ops.pack_activations(torch.from_numpy(x), impl=impl)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ------------------------------------------------------- patch packing

# (B, H, W, C_in, k, stride, padding, threshold): strides 1 and 2, SAME
# and VALID, C_in and S = k*k*C_in off multiples of 32 (and of 4: the
# CUDA kernel's scalar route), 1x1 and 3x3, thresholds at which the two
# padding rules differ (a padded tap is 0.0, a position past S -1.0)
PATCH_CASES = [
    (1, 8, 8, 3, 3, 1, "SAME", 0.0),
    (2, 9, 7, 5, 3, 2, "SAME", 0.0),
    (1, 8, 8, 40, 3, 2, "VALID", 0.0),
    (1, 6, 6, 33, 1, 1, "SAME", 0.0),
    (1, 7, 7, 16, 1, 2, "VALID", 0.0),
    (1, 10, 10, 4, 3, 2, "SAME", -0.5),
    (1, 5, 6, 12, 3, 1, "SAME", 0.5),
    (1, 12, 14, 3, 7, 2, "SAME", -2.0),
]


@pytest.mark.parametrize("case", PATCH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_pack_patches_plain_matches_jax_pack_of_im2col(case):
    b, h, w, cin, k, stride, padding, thr = case
    rng = np.random.default_rng(b + h + 3 * w + cin + k + stride)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    x[0, 0, 0, :] = 0.0               # an in-image zero: the 0.0 pad's bit
    jpatches = jconv._im2col(jnp.asarray(x), k, k, stride, padding)
    want = np.asarray(jbp.binarize_pack(
        jpatches.reshape(-1, jpatches.shape[-1]), threshold=thr,
        interpret=True)).view(np.int32)
    xt = torch.from_numpy(x)
    got = bp.pack_patches_torch(xt, k, k, stride, padding, threshold=thr)
    np.testing.assert_array_equal(got.numpy(), want)
    for impl in ("auto", "torch"):       # the CPU entries take it too
        np.testing.assert_array_equal(
            ops.pack_patches(xt, k, k, stride, padding, threshold=thr,
                             impl=impl).numpy(), want)
    np.testing.assert_array_equal(
        bp.pack_patches(xt, k, k, stride, padding, threshold=thr).numpy(),
        want)


def test_pack_patches_keeps_both_padding_rules():
    """Every in-image value below the threshold: a word's bits are then
    set only where a tap falls in the spatial padding (0.0 >= thr) or,
    at thr <= -1, past S (-1.0 >= thr)."""
    x = torch.full((1, 4, 4, 2), -3.0)
    s = 9 * 2                                          # one word, 14 past S
    taps_out = np.zeros((4, 4, 3, 3), bool)            # (oy, ox, i, j)
    for oy in range(4):
        for ox in range(4):
            for i in range(3):
                for j in range(3):
                    y, xx = oy - 1 + i, ox - 1 + j
                    taps_out[oy, ox, i, j] = not (0 <= y < 4 and 0 <= xx < 4)
    for thr, past_s in ((-0.5, 0), (-2.0, 1)):
        got = bp.pack_patches_torch(x, 3, 3, 1, "SAME", threshold=thr)
        words = got.numpy().view(np.uint32)[:, 0]
        for row, word in enumerate(words):
            bits = [(int(word) >> e) & 1 for e in range(32)]
            oy, ox = divmod(row, 4)
            want = [int(taps_out[oy, ox, e // 6, (e // 2) % 3])
                    for e in range(s)] + [past_s] * (32 - s)
            assert bits == want, (thr, oy, ox)


def test_conv_weight_cache_misses_after_in_place_edit():
    """The packed conv weight and its SAME border term are cached per
    weight identity and version: a second call packs nothing; an
    in-place write repacks, and the result follows the new weight."""
    x, w, stride, padding = _conv_inputs(CASES[0])
    kw = dict(stride=stride, padding=padding)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w.copy())
    before = ops.packed_weight_cache_info()["entries"]
    first = conv.bnn_conv2d(xt, wt, **kw)
    assert ops.packed_weight_cache_info()["entries"] == before + 2
    np.testing.assert_array_equal(conv.bnn_conv2d(xt, wt, **kw).numpy(),
                                  first.numpy())
    assert ops.packed_weight_cache_info()["entries"] == before + 2
    wt.neg_()                                      # a new _version
    got = conv.bnn_conv2d(xt, wt, **kw)
    assert ops.packed_weight_cache_info()["entries"] == before + 2
    want = np.asarray(jconv.bnn_conv2d(jnp.asarray(x), jnp.asarray(-w),
                                       precision="bnn", impl="xla", **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(got.numpy(), first.numpy())


# ------------------------------------------------------------ binarized conv

CASES = [
    # (B, H, W, Cin, Cout, k, stride, padding): tests/test_conv.py's rows
    (2, 8, 8, 3, 8, 3, 1, "SAME"),
    (1, 10, 10, 4, 5, 3, 2, "SAME"),
    (2, 7, 9, 2, 3, 1, 1, "VALID"),
    (1, 5, 5, 8, 4, 5, 1, "VALID"),
    (1, 4, 4, 512, 16, 3, 1, "SAME"),  # S = 4608, the paper's max
    # JAX SAME is asymmetric where PyTorch's padding=1 is not: 3x3/2 on
    # an even input pads (0, 1); the 7x7/2 stem pads (2, 3)
    (1, 8, 8, 3, 4, 3, 2, "SAME"),
    (1, 12, 14, 3, 4, 7, 2, "SAME"),
    (1, 6, 6, 5, 7, 1, 2, "SAME"),     # 1x1/2: no border correction
]


def _conv_inputs(case):
    b, h, w_, cin, cout, k, stride, padding = case
    rng = np.random.default_rng(b * 31 + cin + 7 * k + h)
    x = rng.standard_normal((b, h, w_, cin)).astype(np.float32)
    x[0, 0, 0, :] = 0.0               # a zero at the border binarizes to +1
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    return x, w, stride, padding


@pytest.fixture(scope="session")
def jax_conv():
    """case -> (dot, binary_out, sign-conv oracle) of the JAX package."""
    out = {}
    for case in CASES:
        x, w, stride, padding = _conv_inputs(case)
        kw = dict(stride=stride, padding=padding)

        @jax.jit           # one compile per case for all three calls
        def three(x, w):
            return (jconv.bnn_conv2d(x, w, precision="bnn", impl="xla", **kw),
                    jconv.bnn_conv2d(x, w, precision="bnn", impl="xla",
                                     binary_out=True, **kw),
                    jconv.reference_sign_conv2d(x, w, **kw))
        out[case] = tuple(np.asarray(a) for a in three(x, w))
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_bnn_conv_matches_jax_exactly(jax_conv, case):
    x, w, stride, padding = _conv_inputs(case)
    want_dot, want_act, want_ref = jax_conv[case]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    kw = dict(stride=stride, padding=padding)
    for impl in ("torch", "auto"):
        got = conv.bnn_conv2d(xt, wt, precision="bnn", impl=impl, **kw)
        assert got.dtype == torch.float32 and got.shape == want_dot.shape
        np.testing.assert_array_equal(got.numpy(), want_dot, err_msg=impl)
        act = conv.bnn_conv2d(xt, wt, precision="bnn", impl=impl,
                              binary_out=True, **kw)
        assert act.dtype == torch.uint8
        np.testing.assert_array_equal(act.numpy(), want_act, err_msg=impl)
    ref = conv.reference_sign_conv2d(xt, wt, **kw).numpy()
    np.testing.assert_array_equal(ref, want_ref)
    np.testing.assert_array_equal(ref, want_dot)     # the oracle holds


@pytest.mark.parametrize("size,k,stride,pads", [
    (8, 3, 2, (0, 1)),        # every ResNet18 downsampling 3x3
    (224, 7, 2, (2, 3)),      # the ResNet18 stem
    (224, 3, 2, (0, 1)),      # the MobileNet_V2 / ShuffleNet_V2 stems
    (7, 3, 2, (1, 1)),        # odd input: symmetric
    (32, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)),
])
def test_same_padding_is_jax_not_torch(size, k, stride, pads):
    assert patches.same_pads(size, k, stride) == pads
    # the JAX package's patches agree on the output size
    x = jnp.zeros((1, size, size, 1))
    jp = jconv._im2col(x, k, k, stride, "SAME")
    tp = patches.im2col(torch.zeros((1, size, size, 1)), k, k, stride,
                        "SAME")
    assert tuple(tp.shape) == tuple(jp.shape)


def test_im2col_patch_order_matches_jax():
    """Patches come out (kh, kw, C), as w.reshape(S, C_out) of HWIO."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 6, 3)).astype(np.float32)
    for k, stride, padding in ((3, 1, "SAME"), (3, 2, "SAME"), (2, 1, "VALID")):
        np.testing.assert_array_equal(
            patches.im2col(torch.from_numpy(x), k, k, stride, padding).numpy(),
            np.asarray(jconv._im2col(jnp.asarray(x), k, k, stride, padding)))


def test_binarized_layer_chain_matches_jax():
    """conv -> comparator -> {0,1} fed on as {-1,+1} -> conv, as
    tests/test_conv.py::test_binarized_cnn_layer_stack chains it."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    w1 = rng.standard_normal((3, 3, 3, 16)).astype(np.float32)
    w2 = rng.standard_normal((3, 3, 16, 8)).astype(np.float32)

    @jax.jit
    def chain(x, w1, w2):
        a1 = jconv.bnn_conv2d(x, w1, precision="bnn", impl="xla",
                              binary_out=True)
        return a1, jconv.bnn_conv2d(2.0 * a1.astype(jnp.float32) - 1.0, w2,
                                    precision="bnn", impl="xla")
    a1, want = (np.asarray(a) for a in chain(x, w1, w2))
    for impl in ("torch", "auto"):
        t1 = conv.bnn_conv2d(torch.from_numpy(x), torch.from_numpy(w1),
                             impl=impl, binary_out=True)
        np.testing.assert_array_equal(t1.numpy(), a1)
        y = conv.bnn_conv2d(binarize.b01_to_pm1(t1), torch.from_numpy(w2),
                            impl=impl)
        np.testing.assert_array_equal(y.numpy(), want)
    # and through the port's oracle: sign-conv, threshold, sign-conv
    r1 = conv.reference_sign_conv2d(torch.from_numpy(x), torch.from_numpy(w1))
    r2 = conv.reference_sign_conv2d(2.0 * (r1 > 0).float() - 1.0,
                                    torch.from_numpy(w2))
    np.testing.assert_array_equal(r2.numpy(), want)


def test_bf16_precision_is_a_float_conv():
    x, w, stride, padding = _conv_inputs(CASES[1])
    want = np.asarray(jconv.bnn_conv2d(jnp.asarray(x), jnp.asarray(w),
                                       stride=stride, padding=padding,
                                       precision="bf16"))
    got = conv.bnn_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          stride=stride, padding=padding, precision="bf16")
    # float32 on both sides; only the summation order differs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ dispatch


def test_cuda_impl_on_cpu_tensor_raises():
    x = torch.zeros((1, 4, 4, 2))
    w = torch.zeros((3, 3, 2, 3))
    with pytest.raises(ValueError, match="impl='cuda'"):
        conv.bnn_conv2d(x, w, impl="cuda")
    ip = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.xnor_matmul(ip, ip, 5, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.pack_activations(x.reshape(4, 8), impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.xnor_matmul(ip, ip, 5, impl="pallas")


def test_bnn_train_and_unknown_precision_raise():
    """bnn_train runs since training was ported (its values against JAX
    in tests/test_torch_train_core.py): zeros binarize to +1, the SAME
    padding's zeros too (no border correction, as in the JAX package),
    so every output is the tap count; an unknown precision or padding
    raises."""
    x = torch.zeros((1, 4, 4, 2))
    w = torch.zeros((3, 3, 2, 3))
    y = conv.bnn_conv2d(x, w, precision="bnn_train")
    assert y.shape == (1, 4, 4, 3)
    assert torch.equal(y, torch.full_like(y, 3 * 3 * 2))
    with pytest.raises(ValueError):
        conv.bnn_conv2d(x, w, precision="int4")
    with pytest.raises(ValueError, match="padding"):
        conv.bnn_conv2d(x, w, padding="FULL")


# ------------------------------------------------------------ quantizers


def test_sign_pm1_of_zero_is_plus_one():
    x = np.array([-2.0, -0.0, 0.0, 1e-30, -1e-30, 3.0], np.float32)
    want = np.asarray(jbin.sign_pm1(jnp.asarray(x)))
    got = binarize.sign_pm1(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [-1, 1, 1, 1, -1, 1])
    assert torch.sign(torch.tensor(0.0)) == 0     # why torch.sign is unused


def test_quantizers_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    x[0, 0] = 0.0
    b = rng.integers(0, 2, (6, 5)).astype(np.uint8)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    jx = jnp.asarray(x)
    pairs = [
        (binarize.binarize_01(xt), jbin.binarize_01(jx)),
        (binarize.pm1_to_01(binarize.sign_pm1(xt)),
         jbin.pm1_to_01(jbin.sign_pm1(jx))),
        (binarize.b01_to_pm1(bt), jbin.b01_to_pm1(jnp.asarray(b))),
        (binarize.binary_activation(torch.from_numpy(b.astype(np.int32) * 7),
                                    10),
         jbin.binary_activation(jnp.asarray(b.astype(np.int32) * 7), 10)),
    ]
    for got, want in pairs:
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(binarize.lq_scale(xt).numpy(),
                               np.asarray(jbin.lq_scale(jx)), rtol=1e-6)
    np.testing.assert_allclose(binarize.lq_scale(xt, axis=0).numpy(),
                               np.asarray(jbin.lq_scale(jx, axis=0)),
                               rtol=1e-6)
    ws, alpha = binarize.binarize_weight(xt)
    jws, jalpha = jbin.binarize_weight(jx)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=1e-6)


def test_ste_sign_gradient_matches_jax():
    x = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jbin.ste_sign(v) * 3.0))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (binarize.ste_sign(xt) * 3.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    np.testing.assert_array_equal(binarize.ste_sign(torch.from_numpy(x))
                                  .numpy(), np.asarray(jbin.sign_pm1(x)))
