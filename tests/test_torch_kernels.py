"""Port kernels on the CPU: the plain versions of the fused BNN GEMM,
weight packing and paged GQA attention against the JAX package's Pallas
kernels (run with ``interpret=True``, as its own tests run them on the
CPU) and against its oracles; plus the dispatch rules.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds each one against these plain versions there.  Integer paths are
bit-exact; attention is float32 within ATOL/RTOL (summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import binarize_pack as jbp, fused_bnn as jfb
from repro.kernels import paged_attention as jpa, ref as jref
from repro.layers import attention as jattn, attn_block as jblock
from repro_torch.kernels import binarize_pack as bp, fused_bnn as fb
from repro_torch.kernels import ops, paged_attention as pa, ref

torch.set_num_threads(1)

MODES = ("bitcount", "dot", "dot_scaled", "binary_act")
ATOL = RTOL = 1e-5          # float32 attention: reduction-order rounding


def _words(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a).view(np.int32))


# ------------------------------------------------------------ BNN GEMM


# (M, S, N): every combination of M in {1, 3, 130}, S in {33, 100, 768},
# N in {5, 64}; then the rows around the kernel's CUDA-core and
# tensor-core paths (M = 2, 33) at S one bit either side of a 32-word
# K tile (4095, 4097)
FUSED_CASES = [(m, s, n) for m in (1, 3, 130) for s in (33, 100, 768)
               for n in (5, 64)] + [(2, 4095, 5), (2, 4097, 64),
                                    (33, 4095, 64), (33, 4097, 5)]


@pytest.mark.parametrize("m,s,n", FUSED_CASES)
def test_fused_bnn_plain_matches_pallas_and_ref(m, s, n):
    rng = np.random.default_rng(1000 * m + 10 * s + n)
    x = rng.standard_normal((m, s)).astype(np.float32)
    x[0, :3] = 0.0                                  # >= threshold on zeros
    w = rng.standard_normal((n, s)).astype(np.float32)
    alpha = (rng.random(n) + 0.5).astype(np.float32)
    wp_j = jref.binarize_pack_ref(jnp.asarray(w))
    ip_j = jref.binarize_pack_ref(jnp.asarray(x))
    wp_t = _i32(wp_j)
    for mode in MODES:
        got = fb.fused_bnn_matmul_torch(torch.from_numpy(x), wp_t, s,
                                        mode=mode,
                                        alpha=torch.from_numpy(alpha))
        pallas = np.asarray(jfb.fused_bnn_matmul(
            jnp.asarray(x), wp_j, s, mode=mode, alpha=jnp.asarray(alpha),
            interpret=True))
        oracle = np.asarray(jref.xnor_popcount_matmul_ref(
            ip_j, wp_j, s, mode=mode, alpha=jnp.asarray(alpha)))
        assert got.numpy().dtype == pallas.dtype == oracle.dtype, mode
        np.testing.assert_array_equal(got.numpy(), pallas, err_msg=mode)
        np.testing.assert_array_equal(got.numpy(), oracle, err_msg=mode)
        # the CPU wrapper takes the plain version (same bits)
        np.testing.assert_array_equal(
            fb.fused_bnn_matmul(torch.from_numpy(x), wp_t, s, mode=mode,
                                alpha=torch.from_numpy(alpha)).numpy(),
            pallas)
    # the port's own packed oracle agrees with the JAX one
    np.testing.assert_array_equal(
        ref.xnor_popcount_matmul_ref(_i32(ip_j), wp_t, s, "dot").numpy(),
        np.asarray(jref.xnor_popcount_matmul_ref(ip_j, wp_j, s, "dot")))


@pytest.mark.parametrize("s", [33, 100, 768])
@pytest.mark.parametrize("m", [1, 3, 130])
def test_binarize_pack_plain_matches_pallas_and_ref(m, s):
    rng = np.random.default_rng(7 * m + s)
    x = rng.standard_normal((m, s)).astype(np.float32)
    x[-1, -2:] = 0.0
    pallas = jbp.binarize_pack(jnp.asarray(x), interpret=True)
    got = bp.binarize_pack_torch(torch.from_numpy(x))
    np.testing.assert_array_equal(_words(got), _words(pallas))
    np.testing.assert_array_equal(_words(got),
                                  _words(jref.binarize_pack_ref(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _words(ref.binarize_pack_ref(torch.from_numpy(x))), _words(pallas))
    np.testing.assert_array_equal(
        _words(bp.binarize_pack(torch.from_numpy(x))), _words(pallas))


def test_binarize_pack_pad_rule_follows_pallas():
    """Positions past S are padded with -1.0 before the compare, so a
    threshold below -1 packs them as 1 bits — in both packages."""
    x = np.linspace(-3, 3, 40, dtype=np.float32)[None]
    for thr in (0.0, -2.0):
        np.testing.assert_array_equal(
            _words(bp.binarize_pack_torch(torch.from_numpy(x), thr)),
            _words(jbp.binarize_pack(jnp.asarray(x), threshold=thr,
                                     interpret=True)))


@pytest.mark.parametrize("scale", [True, False])
def test_bnn_dense_matches_jax_ops(scale):
    """ops.bnn_dense at precision bnn: the packed weight cache plus the
    fused GEMM equal the JAX package's ops.bnn_dense(impl='xla');
    precision bf16 is the float matmul."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 100)).astype(np.float32)
    w = rng.standard_normal((100, 24)).astype(np.float32)
    wt = torch.from_numpy(w.copy())
    want = np.asarray(jops.bnn_dense(jnp.asarray(x), jnp.asarray(w),
                                     precision="bnn", impl="xla", scale=scale))
    for impl in ("auto", "torch"):
        got = ops.bnn_dense(torch.from_numpy(x), wt, precision="bnn",
                            impl=impl, scale=scale).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # packed once per weight: a second call hits the cache
    before = ops.packed_weight_cache_info()["entries"]
    ops.bnn_dense(torch.from_numpy(x), wt, precision="bnn", scale=scale)
    assert ops.packed_weight_cache_info()["entries"] == before
    # an in-place write moves the weight's version: the cache repacks
    wt.neg_()
    got = ops.bnn_dense(torch.from_numpy(x), wt, precision="bnn", scale=scale)
    want = np.asarray(jops.bnn_dense(jnp.asarray(x), jnp.asarray(-w),
                                     precision="bnn", impl="xla", scale=scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ops.bnn_dense(torch.from_numpy(x), torch.from_numpy(w),
                      precision="bf16").numpy(),
        np.asarray(jops.bnn_dense(jnp.asarray(x), jnp.asarray(w),
                                  precision="bf16")), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ paged attention

# (name, B, C, H, Hkv, kv_len, q_offset, causal, window); BS=4, MB=4
PAGED_CASES = [
    ("decode", 3, 1, 4, 2, [13, 7, 1], [12, 6, 0], False, None),
    ("chunk_causal", 2, 4, 4, 4, [16, 9], [12, 5], True, None),
    ("ragged_masked_row", 3, 4, 4, 2, [11, 16, 0], [7, 12, 0], True, None),
    ("window", 2, 4, 4, 1, [16, 10], [12, 6], True, 5),
    # R = C * G above the kernel's 16-row decode tile and not a multiple
    # of its 64-row prefill tile; a window that cuts a block mid-way
    ("tile_ragged", 2, 17, 4, 2, [16, 11], [0, 0], True, None),
    ("tile_window", 2, 17, 4, 1, [16, 13], [0, 2], True, 3),
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_attention_plain_matches_pallas_and_oracle(case):
    name, b, c, h, hkv, kv_len, q_off, causal, window = case
    bs, mb, dh = 4, 4, 16
    rng = np.random.default_rng(len(name))
    nb = b * mb + 1
    q = rng.standard_normal((b, c, h, dh)).astype(np.float32)
    k = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    # unowned tail slots point at scratch block 0, as the engine's
    # padded tables do; kv_len masks them
    for i, n in enumerate(kv_len):
        table[i, -(-n // bs):] = 0
    kl, qo = np.asarray(kv_len, np.int32), np.asarray(q_off, np.int32)
    got = pa.paged_attention_torch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), kv_len=torch.from_numpy(kl),
        q_offset=torch.from_numpy(qo), causal=causal, window=window).numpy()
    pallas = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        kv_len=jnp.asarray(kl), q_offset=jnp.asarray(qo), causal=causal,
        window=window, interpret=True))
    keys = jblock.gather_blocks(jnp.asarray(k), jnp.asarray(table))
    vals = jblock.gather_blocks(jnp.asarray(v), jnp.asarray(table))
    oracle = np.asarray(jattn.attention(
        jnp.asarray(q), keys, vals, causal=causal, window=window,
        q_offset=jnp.asarray(qo), kv_len=jnp.asarray(kl), q_chunk=c,
        kv_chunk=8))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    for i, n in enumerate(kv_len):
        if n == 0:                           # fully masked: exact zeros
            assert not got[i].any() and not pallas[i].any()


# ------------------------------------------------------------ dispatch


def test_c_signatures_match_the_sources():
    """Every C entry point's ctypes argtypes (kernels/_lib.py) match its
    declaration in csrc/*.cu, argument by argument: a pointer where the
    source takes ``void*``, an int where it takes ``int``, a float where
    it takes ``float`` — a call with a missing or extra argument would
    otherwise fail only on the card."""
    import ctypes
    import re
    from repro_torch.kernels import _lib
    kinds = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    decls = {}
    for src in _lib.CSRC.glob("*.cu"):
        text = src.read_text()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     text):
            decls[name] = ["void*" if "*" in a else a.split()[-2]
                           for a in args.split(",")]
    assert set(decls) == set(_lib._SIGNATURES)
    for name, argtypes in _lib._SIGNATURES.items():
        assert [kinds[t] for t in argtypes] == decls[name], name


def test_resolve_impl_follows_the_tensor_device():
    cpu = torch.zeros(1)
    assert ops.resolve_impl("auto", cpu) == "torch"
    assert ops.resolve_impl("torch", cpu) == "torch"
    with pytest.raises(ValueError):
        ops.resolve_impl("cuda", cpu)            # no kernel for a CPU tensor
    with pytest.raises(ValueError):
        ops.resolve_impl("xla", cpu)
    with pytest.raises(ValueError):
        ops.bnn_dense(cpu[None], torch.zeros(1, 1), precision="bnn",
                      impl="cuda")


def test_engine_without_device_needs_cuda(monkeypatch):
    """Engine(device=None) means the card; with no CUDA device it raises
    instead of carrying on on the CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as M
    from repro_torch.serving import Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("bnn-lm-100m")).replace(precision="bnn")
    params = M.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg)
    Engine(params, cfg, device="cpu")            # the explicit CPU request
