"""Port sliding-window ring on the CPU: slot positions, ring writes, the
attention core's explicit key positions, and the plain version of the
ring variant of the paged-attention kernel (GQA and MLA layouts) —
against the JAX package's Pallas kernel (``interpret=True``, as its own
tests run it on the CPU) and its XLA oracle (``ring_key_positions`` +
``attention`` with ``k_positions``).

Integer paths are bit-exact; attention outputs are float32 within
ATOL/RTOL (reduction order).  The CUDA kernels themselves run only on
the card, where ``chip_smoke.py`` holds them against these plain
versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.layers import attention as jattn, attn_block as jblock
from repro_torch.kernels import paged_attention as pa
from repro_torch.layers import attention as attn, attn_block

torch.set_num_threads(1)

ATOL = RTOL = 1e-5          # float32 attention: reduction-order rounding


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mb,bs", [(3, 4), (10, 4), (264, 16)])
def test_ring_key_positions_bit_exact(mb, bs):
    cap = mb * bs
    newest = np.array([0, 1, bs - 1, cap - 1, cap, cap + 5, 3 * cap + 7,
                       8191], np.int32)
    got = attn_block.ring_key_positions(_t(newest), mb, bs).numpy()
    want = np.asarray(jblock.ring_key_positions(jnp.asarray(newest), mb, bs))
    np.testing.assert_array_equal(got, want)
    # never-written slots are negative; every written slot is within the
    # last `cap` positions and congruent to its slot
    s = np.arange(cap)
    assert ((got < 0) == (s[None] > newest[:, None])).all()
    ok = got >= 0
    assert ((newest[:, None] - got)[ok] < cap).all()
    assert ((got % cap) == s[None])[ok].all()


def test_ring_scatter_blocks_bit_exact():
    """Ring writes wrap the logical block modulo the table width; invalid
    writes land in scratch block 0, slot 0."""
    rng = np.random.default_rng(0)
    nb, bs, mb = 9, 4, 3
    pool = rng.standard_normal((nb, bs, 2, 8)).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    positions = np.array([[11, 12, 13], [25, 26, 27]], np.int32)  # wrap
    vals = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    valid = np.array([[True, True, False], [True, True, True]])
    want = np.asarray(jblock.scatter_blocks(
        jnp.asarray(pool), jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(vals), jnp.asarray(valid), ring=True))
    got = attn_block.scatter_blocks(_t(pool), _t(table), _t(positions),
                                    _t(vals), _t(valid), ring=True).numpy()
    np.testing.assert_array_equal(got, want)
    # position 12 wrapped to logical block 0 (physical 1), offset 0
    np.testing.assert_array_equal(got[1, 0], vals[0, 1])
    # a paged (clipping) write is a different function past the table
    clip = attn_block.scatter_blocks(_t(pool), _t(table), _t(positions),
                                     _t(vals), _t(valid)).numpy()
    assert not np.array_equal(clip, got)


@pytest.mark.parametrize("causal,window", [(False, None), (True, 6)])
def test_attention_k_positions_matches_jax(causal, window):
    """The flash core and its reference with explicit key positions
    (out of order, with negatives and a fully-masked row)."""
    rng = np.random.default_rng(1)
    b, t, s, h, hkv, dh = 3, 3, 12, 4, 2, 16
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    newest = np.array([5, 29, 40], np.int32)
    kpos = np.array(jblock.ring_key_positions(jnp.asarray(newest), 3, 4))
    kpos[2] = -1                                 # nothing written
    q_off = newest - (t - 1)
    kv_len = newest + 1
    kw = dict(causal=causal, window=window)
    want = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len),
        k_positions=jnp.asarray(kpos), q_chunk=2, kv_chunk=5, **kw))
    targs = dict(q_offset=_t(q_off), kv_len=_t(kv_len), k_positions=_t(kpos),
                 **kw)
    got = attn.attention(_t(q), _t(k), _t(v), q_chunk=2, kv_chunk=5, **targs)
    ref = attn.attention_reference(_t(q), _t(k), _t(v), **targs)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ref.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got.numpy()[2].any()              # exact zeros


# ------------------------------------------------ the ring kernel variant

BS, MB = 4, 3                   # ring capacity 12 slots
# per row: newest below capacity (slots never written), above it
# (wrapped twice), and a kv_len below one block
NEWEST = np.array([6, 29, 1], np.int32)


def _rows(c):
    """(q_offset, kv_len, newest, causal) of a decode (c = 1) or a
    prefill chunk of c queries ending at ``NEWEST``."""
    kv_len = NEWEST + 1
    if c == 1:
        return NEWEST.copy(), kv_len, NEWEST.copy(), False
    return np.maximum(kv_len - c, 0).astype(np.int32), kv_len, NEWEST, True


def _ring_table(rng, b):
    nb = b * MB + 1
    return nb, (1 + rng.permutation(b * MB)).reshape(b, MB).astype(np.int32)


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("c", [1, 3, 5, 17])
def test_paged_attention_ring_gqa_matches_pallas_and_oracle(c, window):
    rng = np.random.default_rng(10 * c + (window or 0))
    b, h, hkv, dh = 3, 4, 2, 16
    nb, table = _ring_table(rng, b)
    q = rng.standard_normal((b, c, h, dh)).astype(np.float32)
    k = rng.standard_normal((nb, BS, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((nb, BS, hkv, dh)).astype(np.float32)
    q_off, kv_len, newest, causal = _rows(c)
    got = pa.paged_attention_torch(
        _t(q), _t(k), _t(v), _t(table), kv_len=_t(kv_len),
        q_offset=_t(q_off), causal=causal, window=window, ring=True,
        newest=_t(newest)).numpy()
    J = jnp.asarray
    pallas = np.asarray(jpa.paged_attention(
        J(q), J(k), J(v), J(table), kv_len=J(kv_len), q_offset=J(q_off),
        layout="gqa", causal=causal, window=window, ring=True,
        newest=J(newest), interpret=True))
    kpos = jblock.ring_key_positions(J(newest), MB, BS)
    oracle = np.asarray(jattn.attention(
        J(q), jblock.gather_blocks(J(k), J(table)),
        jblock.gather_blocks(J(v), J(table)), causal=causal, window=window,
        q_offset=J(q_off), kv_len=J(kv_len), k_positions=kpos, q_chunk=c,
        kv_chunk=8))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    # where the masks read positions (causal, window), the wrapped row
    # differs from the same table read as a paged one
    if causal or window:
        paged = pa.paged_attention_torch(
            _t(q), _t(k), _t(v), _t(table), kv_len=_t(kv_len),
            q_offset=_t(q_off), causal=causal, window=window).numpy()
        assert not np.allclose(paged[1], got[1])


@pytest.mark.parametrize("c", [1, 3])
def test_paged_attention_ring_mla_matches_pallas_and_oracle(c):
    """The ring composes with the latent layout, as in the JAX template."""
    rng = np.random.default_rng(20 + c)
    b, h, r, dr, nope, dv = 3, 4, 16, 8, 8, 8
    nb, table = _ring_table(rng, b)
    q = rng.standard_normal((b, c, h, nope + dr)).astype(np.float32)
    ckv = rng.standard_normal((nb, BS, r)).astype(np.float32)
    krope = rng.standard_normal((nb, BS, dr)).astype(np.float32)
    k_up = (0.2 * rng.standard_normal((r, h * nope))).astype(np.float32)
    v_up = (0.2 * rng.standard_normal((r, h * dv))).astype(np.float32)
    q_off, kv_len, newest, causal = _rows(c)
    got = pa.paged_attention_mla_torch(
        _t(q), _t(ckv), _t(krope), _t(table), k_up=_t(k_up), v_up=_t(v_up),
        nope_dim=nope, kv_len=_t(kv_len), q_offset=_t(q_off), causal=causal,
        ring=True, newest=_t(newest)).numpy()
    J = jnp.asarray
    pallas = np.asarray(jpa.paged_attention(
        J(q), J(ckv), J(krope), J(table), kv_len=J(kv_len),
        q_offset=J(q_off), layout="mla", causal=causal, ring=True,
        newest=J(newest), k_up=J(k_up), v_up=J(v_up), nope_dim=nope,
        interpret=True))
    lat = jblock.gather_blocks(J(ckv), J(table))
    rop = jblock.gather_blocks(J(krope), J(table))
    s = lat.shape[1]
    keys = jnp.concatenate(
        [(lat @ J(k_up)).reshape(b, s, h, nope),
         jnp.broadcast_to(rop[:, :, None, :], (b, s, h, dr))], axis=-1)
    vals = (lat @ J(v_up)).reshape(b, s, h, dv)
    oracle = np.asarray(jattn.attention(
        J(q), keys, vals, causal=causal, q_offset=J(q_off),
        kv_len=J(kv_len), k_positions=jblock.ring_key_positions(J(newest),
                                                                MB, BS),
        q_chunk=c, kv_chunk=8))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


def test_ring_needs_newest():
    q = torch.zeros(1, 1, 2, 4)
    pool = torch.zeros(2, 4, 2, 4)
    tab = torch.zeros(1, 1, dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="newest"):
        pa.paged_attention_torch(q, pool, pool, tab, kv_len=one,
                                 q_offset=one, ring=True)
