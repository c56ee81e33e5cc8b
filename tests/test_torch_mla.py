"""Port MLA on the CPU: the plain version of the MLA-latent variant of the
paged-attention kernel against the JAX package's Pallas kernel
(``interpret=True``) and its XLA oracle (gather the latents, decompress
K/V, attend); an absorbed-order reference — the order the CUDA kernel
sums in (k_up folded into the query, the weighted latents decompressed
by v_up after the walk) — against the plain version; and the MLA block
(projections, decompression, full-sequence forward, paged decode and
chunked prefill with their latent pools) against the JAX package's at
precision "bnn" and "bf16" on the reduced deepseek-v2-lite weights.

Tolerances: attention outputs 1e-5 (float32 reduction order); block
outputs 1e-4, pools 1e-5, as in tests/test_torch_model.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.kernels import paged_attention as jpa
from repro.layers import attention as jattn, attn_block as jblock
from repro.layers import mla as jmla
from repro.models import transformer as JM
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops, paged_attention as pa
from repro_torch.layers import mla

torch.set_num_threads(1)

ATOL = RTOL = 1e-5          # float32 attention: reduction-order rounding
TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v2-lite-16b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _latent_case(c, seed):
    """Pools, table, q, k_up/v_up and per-row lengths; row 2 has
    kv_len 0 (fully masked)."""
    rng = np.random.default_rng(seed)
    b, bs, h, r, dr, nope, dv = 3, 4, 4, 16, 8, 8, 8
    mb = -(-(8 + c) // bs)            # the table holds every key
    nb = b * mb + 1
    d = dict(
        ckv=rng.standard_normal((nb, bs, r)).astype(np.float32),
        krope=rng.standard_normal((nb, bs, dr)).astype(np.float32),
        table=(1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32),
        q=rng.standard_normal((b, c, h, nope + dr)).astype(np.float32),
        k_up=(0.2 * rng.standard_normal((r, h * nope))).astype(np.float32),
        v_up=(0.2 * rng.standard_normal((r, h * dv))).astype(np.float32),
        q_off=np.array([1, 8, 0], np.int32))
    d["kv_len"] = np.array([1 + c, 8 + c, 0], np.int32)
    return d, nope


def _plain(d, nope, causal):
    return pa.paged_attention_mla_torch(
        _t(d["q"]), _t(d["ckv"]), _t(d["krope"]), _t(d["table"]),
        k_up=_t(d["k_up"]), v_up=_t(d["v_up"]), nope_dim=nope,
        kv_len=_t(d["kv_len"]), q_offset=_t(d["q_off"]), causal=causal)


# c * H = 20 and 68 query rows cross the CUDA kernel's 16-row decode
# block and its 64-row prefill tile
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("c", [1, 3, 5, 17])
def test_paged_attention_mla_plain_matches_pallas_and_oracle(c, causal):
    d, nope = _latent_case(c, 30 + c + 2 * causal)
    got = _plain(d, nope, causal).numpy()
    J = jnp.asarray
    pallas = np.asarray(jpa.paged_attention(
        J(d["q"]), J(d["ckv"]), J(d["krope"]), J(d["table"]),
        kv_len=J(d["kv_len"]), q_offset=J(d["q_off"]), layout="mla",
        causal=causal, k_up=J(d["k_up"]), v_up=J(d["v_up"]), nope_dim=nope,
        interpret=True))
    lat = jblock.gather_blocks(J(d["ckv"]), J(d["table"]))
    rop = jblock.gather_blocks(J(d["krope"]), J(d["table"]))
    b, s = lat.shape[:2]
    h, dr = d["q"].shape[2], d["krope"].shape[-1]
    keys = jnp.concatenate(
        [(lat @ J(d["k_up"])).reshape(b, s, h, nope),
         jnp.broadcast_to(rop[:, :, None, :], (b, s, h, dr))], axis=-1)
    vals = (lat @ J(d["v_up"])).reshape(b, s, h, -1)
    oracle = np.asarray(jattn.attention(
        J(d["q"]), keys, vals, causal=causal, q_offset=J(d["q_off"]),
        kv_len=J(d["kv_len"]), q_chunk=c, kv_chunk=8))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    assert not got[2].any() and not pallas[2].any()   # kv_len 0: zeros
    # the CPU wrapper and the ops entry take the plain version
    wrapped = ops.paged_attention_mla(
        _t(d["q"]), _t(d["ckv"]), _t(d["krope"]), _t(d["table"]),
        k_up=_t(d["k_up"]), v_up=_t(d["v_up"]), nope_dim=nope,
        kv_len=_t(d["kv_len"]), q_offset=_t(d["q_off"]), causal=causal)
    np.testing.assert_array_equal(wrapped.numpy(), got)


def _absorbed(d, nope, causal):
    """The CUDA kernel's order: q_lat = scale * q_nope . k_up_h^T, scores
    q_lat . c_kv + scale * q_rope . k_rope, the softmax's weights applied
    to the latents, then v_up per head.  (Its tiled prefill path sums
    the score's 576 terms in two halves and multiplies in 3xTF32; this
    reference keeps float32 products.)"""
    q, ckv, krope = map(torch.from_numpy, (d["q"], d["ckv"], d["krope"]))
    k_up, v_up = torch.from_numpy(d["k_up"]), torch.from_numpy(d["v_up"])
    b, c, h, dq = q.shape
    r = ckv.shape[-1]
    mb, bs = d["table"].shape[1], ckv.shape[1]
    scale = dq ** -0.5
    tab = torch.from_numpy(d["table"]).long()
    lat = ckv[tab].reshape(b, mb * bs, r)
    rope = krope[tab].reshape(b, mb * bs, -1)
    k_up_h = k_up.reshape(r, h, nope)
    q_lat = scale * torch.einsum("bchn,rhn->bchr", q[..., :nope], k_up_h)
    scores = torch.einsum("bchr,bsr->bchs", q_lat, lat) + scale * \
        torch.einsum("bchd,bsd->bchs", q[..., nope:], rope)
    kpos = torch.arange(mb * bs)
    qpos = torch.from_numpy(d["q_off"]).long()[:, None] + torch.arange(c)
    mask = kpos[None, None] < torch.from_numpy(d["kv_len"]).long()[:, None,
                                                                    None]
    if causal:
        mask = mask & (qpos[:, :, None] >= kpos)
    mask = mask[:, :, None].expand(b, c, h, mb * bs)
    p = torch.where(mask, torch.exp(scores.masked_fill(~mask, -1e30)
                                    - scores.masked_fill(~mask, -1e30)
                                    .amax(-1, keepdim=True)), 0.0)
    acc = torch.einsum("bchs,bsr->bchr", p, lat) / \
        p.sum(-1, keepdim=True).clamp_min(1e-20)
    return torch.einsum("bchr,rhv->bchv", acc, v_up.reshape(r, h, -1))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("c", [1, 3, 5, 17])
def test_absorbed_order_equals_plain_version(c, causal):
    d, nope = _latent_case(c, 40 + c + 2 * causal)
    np.testing.assert_allclose(_absorbed(d, nope, causal).numpy(),
                               _plain(d, nope, causal).numpy(),
                               rtol=RTOL, atol=ATOL)


# C * H query rows a batch row: 16 or fewer take the CUDA kernel's decode
# walk, more its tiled path, which is built for R = 512, Dr = 64
@pytest.mark.parametrize("c,h,r,dr,tiled", [
    (1, 16, 512, 64, False), (2, 16, 512, 64, True),
    (128, 16, 512, 64, True), (4, 4, 512, 64, False),
    (5, 4, 512, 64, True), (128, 16, 256, 64, False)])
def test_mla_route_by_query_rows(c, h, r, dr, tiled):
    assert pa.mla_tiled(c, h, r, dr) is tiled


# ------------------------------------------------------------ MLA block


def _cfgs(precision):
    j = jreduced(jconfigs.get_config(ARCH)).replace(precision=precision)
    t = treduced(tconfigs.get_config(ARCH)).replace(precision=precision)
    return j, t


@pytest.fixture(scope="module")
def layer_params():
    """Layer 1's MLA params (the first scan-stacked layer), both sides."""
    jcfg, tcfg = _cfgs("bnn")
    jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    j_layer = list(JM._iter_layers(jcfg, jp))[1][2]["attn"]
    return j_layer, tp["layers"][1]["attn"]


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_mla_project_expand_forward_match_jax(layer_params, precision):
    jp, tp = layer_params
    jcfg, tcfg = _cfgs(precision)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want = jmla._project(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                         precision)
    got = mla._project(tp, tcfg, _t(x), _t(pos).long(), precision, "auto")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the decompression is a float matmul at every precision
    kw, vw = jmla._expand_kv(jp, jcfg, want[2], want[3])
    kt, vt = mla._expand_kv(tp, tcfg, _t(want[2]), _t(want[3]))
    np.testing.assert_allclose(kt.numpy(), np.asarray(kw), **POOL_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vw), **POOL_TOL)
    np.testing.assert_allclose(
        vt.numpy().reshape(2, 7, -1),
        np.asarray(want[2]) @ tp["v_up"]["w"].numpy(), **POOL_TOL)
    np.testing.assert_allclose(
        mla.forward(tp, tcfg, _t(x), _t(pos).long(),
                    precision=precision).numpy(),
        np.asarray(jmla.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                precision=precision)), **TOL)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_mla_paged_decode_and_prefill_match_jax(layer_params, precision):
    """Outputs and the updated latent pools, the scratch block included
    (the inactive decode row's write and the padded prefill positions
    land in block 0, slot 0)."""
    jp, tp = layer_params
    jcfg, tcfg = _cfgs(precision)
    rng = np.random.default_rng(6)
    nb, bs = 9, 4
    pools = {"c_kv": rng.standard_normal((nb, bs, 32)).astype(np.float32),
             "k_rope": rng.standard_normal((nb, bs, 8)).astype(np.float32)}
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 0]], np.int32)

    def pools_t():
        return {k: _t(v) for k, v in pools.items()}

    def pools_j():
        return {k: jnp.asarray(v) for k, v in pools.items()}

    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    lengths = np.array([9, 5, 3], np.int32)
    active = np.array([True, True, False])
    y_j, c_j = jmla.paged_decode_step(
        jp, jcfg, jnp.asarray(x), pools_j(), jnp.asarray(table),
        jnp.asarray(lengths), precision=precision,
        active=jnp.asarray(active), attn_impl="xla")
    y_t, c_t = mla.paged_decode_step(
        tp, tcfg, _t(x), pools_t(), _t(table), _t(lengths),
        precision=precision, active=_t(active))
    np.testing.assert_allclose(y_t.numpy()[:2], np.asarray(y_j)[:2], **TOL)
    for k in pools:
        np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]),
                                   **POOL_TOL)
        assert not np.allclose(c_t[k].numpy()[0, 0], pools[k][0, 0])

    x = rng.standard_normal((1, 4, 64)).astype(np.float32)
    lengths, n_valid = np.array([5], np.int32), np.array([3], np.int32)
    y_j, c_j = jmla.prefill_chunk(
        jp, jcfg, jnp.asarray(x), pools_j(), jnp.asarray(table[:1]),
        jnp.asarray(lengths), jnp.asarray(n_valid), precision=precision,
        attn_impl="xla")
    taps: list = []
    y_t, c_t = mla.prefill_chunk(
        tp, tcfg, _t(x), pools_t(), _t(table[:1]), _t(lengths),
        _t(n_valid), precision=precision, taps=taps)
    np.testing.assert_allclose(y_t.numpy()[:, :3], np.asarray(y_j)[:, :3],
                               **TOL)
    for k in pools:
        np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]),
                                   **POOL_TOL)
    # only the binarized projections are tapped: q, kv_down, o
    assert [name for name, _ in taps] == ["q", "kv_down", "o"]
