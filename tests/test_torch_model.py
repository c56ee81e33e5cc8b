"""Port model stack against the JAX package on the reduced bnn-lm-100m:
parameter conversion, norms/rope/FFN, the paged attention block (pools
included), and the whole model's chunked prefill + paged decode logits
and greedy continuations at precision "bnn" and "bf16".

The JAX weights come from ``repro.models.transformer.init(PRNGKey(0))``
and are converted once per session; the JAX side runs its XLA paths
(``attn_impl="xla"``, the ops default off-TPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.layers import attn_block as jblock, common as jC, ffn as jffn
from repro.models import transformer as JM
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.layers import attn_block, common as C, ffn
from repro_torch.models import transformer as M

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)     # float32 logits / activations
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(precision):
    j = jreduced(jconfigs.get_config("bnn-lm-100m")).replace(precision=precision)
    t = treduced(tconfigs.get_config("bnn-lm-100m")).replace(precision=precision)
    return j, t


@pytest.fixture(scope="session")
def jax_params():
    jcfg, _ = _cfgs("bnn")
    params, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    return params


@pytest.fixture(scope="session")
def torch_params(jax_params):
    _, tcfg = _cfgs("bnn")
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), tcfg)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def test_params_from_numpy_round_trip(jax_params, torch_params):
    jcfg, tcfg = _cfgs("bnn")
    tp = torch_params
    np.testing.assert_array_equal(_np(tp["embed"]["w"]),
                                  np.asarray(jax_params["embed"]["w"]))
    # tied head: a view of the embedding, transposed
    assert tp["head"]["w"].data_ptr() == tp["embed"]["w"].data_ptr()
    np.testing.assert_array_equal(_np(tp["head"]["w"]),
                                  np.asarray(JM._head_matrix(jax_params, jcfg)))
    layers = list(JM._iter_layers(jcfg, jax_params))
    assert len(layers) == len(tp["layers"]) == tcfg.n_layers
    for (_mix, _f, jp), p in zip(layers, tp["layers"]):
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        assert len(flat_j) == len(jax.tree_util.tree_leaves(p))
        for path, leaf in flat_j:
            node = p
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(_np(node), np.asarray(leaf))


def test_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = (rng.random(16) + 0.5).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
        np.testing.assert_allclose(
            _np(C.norm(torch.from_numpy(x), tp, kind)),
            np.asarray(jC.norm(jnp.asarray(x), jp, kind)), rtol=1e-5, atol=1e-5)
    pos = np.array([[0, 3, 7, 100, 1023]] * 2, np.int32)
    np.testing.assert_allclose(
        _np(C.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))),
        np.asarray(jC.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_ffn_forward_matches_jax(jax_params, torch_params, precision):
    jcfg, tcfg = _cfgs(precision)
    jp = list(JM._iter_layers(jcfg, jax_params))[1][2]["ffn"]
    tp = torch_params["layers"][1]["ffn"]
    x = np.random.default_rng(1).standard_normal((3, 4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(ffn.forward(tp, torch.from_numpy(x), "swiglu", precision)),
        np.asarray(jffn.forward(jp, jnp.asarray(x), "swiglu", precision)),
        **TOL)


def _block_inputs():
    rng = np.random.default_rng(2)
    nb, bs = 9, 4
    pool = {k: rng.standard_normal((nb, bs, 4, 16)).astype(np.float32)
            for k in ("k", "v")}
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 0]], np.int32)
    return rng, pool, table


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_attn_block_paged_decode_and_prefill_match_jax(
        jax_params, torch_params, precision):
    """Outputs and the updated pools, including the scratch block: the
    inactive decode row's write and the padded prefill positions land in
    block 0, slot 0 (one write each, so the slot's content is defined)."""
    jcfg, tcfg = _cfgs(precision)
    jp = list(JM._iter_layers(jcfg, jax_params))[0][2]["attn"]
    tp = torch_params["layers"][0]["attn"]
    rng, pool, table = _block_inputs()

    def pools_t():
        return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}

    def pools_j():
        return {k: jnp.asarray(v) for k, v in pool.items()}

    # decode: row 2 inactive -> its write goes to scratch block 0
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    lengths = np.array([9, 5, 3], np.int32)
    active = np.array([True, True, False])
    y_j, c_j = jblock.paged_decode_step(
        jp, jcfg, jnp.asarray(x), pools_j(), jnp.asarray(table),
        jnp.asarray(lengths), precision=precision,
        active=jnp.asarray(active), attn_impl="xla")
    y_t, c_t = attn_block.paged_decode_step(
        tp, tcfg, torch.from_numpy(x), pools_t(), torch.from_numpy(table),
        torch.from_numpy(lengths), precision=precision,
        active=torch.from_numpy(active))
    np.testing.assert_allclose(_np(y_t)[:2], np.asarray(y_j)[:2], **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(c_t[k]), np.asarray(c_j[k]), **POOL_TOL)
        assert not np.allclose(_np(c_t[k])[0, 0], pool[k][0, 0])  # scratch hit

    # prefill: one row, chunk of 4 with 3 valid positions
    x = rng.standard_normal((1, 4, 64)).astype(np.float32)
    tab1 = table[:1]
    lengths, n_valid = np.array([5], np.int32), np.array([3], np.int32)
    y_j, c_j = jblock.prefill_chunk(
        jp, jcfg, jnp.asarray(x), pools_j(), jnp.asarray(tab1),
        jnp.asarray(lengths), jnp.asarray(n_valid), precision=precision,
        attn_impl="xla")
    y_t, c_t = attn_block.prefill_chunk(
        tp, tcfg, torch.from_numpy(x), pools_t(), torch.from_numpy(tab1),
        torch.from_numpy(lengths), torch.from_numpy(n_valid),
        precision=precision)
    np.testing.assert_allclose(_np(y_t)[:, :3], np.asarray(y_j)[:, :3], **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(c_t[k]), np.asarray(c_j[k]), **POOL_TOL)


@pytest.fixture(scope="session")
def model_runs(jax_params, torch_params):
    """Per precision: a C=16 prefill chunk then 8 greedy paged-decode
    steps, the same weights through both packages; each side feeds back
    its own greedy token."""
    out = {}
    for precision in ("bnn", "bf16"):
        jcfg, tcfg = _cfgs(precision)
        rng = np.random.default_rng(3)
        prompt = rng.integers(0, jcfg.vocab, size=(1, 13)).astype(np.int32)
        chunk = np.zeros((1, 16), np.int32)
        chunk[:, :13] = prompt
        table = np.array([[1, 2, 3, 4, 5, 6]], np.int32)
        j_prefill = jax.jit(lambda p, *a: JM.prefill_chunk(
            p, jcfg, *a, attn_impl="xla"))
        j_decode = jax.jit(lambda p, *a: JM.paged_decode_step(
            p, jcfg, *a, attn_impl="xla"))
        runs = {}
        for side in ("jax", "torch"):
            if side == "jax":
                caches = JM.init_paged_state(jcfg, 8, 4)
                lg, caches = j_prefill(
                    jax_params, jnp.asarray(chunk), caches,
                    jnp.asarray(table), jnp.array([0], jnp.int32),
                    jnp.array([13], jnp.int32))
            else:
                caches = M.init_paged_state(tcfg, 8, 4)
                lg, caches = M.prefill_chunk(
                    torch_params, tcfg, torch.from_numpy(chunk).long(),
                    caches, torch.from_numpy(table),
                    torch.tensor([0], dtype=torch.int32),
                    torch.tensor([13], dtype=torch.int32))
            logits = [_np(lg)[0, :13]]
            tok = int(np.argmax(logits[-1][-1]))
            toks = [tok]
            for step in range(8):
                n = 13 + step
                if side == "jax":
                    lg, caches = j_decode(
                        jax_params, jnp.array([[tok]], jnp.int32),
                        caches, jnp.asarray(table), jnp.array([n], jnp.int32))
                else:
                    lg, caches = M.paged_decode_step(
                        torch_params, tcfg, torch.tensor([[tok]]), caches,
                        torch.from_numpy(table),
                        torch.tensor([n], dtype=torch.int32))
                logits.append(_np(lg)[0])
                tok = int(np.argmax(logits[-1][-1]))
                toks.append(tok)
            runs[side] = (np.concatenate(logits), toks)
        out[precision] = runs
    return out


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_model_prefill_and_decode_logits_match_jax(model_runs, precision):
    (lj, _), (lt, _) = model_runs[precision]["jax"], model_runs[precision]["torch"]
    assert lt.shape == lj.shape == (13 + 8, 128)
    np.testing.assert_allclose(lt, lj, **TOL)


@pytest.mark.parametrize("precision", ["bnn", "bf16"])
def test_model_greedy_continuation_matches_jax(model_runs, precision):
    assert model_runs[precision]["torch"][1] == model_runs[precision]["jax"][1]


def test_prefill_logits_match_full_forward(torch_params, jax_params):
    """Chunked prefill over the paged pools reproduces the full-sequence
    forward (logits_fn) at every position, and logits_fn matches JAX."""
    jcfg, tcfg = _cfgs("bnn")
    tokens = np.random.default_rng(4).integers(0, 128, (1, 13))
    ref = _np(M.logits_fn(torch_params, tcfg, torch.from_numpy(tokens)))
    np.testing.assert_allclose(
        ref, np.asarray(JM.logits_fn(jax_params, jcfg,
                                     {"tokens": jnp.asarray(tokens)})), **TOL)
    caches = M.init_paged_state(tcfg, 8, 4)
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    got, pos = [], 0
    while pos < 13:
        n = min(5, 13 - pos)
        toks = torch.zeros((1, 5), dtype=torch.long)
        toks[0, :n] = torch.from_numpy(tokens[0, pos:pos + n])
        lg, caches = M.prefill_chunk(
            torch_params, tcfg, toks, caches, table,
            torch.tensor([pos], dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32))
        got.append(_np(lg)[:, :n])
        pos += n
    np.testing.assert_allclose(np.concatenate(got, axis=1), ref, **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_attention_matches_jax(causal, window):
    """The chunked flash core (ragged q/kv chunks, per-row q_offset and
    kv_len, a fully-masked row) and its O(T*S) reference, against the
    JAX package's; plus gather_blocks, bit-exact."""
    from repro.layers import attention as jattn
    from repro_torch.layers import attention as attn
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    q_off = np.array([3, 0, 2], np.int32)
    kv_len = np.array([12, 7, 0], np.int32)
    kw = dict(causal=causal, window=window)
    want = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len), q_chunk=4,
        kv_chunk=5, **kw))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attn.attention(tq, tk, tv, q_offset=torch.from_numpy(q_off),
                         kv_len=torch.from_numpy(kv_len), q_chunk=4,
                         kv_chunk=5, **kw)
    ref = attn.attention_reference(tq, tk, tv,
                                   q_offset=torch.from_numpy(q_off),
                                   kv_len=torch.from_numpy(kv_len), **kw)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ref), want, rtol=1e-5, atol=1e-5)
    assert not _np(got)[2].any()                 # kv_len 0: exact zeros
    _, pool, table = _block_inputs()
    np.testing.assert_array_equal(
        _np(attn_block.gather_blocks(torch.from_numpy(pool["k"]),
                                     torch.from_numpy(table))),
        np.asarray(jblock.gather_blocks(jnp.asarray(pool["k"]),
                                        jnp.asarray(table))))
