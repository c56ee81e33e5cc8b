"""Shared checks of a whole model family of the port against the JAX
package (tests/test_torch_family_swa.py, tests/test_torch_family_mla.py,
tests/test_torch_family_ssm.py):
config equality, parameter conversion, chunked prefill + paged decode
logits and greedy continuations, the full-sequence forward, and the
serving engine's greedy tokens and stats.

The JAX weights come from ``repro.models.transformer.init(PRNGKey(0))``
on the reduced config; the JAX side runs its XLA paths
(``attn_impl="xla"``, ``bnn_impl="xla"``), the port its plain kernel
versions on the CPU.  Tolerances: logits 1e-4 (float32, as
tests/test_torch_model.py); the engine's float stats 1e-9 (the same
arithmetic on the same counts)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro.models import transformer as JM
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as M
from repro_torch.serving import Engine, EngineConfig

TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE_RTOL = 1e-9


def cfgs(arch, precision):
    j = jreduced(jconfigs.get_config(arch)).replace(precision=precision)
    t = treduced(tconfigs.get_config(arch)).replace(precision=precision)
    return j, t


def models(arch):
    """(jax params, port params) of the reduced config at "bnn" (the
    weights do not depend on the precision)."""
    jcfg, tcfg = cfgs(arch, "bnn")
    jp, _ = JM.init(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def check_config(arch, shrink):
    j = jconfigs.get_config(arch)
    t = tconfigs.get_config(arch)
    if shrink:
        j, t = jreduced(j), treduced(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def check_round_trip(arch, jax_params, torch_params, arch_cfgs=None):
    """Every leaf of every layer equal after ``params_from_numpy``, the
    layers in plan order; ``arch_cfgs`` (jax, port) replaces the reduced
    configs of ``arch``."""
    jcfg, tcfg = arch_cfgs or cfgs(arch, "bnn")
    layers = list(JM._iter_layers(jcfg, jax_params))
    assert len(layers) == len(torch_params["layers"]) == tcfg.n_layers
    assert [(m, f) for m, f, _ in layers] == M.layer_plan(tcfg)
    for (_mix, _f, jp), p in zip(layers, torch_params["layers"]):
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        assert len(flat_j) == len(jax.tree_util.tree_leaves(p))
        for path, leaf in flat_j:
            node = p
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(np_(node), np.asarray(leaf))
    if tcfg.tie_embeddings:               # a view of the embedding
        assert "head" not in jax_params
        head = torch_params["head"]["w"]
        assert head.data_ptr() == torch_params["embed"]["w"].data_ptr()
        np.testing.assert_array_equal(np_(head),
                                      np.asarray(jax_params["embed"]["w"]).T)
    else:
        np.testing.assert_array_equal(np_(torch_params["head"]["w"]),
                                      np.asarray(jax_params["head"]["w"]))


def model_runs(arch, jax_params, torch_params, *, prompt_len, chunk, bs,
               table_width, ring, n_decode=8, slot=0):
    """Per precision: the prompt through chunked prefill, then
    ``n_decode`` greedy paged-decode steps, the same weights through
    both packages, each side feeding back its own greedy token; SSM
    layers run in recurrent slot ``slot`` (a pool of slot + 1 rows).
    Returns {precision: {side: (logits (prompt_len + n_decode, V),
    tokens)}}."""
    out = {}
    table = np.arange(1, table_width + 1, dtype=np.int32)[None]
    num_blocks = table_width + 1
    num_slots = slot + 1 if slot else 0
    slots = np.array([slot], np.int32)
    for precision in ("bnn", "bf16"):
        jcfg, tcfg = cfgs(arch, precision)
        prompt = np.random.default_rng(3).integers(
            0, jcfg.vocab, size=prompt_len).astype(np.int32)
        j_prefill = jax.jit(lambda p, *a: JM.prefill_chunk(
            p, jcfg, *a, jnp.asarray(slots), ring=ring, attn_impl="xla"))
        j_decode = jax.jit(lambda p, *a: JM.paged_decode_step(
            p, jcfg, *a, None, jnp.asarray(slots), ring=ring,
            attn_impl="xla"))
        runs = {}
        for side in ("jax", "torch"):
            caches = (JM.init_paged_state(jcfg, num_blocks, bs, num_slots)
                      if side == "jax" else
                      M.init_paged_state(tcfg, num_blocks, bs, num_slots))
            logits = []
            for pos in range(0, prompt_len, chunk):
                n = min(chunk, prompt_len - pos)
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :n] = prompt[pos:pos + n]
                args = (toks, table, np.array([pos], np.int32),
                        np.array([n], np.int32))
                if side == "jax":
                    lg, caches = j_prefill(
                        jax_params, jnp.asarray(args[0]), caches,
                        *map(jnp.asarray, args[1:]))
                else:
                    lg, caches = M.prefill_chunk(
                        torch_params, tcfg, torch.from_numpy(toks).long(),
                        caches, *map(torch.from_numpy, args[1:]),
                        torch.from_numpy(slots), ring=ring)
                logits.append(np_(lg)[0, :n])
            tok = int(np.argmax(logits[-1][-1]))
            toks_out = [tok]
            for step in range(n_decode):
                n = prompt_len + step
                if side == "jax":
                    lg, caches = j_decode(
                        jax_params, jnp.array([[tok]], jnp.int32), caches,
                        jnp.asarray(table), jnp.array([n], jnp.int32))
                else:
                    lg, caches = M.paged_decode_step(
                        torch_params, tcfg, torch.tensor([[tok]]), caches,
                        torch.from_numpy(table),
                        torch.tensor([n], dtype=torch.int32), None,
                        torch.from_numpy(slots), ring=ring)
                logits.append(np_(lg)[0])
                tok = int(np.argmax(logits[-1][-1]))
                toks_out.append(tok)
            runs[side] = (np.concatenate(logits), toks_out)
        out[precision] = runs
    return out


def check_logits_fn(arch, jax_params, torch_params, precision, t=13):
    """The full-sequence forward (MoE at the config's finite capacity,
    with JAX's drop order)."""
    jcfg, tcfg = cfgs(arch, precision)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, t))
    got = np_(M.logits_fn(torch_params, tcfg, torch.from_numpy(tokens)))
    want = np.asarray(JM.logits_fn(jax_params, jcfg,
                                   {"tokens": jnp.asarray(tokens)}))
    np.testing.assert_allclose(got, want, **TOL)


def drive(eng, prompts, max_new, late: int, late_after: int):
    """Submit all but the last ``late`` prompts, step ``late_after``
    times, submit the rest mid-stream, run to completion."""
    early = len(prompts) - late
    rids = [eng.submit(p, n) for p, n in zip(prompts[:early], max_new)]
    for _ in range(late_after):
        eng.step()
    rids += [eng.submit(p, n)
             for p, n in zip(prompts[early:], max_new[early:])]
    return rids, eng.run()


def engine_pair(arch, jax_params, torch_params, ecfg_kw, prompts, max_new,
                late, late_after):
    """The JAX and the port's Engine on the same traffic: ((JAX engine,
    (rids, outputs)), (port engine, (rids, outputs)))."""
    jcfg, tcfg = cfgs(arch, "bnn")
    je = JEngine(jax_params, jcfg, JEngineConfig(
        **ecfg_kw, prefix_cache=False, preempt_policy="recompute",
        attn_impl="xla", bnn_impl="xla"))
    te = Engine(torch_params, tcfg, EngineConfig(**ecfg_kw), device="cpu")
    return ((je, drive(je, prompts, max_new, late, late_after)),
            (te, drive(te, prompts, max_new, late, late_after)))


def member(cache):
    """The port's cache member: the block pool, or the recurrent slots."""
    return cache.attn if cache.attn is not None else cache.ssm


def check_engine_tokens(pair):
    (je, (jrids, jout)), (te, (trids, tout)) = pair
    assert trids == jrids and sorted(tout) == sorted(jout) == jrids
    for rid in jrids:
        np.testing.assert_array_equal(tout[rid], jout[rid])
    st = te.stats()
    assert st["finished"] == len(jrids)
    assert st["max_concurrent_decode"] >= 2
    late_admits = [e["step"] for e in te.scheduler.trace
                   if e["event"] == "admit"]
    assert max(late_admits) > 0                  # admitted mid-stream
    member(te.cache).allocator.check()
    assert member(te.cache).allocator.num_used == 0


def check_engine_stats(pair):
    """The mixer (block/ring or slot) and photonic sections equal the
    JAX engine's on the same traffic."""
    (je, _), (te, _) = pair
    jst, tst = je.stats(), te.stats()
    for key in ("preemptions", "prefill_tokens", "decoded_tokens"):
        assert tst[key] == jst[key], key
    assert tst["mixer"] == jst["mixer"]
    got, want = tst["photonic"], jst["photonic"]
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, float):
            assert math.isclose(got[key], w, rel_tol=ENGINE_RTOL), key
        else:
            assert got[key] == w, key
