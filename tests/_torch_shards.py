"""Shared pieces of the port's sharded-serving tests against the JAX
package (tests/test_torch_sharded*.py, tests/test_torch_roles_*.py).

The reduced configs and seeded JAX weights of tests/conftest.py are
carried across by ``interop.params_from_numpy``; the JAX side runs its
XLA paths, the port its plain kernel versions on the CPU.  A JAX
``ShardedEngine`` builds a jitted ``Engine`` a shard (≈ 15-30 s of
compiles), so each file drives one at most, through one scenario that
the port's ``ShardedEngine`` then repeats step for step; token identity
is held against one JAX ``Engine`` a file, reused for every prompt set
(tokens do not depend on the schedule)."""
import jax
import numpy as np
import torch

from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serving import ShardedEngine as JShardedEngine
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced
from repro_torch.interop import params_from_numpy
from repro_torch.serving import Engine, EngineConfig, ShardedEngine

torch.set_num_threads(1)

# the sizes of the JAX package's own role and sharding tests
EKW = dict(block_size=4, num_blocks=33, max_batch=4, prefill_chunk=4,
           max_model_len=32)
XLA = dict(attn_impl="xla", bnn_impl="xla")
CPU = [torch.device("cpu")]


def port_cfg(arch: str):
    """The port's reduced config of ``arch`` at precision "bnn"."""
    return treduced(tconfigs.get_config(arch)).replace(precision="bnn")


def port_model(arch: str, jax_params):
    """(``port_cfg(arch)``, the JAX weights as the port's params)."""
    cfg = port_cfg(arch)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, jax_params), cfg)


def prompts(vocab: int, lens, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


class JaxReference:
    """One JAX ``Engine`` (EKW, XLA paths): ``tokens(prompts, max_news)``
    serves a prompt set on it and returns each request's prompt +
    generated tokens."""

    def __init__(self, jcfg, jparams, **kw):
        self.eng = JEngine(jparams, jcfg,
                           JEngineConfig(**{**EKW, **kw, **XLA}))

    def tokens(self, ps, max_news, sampling=None):
        rids = [self.eng.submit(p, m, **({"sampling": sampling(i)}
                                         if sampling else {}))
                for i, (p, m) in enumerate(zip(ps, max_news))]
        out = self.eng.run()
        return [out[r] for r in rids]


def jax_sharded(jcfg, jparams, n_shards, roles=None, **kw):
    return JShardedEngine(jparams, jcfg, JEngineConfig(**{**EKW, **kw,
                                                          **XLA}),
                          n_shards, roles=roles)


def port_sharded(tcfg, tparams, n_shards, roles=None, **kw):
    return ShardedEngine(tparams, tcfg, EngineConfig(**{**EKW, **kw}),
                         n_shards, roles=roles, devices=CPU)


def port_engine(tcfg, tparams, **kw):
    return Engine(tparams, tcfg, EngineConfig(**{**EKW, **kw}),
                  device="cpu")


def port_tokens(tcfg, tparams, ps, max_news, **kw):
    eng = port_engine(tcfg, tparams, **kw)
    rids = [eng.submit(p, m) for p, m in zip(ps, max_news)]
    out = eng.run()
    return [out[r] for r in rids]


def events(eng) -> list[dict]:
    """A shard's scheduler events, without the port's extra ``slot`` on
    admit records."""
    return [{k: v for k, v in e.items() if k != "slot"}
            for e in eng.scheduler.trace]


def shard_stats(se) -> dict:
    """A sharded run's stats without wall times and rates (what both
    packages decide, not how fast either ran)."""
    st = se.stats()
    drop = ("wall_s", "decode_tokens_per_s", "p50_latency_s",
            "p99_latency_s", "aggregate_decode_tokens_per_s",
            "host_copy_wall_s")
    out = {k: v for k, v in st.items() if k not in drop}
    out["per_shard"] = [{k: v for k, v in row.items() if k not in drop}
                        for row in st["per_shard"]]
    out["handoff"] = {k: v for k, v in st["handoff"].items()
                      if k not in drop}
    return out


def assert_same_tokens(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------- the families under roles 1:1

FAMILY = dict(lens=[4, 8, 6, 5], max_news=[8, 6, 8, 8], seed=21)


def sampling(pkg: str):
    """Request i's sampling parameters in either package (seeded by i)."""
    if pkg == "jax":
        from repro.serving import SamplingParams
    else:
        from repro_torch.serving import SamplingParams
    return lambda i: SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                                    seed=100 + i)


def family_story(se, ps, samp=None):
    """Serve a family's prompt set on a 1:1 ShardedEngine of either
    package; what both packages decide."""
    rids = [se.submit(p, m, **({"sampling": samp(i)} if samp else {}))
            for i, (p, m) in enumerate(zip(ps, FAMILY["max_news"]))]
    out = se.run()
    return {"tokens": [out[r].tolist() for r in rids],
            "stats": shard_stats(se),
            "events": [events(e) for e in se.engines],
            "slots_moved": [e.cache.ssm.swapped_slots
                            if e.cache.ssm is not None else 0
                            for e in se.engines]}


def family_runs(arch, jcfg, jparams):
    """The family story on JAX's and the port's 1:1 ShardedEngine,
    greedy, then (stats reset) sampled: {"jax"|"torch": (greedy record,
    sampled record)}, the port's model and the prompts.  A jitted JAX
    Engine a shard is the costly part, so the JAX side is the sharded
    engine alone (the JAX suite holds its tokens to its single Engine:
    tests/test_roles.py)."""
    tcfg, tp = port_model(arch, jparams)
    ps = prompts(jcfg.vocab, FAMILY["lens"], FAMILY["seed"])
    out = {}
    for pkg, se in (("jax", jax_sharded(jcfg, jparams, 2, "1:1")),
                    ("torch", port_sharded(tcfg, tp, 2, "1:1"))):
        greedy = family_story(se, ps)
        se.reset_stats()
        out[pkg] = (greedy, family_story(se, ps, sampling(pkg)))
    return out, (tcfg, tp), ps


def check_family_story(runs, run: int):
    """The port's record of run ``run`` (0 greedy, 1 sampled) equals
    JAX's; every request is handed off, and only the prefill shard
    prefills."""
    out, _m, ps = runs
    got, want = out["torch"][run], out["jax"][run]
    for key in want:
        assert got[key] == want[key], key
    pre, dec = got["stats"]["per_shard"]
    assert got["stats"]["handoff"]["handoffs"] == len(ps)
    assert pre["prefill_tokens"] > 0 and dec["prefill_tokens"] == 0
    return got
