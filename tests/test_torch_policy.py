"""The port's scheduling policies (``serving/policy.py``) against the JAX
package's.

Policy level: on seeded random request sets (priorities, tenants, slo
classes, prefill/decode states, arrival order), each policy's queue
order, prefill order and victim equal JAX's; ``parse_tenants`` and
``tenants_arg`` give JAX's specs and strings for all three input forms,
and ``TenantSpec`` rejects what JAX's rejects.

Engine level: the reduced bnn-lm-100m under ``priority`` and under
``slo`` with two budgeted tenants, on a seeded Poisson trace with a
pool small enough to swap: tokens, the scheduler's whole event list
(the port's ``admit`` events carry the request's ``slot`` besides) and
``tenant_report`` after every step equal the JAX engine's; the slo run
defers on ``tenant_budget`` and preempts.  Each engine runs once a
session (a module fixture); every comparison is exact."""
import numpy as np
import pytest
import torch

import _torch_family as F
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serving import policy as JP
from repro.serving.request import Request as JRequest, State as JState
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving import policy as P
from repro_torch.serving.request import Request, State

torch.set_num_threads(1)

ARCH = "bnn-lm-100m"
TENANTS = "a=latency:44,b=throughput:60"
POLICIES = {"fcfs": None, "priority": None, "slo": TENANTS}


def _requests(seed: int):
    """The same random request set in both packages' Request types."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    out = {"jax": [], "torch": []}
    orders = rng.permutation(n)
    for i in range(n):
        kw = dict(priority=int(rng.integers(0, 3)),
                  tenant=["a", "b", "c"][int(rng.integers(0, 3))],
                  slo_class=["", "latency", "throughput"][
                      int(rng.integers(0, 3))])
        decode = bool(rng.integers(0, 2))
        prompt = rng.integers(0, 100, int(rng.integers(1, 9)))
        max_new = int(rng.integers(1, 5))
        for side, R, S in (("jax", JRequest, JState),
                           ("torch", Request, State)):
            r = R(i, prompt.astype(np.int32), max_new, **kw)
            r._order = int(orders[i])
            r.state = S.DECODE if decode else S.PREFILL
            out[side].append(r)
    return out


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_orders_and_victims_equal_jax(name):
    jpol = JP.make_policy(name, tenants=POLICIES[name])
    tpol = P.make_policy(name, tenants=POLICIES[name])
    assert tpol.name == jpol.name == name
    for seed in range(40):
        reqs = _requests(seed)
        for fn in ("queue_order", "prefill_order"):
            assert [r.rid for r in getattr(tpol, fn)(reqs["torch"])] == \
                [r.rid for r in getattr(jpol, fn)(reqs["jax"])], (seed, fn)
        assert tpol.victim(reqs["torch"]).rid == \
            jpol.victim(reqs["jax"]).rid, seed
        assert [tpol.slo_class(r) for r in reqs["torch"]] == \
            [jpol.slo_class(r) for r in reqs["jax"]]


SPECS = ["", "a=latency:2048,b=throughput", " x = throughput : 7 ,, y=",
         "solo=latency", [("a", "latency", 5), ("b", "throughput", 0)],
         {"t": P.TenantSpec("t", "throughput", 3)}]


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_parse_tenants_and_tenants_arg_equal_jax(spec):
    jspec = ({k: JP.TenantSpec(v.name, v.slo_class, v.token_budget)
              for k, v in spec.items()} if isinstance(spec, dict) else spec)
    got = {k: (t.name, t.slo_class, t.token_budget)
           for k, t in P.parse_tenants(spec).items()}
    want = {k: (t.name, t.slo_class, t.token_budget)
            for k, t in JP.parse_tenants(jspec).items()}
    assert got == want
    assert P.tenants_arg(spec) == JP.tenants_arg(jspec)
    # the canonical string round-trips
    assert P.tenants_arg(P.tenants_arg(spec)) == P.tenants_arg(spec)


@pytest.mark.parametrize("bad", ["a=fast", "a=latency:-1", "a=:x",
                                 [("a", "batch", 0)], [("a", "latency", -2)]])
def test_tenant_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        JP.parse_tenants(bad)
    with pytest.raises(ValueError):
        P.parse_tenants(bad)


def test_make_policy_and_engine_config_take_every_policy():
    with pytest.raises(ValueError, match="unknown policy"):
        P.make_policy("lifo")
    assert isinstance(P.make_policy("slo", tenants=TENANTS), P.SLOPolicy)
    for cls in (P.FCFSPolicy, P.PriorityPolicy, P.SLOPolicy):
        assert isinstance(cls(), P.SchedulingPolicy)
    for role in ("mixed", "prefill", "decode"):     # every role is ported
        assert EngineConfig(role=role).role == role
    for name in POLICIES:
        assert EngineConfig(policy=name).policy == name
    assert EngineConfig(tenants=TENANTS).tenants == TENANTS


# ---------------------------------------------------------- engine level

ENGINE = dict(block_size=4, num_blocks=12, max_batch=3, prefill_chunk=4,
              max_model_len=40)
GEN = 8


def _request_kw(policy: str):
    if policy == "priority":
        return lambda i: {"priority": i % 3}
    return lambda i: {"tenant": "ab"[i % 2]}


def _drive(eng, arrival, prompts, kw):
    """Submit each prompt at its arrival step under ``kw(i)``; after
    every step record ``tenant_report``.  Returns (each request's
    tokens, the reports)."""
    rids, i, reports = {}, 0, []
    while i < len(prompts) or not eng.scheduler.idle:
        while i < len(prompts) and eng.step_count >= arrival[i]:
            rids[i] = eng.submit(prompts[i], GEN, **kw(i))
            i += 1
        eng.step()
        reports.append(eng.scheduler.tenant_report())
    return ([eng.requests[rids[k]].full_sequence()
             for k in range(len(prompts))], reports)


@pytest.fixture(scope="module", params=["priority", "slo"])
def policy_runs(request):
    policy = request.param
    jp, tp = F.models(ARCH)
    jcfg, tcfg = F.cfgs(ARCH, "bnn")
    arrival, prompts = F.poisson_trace(jcfg.vocab, 12, (4, 5, 2), n=9)
    kw = dict(ENGINE, policy=policy,
              tenants=TENANTS if policy == "slo" else "")
    je = JEngine(jp, jcfg, JEngineConfig(**kw, attn_impl="xla",
                                         bnn_impl="xla"))
    te = Engine(tp, tcfg, EngineConfig(**kw), device="cpu")
    return policy, {"jax": (je, _drive(je, arrival, prompts,
                                       _request_kw(policy))),
                    "torch": (te, _drive(te, arrival, prompts,
                                         _request_kw(policy)))}


def test_engine_under_policy_equals_jax(policy_runs):
    policy, runs = policy_runs
    (je, (jout, jrep)), (te, (tout, trep)) = runs["jax"], runs["torch"]
    for a, b in zip(jout, tout, strict=True):
        np.testing.assert_array_equal(b, a)
    assert [{k: v for k, v in e.items() if k != "slot"}
            for e in te.scheduler.trace] == je.scheduler.trace
    assert trep == jrep
    js_, ts_ = je.stats(), te.stats()
    assert ts_["tenants"] == js_["tenants"]
    for key in ("preemptions", "steps", "prefill_tokens", "decoded_tokens"):
        assert ts_[key] == js_[key], key
    assert F.counts(ts_["swap"]) == F.counts(js_["swap"])
    # the trace exercised what the policy decides
    assert ts_["swap"]["swap_outs"] > 0
    reasons = {e.get("reason") for e in te.scheduler.trace
               if e["event"] == "defer"}
    if policy == "slo":
        assert "tenant_budget" in reasons
        assert any(r and r["a"]["stall"] == "tenant_budget" for r in trep)
        assert {e["slo_class"] for e in te.scheduler.trace
                if e["event"] == "submit"} == {"latency", "throughput"}
