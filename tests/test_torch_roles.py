"""The units of worker roles and sharded serving against the JAX package:
role flags and topology specs, the heartbeat monitor and re-mesh plan
(``repro_torch.dist.fault``, a copy of ``repro.dist.fault``), the
per-shard device rule, ``host_bytes`` over swap-to-host and
swap-to-peer host copies (block, slot and hybrid caches), the
``transfer_pending`` gate, the per-role step closures and speculative
budget, and the scheduler's role pieces (``adopt``, the prefill role's
plan and ``awaiting_handoff``), each equal to JAX's field for field.
Exact comparisons throughout (bytes, events and plans are integers and
strings)."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import _torch_shards as H
from repro.dist import fault as JF
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MixerStateCache as JCache, Request as JRequest
from repro.serving import roles as JR
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch.dist import fault as TF
from repro_torch.dist.sharding import shard_devices
from repro_torch.serving import MixerStateCache as TCache, Request as TRequest
from repro_torch.serving import State, roles as TR
from repro_torch.serving.scheduler import Scheduler as TScheduler
from repro_torch.serving.scheduler import SchedulerConfig as TSchedulerConfig

torch.set_num_threads(1)


def _same_outcome(f_jax, f_port):
    """Both calls return equal values, or both raise ValueError."""
    try:
        want = f_jax()
    except ValueError:
        with pytest.raises(ValueError):
            f_port()
        return None
    got = f_port()
    assert got == want
    return got


# ------------------------------------------------------------- roles

def test_role_flags_equal_jax():
    assert sorted(TR.ROLES) == sorted(JR.ROLES)
    for name, role in TR.ROLES.items():
        j = JR.ROLES[name]
        assert (role.name, role.runs_decode, role.hands_off) == \
            (j.name, j.runs_decode, j.hands_off)
        assert TR.get_role(name) is role
    assert (TR.MIXED.name, TR.PREFILL.name, TR.DECODE.name) == \
        ("mixed", "prefill", "decode")
    with pytest.raises(ValueError, match="unknown role"):
        TR.get_role("bogus")


@pytest.mark.parametrize("spec,n", [
    ("1:2", 3), ("2:2", 4), ("0:3", 3), ("1:1", 2), ("1:1", 3), ("2:0", 2),
    ("-1:2", 1), ("prefill,decode,mixed", 3), ("prefill,bogus", 2),
    (" mixed , decode ", None), ("prefill,prefill", 2), ("3:1", None),
    ("mixed", 1), ("a:b", 2)])
def test_parse_roles_equals_jax(spec, n):
    _same_outcome(lambda: JR.parse_roles(spec, n),
                  lambda: TR.parse_roles(spec, n))


@pytest.mark.parametrize("roles,n", [
    (["prefill", "prefill"], None), (["prefill", "decode"], 2),
    (["prefill", "decode"], 3), (["mixed"], None), ([], None),
    (["decode", "x"], 2)])
def test_validate_roles_equals_jax(roles, n):
    _same_outcome(lambda: JR.validate_roles(roles, n),
                  lambda: TR.validate_roles(roles, n))


# ---------------------------------------------------- dist.fault copy

@pytest.mark.parametrize("seed", range(6))
def test_heartbeat_monitor_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    dead_after = float(rng.uniform(0.5, 5.0))
    mons = [JF.HeartbeatMonitor(n, dead_after, straggler_factor=1.5),
            TF.HeartbeatMonitor(n, dead_after, straggler_factor=1.5)]
    groups = {h: ("prefill", "decode")[int(rng.integers(0, 2))]
              for h in range(n) if rng.random() < 0.7}
    for m in mons:
        m.set_groups(groups)
    for _ in range(20):
        h = int(rng.integers(0, n))
        now = float(rng.uniform(0, 10))
        st = None if rng.random() < 0.2 else float(rng.uniform(0.01, 1.0))
        for m in mons:
            m.beat(h, now, st)
        t = float(rng.uniform(0, 12))
        j, p = mons
        assert p.stragglers() == j.stragglers()
        assert p.dead_hosts(t) == j.dead_hosts(t)
        assert p.to_drain(t) == j.to_drain(t)


@pytest.mark.parametrize("mp,full_data,full_pod", [
    (16, 16, 2), (8, 16, 2), (4, 4, 1), (1, 6, 3), (2, 1, 1)])
def test_plan_remesh_equals_jax(mp, full_data, full_pod):
    def plan(mod, n):
        p = mod.plan_remesh(n, model_parallel=mp, full_data=full_data,
                            full_pod=full_pod)
        assert p.devices_used == p.pod * p.data * p.model <= n
        return dataclasses.astuple(p)
    for n in range(0, mp * full_data * full_pod + 3):
        _same_outcome(lambda: plan(JF, n), lambda: plan(TF, n))


def test_shard_devices_slices_or_tiles():
    devs = [torch.device("cuda", i) for i in range(4)]
    idx = lambda out: [d.index for d in out]            # noqa: E731
    assert idx(shard_devices(2, devices=devs)) == [0, 2]    # a slice each
    assert idx(shard_devices(4, devices=devs)) == [0, 1, 2, 3]
    assert idx(shard_devices(3, devices=devs)) == [0, 1, 2]
    assert idx(shard_devices(6, devices=devs)) == [0, 1, 2, 3, 0, 1]
    cpu = shard_devices(3, devices=["cpu"])              # tiled, as JAX's
    assert cpu == [torch.device("cpu")] * 3             # single device
    with pytest.raises(ValueError):
        shard_devices(0, devices=devs)


def test_shard_devices_without_a_card_raises(bnn_cfg, bnn_params):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_devices(2)
    tcfg, tp = H.port_model("bnn-lm-100m", bnn_params)
    from repro_torch.serving import EngineConfig, ShardedEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEngine(tp, tcfg, EngineConfig(**H.EKW), 2)


# ------------------------------------------------ host_bytes and swaps

CACHE = dict(num_blocks=17, block_size=4, max_model_len=32, num_slots=3,
             prefill_chunk=4, snapshot_slots=4)
CASES = ("own", "own_nocache", "peer_full", "peer_head", "peer_none")


def _swap(pkg, cfg, case, prompt):
    """A request's prompt prefilled and registered in one cache, two
    tokens out, then swapped out against its own index or a peer's that
    holds all, the head or none of its hash chain."""
    Cache, Req, host_bytes = ((JCache, JRequest, JR.host_bytes)
                              if pkg == "jax" else
                              (TCache, TRequest, TR.host_bytes))
    kw = dict(CACHE, prefix_cache=case != "own_nocache")
    if pkg == "torch":
        kw["device"] = "cpu"
    src, dst = Cache(cfg, **kw), Cache(cfg, **kw)
    r = Req(0, prompt, 4)
    assert src.alloc_prompt(r)
    r.pos = len(prompt)
    src.register_prefix(r)
    r.out = [7, 9]
    peer = None
    if case.startswith("peer"):
        peer = dst
        held = {"peer_full": prompt, "peer_head": np.concatenate(
            [prompt[:4], prompt[4:] + 1]), "peer_none": prompt + 1}[case]
        q = Req(1, held, 4)
        assert dst.alloc_prompt(q)
        q.pos = len(held)
        dst.register_prefix(q)
    src.swap_out(r, peer=peer)
    return (host_bytes(r), r.swap_readopt, r.n_registered, r.prefix_key,
            r.snap_readopt, r.host_state is not None)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("family", ["bnn", "ssm", "hybrid"])
def test_host_bytes_of_swaps_equal_jax(family, case, bnn_cfg, family_models,
                                       jamba_models):
    arch, jcfg = {"bnn": ("bnn-lm-100m", bnn_cfg),
                  "ssm": ("mamba2-1.3b", family_models["ssm"][0]),
                  "hybrid": ("jamba-1.5-large-398b", jamba_models[0])}[family]
    tcfg = H.port_cfg(arch)
    prompt = H.prompts(jcfg.vocab, [12], seed=len(case))[0]
    want = _swap("jax", jcfg, case, prompt)
    got = _swap("torch", tcfg, case, prompt)
    assert got == want
    if case in ("own", "peer_full") and family == "bnn":
        assert want[1] == 3 and want[0] == prompt.nbytes + 8   # nothing
    if case == "peer_none":                                    # copied
        assert want[1] == 0 and want[3] == ""


def test_transfer_pending_gate_equals_jax():
    reqs = [JRequest(0, np.arange(4, dtype=np.int32), 2),
            TRequest(0, np.arange(4, dtype=np.int32), 2)]
    for step in (0, 3):
        assert [JR.transfer_pending(reqs[0], step),
                TR.transfer_pending(reqs[1], step)] == [False, False]
    for r in reqs:
        r.transfer_steps, r.transfer_until_step = 3, 5
    seen = []
    for step in (2, 4, 5, 6):
        seen.append((JR.transfer_pending(reqs[0], step),
                     TR.transfer_pending(reqs[1], step)))
    assert seen == [(True, True), (True, True), (False, False),
                    (False, False)]
    assert [(r.transfer_steps, r.transfer_until_step) for r in reqs] == \
        [(0, None), (0, None)]
    for r in reqs:                       # recompute clears the marks
        r.transfer_steps, r.transfer_until_step = 2, 9
        r.reset_for_requeue()
        assert (r.transfer_steps, r.transfer_until_step) == (0, None)


# ------------------------------------------- step closures and budget

@pytest.mark.parametrize("role,spec_k", itertools.product(
    ["mixed", "prefill", "decode"], [0, 3]))
def test_step_closures_and_spec_budget_per_role(role, spec_k, bnn_cfg,
                                                bnn_params):
    from repro.serving import Engine as JEngine
    tcfg, tp = H.port_model("bnn-lm-100m", bnn_params)
    fns = TR.build_step_fns(tcfg, spec_k=spec_k, role=TR.get_role(role))
    jfns = JR.build_step_fns(bnn_cfg, JEngineConfig(**H.XLA),
                             JR.get_role(role), ring=False, spec_k=spec_k)
    for name in ("prefill", "decode", "spec", "repair"):
        assert (getattr(fns, name) is None) == \
            (getattr(jfns, name) is None), name
    eng = H.port_engine(tcfg, tp, role=role, spec_k=spec_k)
    jeng = JEngine(bnn_params, bnn_cfg,
                   JEngineConfig(**H.EKW, **H.XLA, role=role, spec_k=spec_k))
    assert (eng.role.name, eng._spec_k, eng.scheduler.decode_cost) == \
        (jeng.role.name, jeng._spec_k, jeng.scheduler.decode_cost)
    assert eng.handoff_ready == [] and eng.stats()["role"] == role


# -------------------------------------------------- scheduler's pieces

def _scheduler_story(pkg, cfg):
    """A prefill worker's scheduler: two requests admitted, one reaches
    DECODE (its plan carries no decode row; it reads awaiting_handoff);
    a migrated request adopted while its transfer streams in (deferred
    as transfer_pending, not blocking the queue), and a lost one."""
    if pkg == "jax":
        cache = JCache(cfg, **CACHE)
        sched = JScheduler(JSchedulerConfig(max_batch=2, prefill_chunk=4),
                           cache, role=JR.PREFILL)
        Req, st = JRequest, None
    else:
        cache = TCache(cfg, **CACHE, device="cpu")
        sched = TScheduler(TSchedulerConfig(max_batch=2, prefill_chunk=4),
                           cache, role=TR.PREFILL)
        Req = TRequest
    st = {}
    ps = H.prompts(cfg.vocab, [6, 5, 4, 4], seed=3)
    a, b = Req(0, ps[0], 4), Req(1, ps[1], 4)
    sched.submit(a, 0)
    sched.submit(b, 0)
    plan = sched.schedule(0)
    st["admitted"] = [r.rid for r in plan.admitted]
    a.pos, a.state = a.prompt_len, type(a.state).DECODE
    plan = sched.schedule(1)
    st["plan1"] = ([r.rid for r in plan.decode], plan.prefill.rid,
                   plan.prefill_tokens, plan.has_work)
    st["stalls1"] = sched.stall_reasons()
    c = Req(2, ps[2], 4)
    c.transfer_steps, c.transfer_until_step = 2, 5
    sched.adopt(c, 2)
    d = Req(3, ps[3], 4)
    d.reset_for_requeue()
    sched.adopt(d, 2, lost=True)
    plan = sched.schedule(3)
    st["plan3"] = ([r.rid for r in plan.admitted], plan.transfer_waits,
                   plan.has_work)
    st["swap_losts"] = sched.swap_losts
    st["stalls3"] = sched.stall_reasons()
    st["events"] = [{k: v for k, v in e.items() if k != "slot"}
                    for e in sched.trace]
    return st


def test_scheduler_role_pieces_equal_jax(bnn_cfg):
    tcfg = H.port_cfg("bnn-lm-100m")
    want = _scheduler_story("jax", bnn_cfg)
    got = _scheduler_story("torch", tcfg)
    assert got == want
    assert got["plan1"][0] == []                  # no decode row here
    assert got["stalls1"][0] == ("decode", "awaiting_handoff")
    assert any(e["event"] == "swap_lost" and e.get("reason") == "shard_lost"
               for e in got["events"])
    assert any(e.get("reason") == "transfer_pending"
               and e.get("until_step") == 5 for e in got["events"])
    assert State.DECODE.value == "decode"
