"""Data-axis sharded serving: N independent engine shards, one placement
plane, fault-tolerant migration between them.

Each shard owns a full ``Engine`` on its device (``dist/sharding.py``,
``shard_devices``): its own pools, block tables, prefix and snapshot
indexes, stepped under its device, so shards never contend on a pool
and each step loop is exactly the single-engine datapath (one shard IS
one plain Engine).  Shards on one device share its parameters, placed
there once; with fewer devices than shards, shards share a device and
step in turn.  On top sits one placement plane, as in the JAX package's
``repro.serving.sharded``:

  * ``submit`` places each request on the alive shard with the least
    committed-token load (``prompt + max_new`` over every unfinished
    request, the budget the scheduler admits by);
  * ``migrate`` moves a live request between shards through the
    content-hash swap serialization as SWAP-TO-PEER: the source
    serializes against the DESTINATION's prefix and snapshot indexes
    (``swap_out(peer=...)``), so blocks and snapshots the destination
    holds by hash never cross — only the tail is copied, into host
    (CPU) tensors, and the destination's ordinary ``swap_in`` re-adopts
    the head and copies the tail to its own device at admission;
  * ``kill_shard`` / ``reap`` (``dist/fault.py``'s heartbeat monitor):
    a dead shard's requests are rescued, not dropped.  FINISHED output
    already lives on the host; SWAPPED requests carry host copies and
    re-admit on a survivor (hash chains it lacks fall back to the
    ``swap_lost`` recompute); RUNNING requests lose their device state
    and are requeued for recompute from scratch, the loss shown as
    ``swap_lost`` (reason ``shard_lost``) in ``stall_reasons()`` and the
    trace.  Sampling keys are a pure function of (seed, position), so
    every rescued request finishes with the same tokens.

Worker roles (serving/roles.py): ``roles=["prefill", "decode", ...]``
or a ``"P:D"`` spec.  Fresh prompts go to the prefill shard with the
shallowest prefill queue (pending prompt tokens); a finished prompt is
handed to the decode shard with the least committed-token load over the
same swap-to-peer path (``_handoff``), and the destination's scheduler
parks it for the modelled link transfer (``transfer_pending``).  Every
handoff emits paired ``handoff_out``/``handoff_in`` spans sharing a
``handoff_id``, with the bytes moved and the modelled ``transfer_s``.

Per-shard tracing and stats: each shard's tracer writes its own meta
(``shard``, ``n_shards``, ``role``) and step records, and ``stats()``
reports each shard's decode tokens/s over ITS OWN stepped wall time next
to their sum, the aggregate — the rate N hosts stepping concurrently
would sustain, not a throughput of shards that share one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.dist.fault import HeartbeatMonitor
from repro_torch.dist.sharding import shard_devices
from repro_torch.serving import roles as R
from repro_torch.serving.engine import Engine, EngineConfig, nearest_rank
from repro_torch.serving.request import State
from repro_torch.serving.sampling import SamplingParams


def _exact(dev) -> torch.device:
    """``dev`` with its index: ``cuda`` is the current CUDA device."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _to(tree, dev, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _to(v, dev, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, dev, copy) for v in tree]
    return tree.to(dev, copy=copy) if isinstance(tree, torch.Tensor) \
        else tree


def params_on(params: dict, cfg, dev: torch.device, *,
              copy: bool = False) -> dict:
    """``params`` on ``dev``: the same dict when they live there already
    and not ``copy``, else a copy there (a tied head stays a view of
    the embedding)."""
    if not copy and _exact(params["embed"]["w"].device) == dev:
        return params
    out = _to(params, dev, copy)
    if cfg.tie_embeddings:
        out["head"] = {"w": out["embed"]["w"].t()}
    return out


class ShardedEngine:
    """N serving shards over the data axis and one placement plane;
    ``devices`` are the devices the shards spread over
    (``shard_devices``; default every CUDA device, and without a card
    it raises)."""

    def __init__(self, params, cfg, ecfg: EngineConfig, n_shards: int, *,
                 devices=None, dead_after: float = 60.0,
                 roles: list[str] | str | None = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.cfg = cfg
        self.ecfg = ecfg
        self.n_shards = n_shards
        # worker role per shard (serving/roles.py): all mixed by default,
        # the correctness oracle
        if roles is None:
            roles = [ecfg.role] * n_shards
        elif isinstance(roles, str):
            roles = R.parse_roles(roles, n_shards)
        R.validate_roles(list(roles), n_shards)
        self.roles = list(roles)
        # the devices to spread the shards over (shard_devices' rule:
        # a disjoint slice each, or tiled); default every CUDA device
        self.devices = [_exact(d) for d in
                        shard_devices(n_shards, devices=devices)]
        # the params once per distinct device: shards on one device share
        # them (N copies on one card would only cost memory)
        placed: dict[torch.device, dict] = {}
        self.engines: list[Engine] = []
        for i, dev in enumerate(self.devices):
            if dev not in placed:
                placed[dev] = params_on(params, cfg, dev)
            ecfg_i = (ecfg if self.roles[i] == ecfg.role
                      else dataclasses.replace(ecfg, role=self.roles[i]))
            with self._on_device(dev):
                eng = Engine(placed[dev], cfg, ecfg_i, device=dev)
            eng.shard = i
            eng.n_shards = n_shards
            self.engines.append(eng)
        self.alive: list[int] = list(range(n_shards))
        self.monitor = HeartbeatMonitor(n_shards, dead_after)
        # straggler medians compare within a role: prefill steps are
        # chunk-sized and rightly slower than decode steps
        self.monitor.set_groups(dict(enumerate(self.roles)))
        self.requests = {}           # global rid -> Request (outlives
        self.shard_of: dict[int, int] = {}   # its shard's death)
        self._next_rid = 0
        self.migrations = 0          # live-request moves between shards
        self.requeued_lost = 0       # rescued with their device state gone
        # the prefill->decode handoff plane's accounting
        self.handoffs = 0
        self.handoff_bytes = 0
        self._next_handoff_id = 0
        self.recommended_roles = ""  # the last advisory P:D (rebalance())

    # ----------------------------------------------------------- context

    @staticmethod
    def _on_device(dev: torch.device):
        """The shard's device as the current one (the counterpart of the
        JAX package's ``jax.default_device``); nothing on the CPU."""
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def _on_shard(self, i: int):
        with self._on_device(self.devices[i]):
            yield self.engines[i]

    # --------------------------------------------------------- placement

    _TERMINAL = (State.FINISHED, State.CANCELLED)

    def shard_load(self, i: int) -> int:
        """Committed-token footprint: the KV budget of every unfinished
        request the shard owns (queued, running and swapped)."""
        return sum(r.total_tokens for r in self.engines[i].requests.values()
                   if r.state not in self._TERMINAL)

    def tenant_load(self, i: int, tenant: str) -> int:
        """The same footprint for one tenant: the tenant-aware tie-break
        of placement (an slo tenant's budget is checked per shard, so
        spreading a tenant raises the concurrency its budget buys)."""
        return sum(r.total_tokens for r in self.engines[i].requests.values()
                   if r.state not in self._TERMINAL and r.tenant == tenant)

    def prefill_depth(self, i: int) -> int:
        """Prefill queue depth: prompt tokens still to compute over the
        shard's unfinished requests — what fresh prompts balance on."""
        return sum(max(r.prompt_len - r.pos, 0)
                   for r in self.engines[i].requests.values()
                   if r.state not in (State.FINISHED, State.CANCELLED,
                                      State.DECODE))

    def _alive_roles(self, pred) -> list[int]:
        return [i for i in self.alive if pred(R.get_role(self.roles[i]))]

    def _place(self, exclude: int | None = None,
               tenant: str | None = None) -> int:
        """The least-loaded alive DECODE-CAPABLE shard: where anything
        past its prompt goes (handoffs, migration, decode rescue).
        ``tenant`` breaks load ties toward the shard with the least of
        that tenant's footprint."""
        cands = [i for i in self._alive_roles(lambda r: r.runs_decode)
                 if i != exclude]
        if not cands:
            raise RuntimeError("no alive decode-capable shard to place on")
        return min(cands, key=lambda i: (
            self.shard_load(i),
            self.tenant_load(i, tenant) if tenant else 0, i))

    def _place_fresh(self, tenant: str | None = None) -> int:
        """Where a request that still needs its prompt computed goes: the
        shallowest alive prefill shard, else the least-loaded
        decode-capable one (decode shards run the full datapath, so
        losing every prefill shard degrades to the mixed topology)."""
        prefill = self._alive_roles(lambda r: r.hands_off)
        if prefill:
            return min(prefill, key=lambda i: (
                self.prefill_depth(i),
                self.tenant_load(i, tenant) if tenant else 0, i))
        return self._place(tenant=tenant)

    # --------------------------------------------------------------- API

    def submit(self, prompt, max_new: int, *, shard: int | None = None,
               priority: int = 0, arrival_s: float = 0.0,
               sampling: SamplingParams | None = None,
               tenant: str = "default", slo_class: str = "",
               score: bool = False) -> int:
        """Place a request on the least-loaded alive shard (or a pinned
        one) under a GLOBAL rid space."""
        if shard is None:
            shard = self._place_fresh(tenant=tenant)
        elif shard not in self.alive:
            raise ValueError(f"shard {shard} is not alive")
        rid = self._next_rid
        self._next_rid += 1
        with self._on_shard(shard) as eng:
            eng.submit(prompt, max_new, priority=priority,
                       arrival_s=arrival_s, sampling=sampling, rid=rid,
                       tenant=tenant, slo_class=slo_class, score=score)
        self.requests[rid] = eng.requests[rid]
        self.shard_of[rid] = shard
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel wherever the request lives now — also while it is
        parked in a prefill shard's ``handoff_ready`` (the engine drops
        it from there, so it is never exported)."""
        i = self.shard_of.get(rid)
        if i is None:
            return False
        with self._on_shard(i) as eng:
            return eng.cancel(rid)

    def set_commit_callback(self, cb):
        """One streaming callback across every shard: rids are global,
        so commits interleave into one stream wherever a request runs
        (or migrates to)."""
        for eng in self.engines:
            eng.set_commit_callback(cb)

    def step(self) -> bool:
        """One iteration of every alive, non-idle shard, in turn (each
        shard's own wall time is in its tracer, so per-shard rates stay
        honest)."""
        progressed = False
        for i in self.alive:
            eng = self.engines[i]
            # a terminal rid may be parked on an otherwise idle shard:
            # drain before the idle check so it never lingers
            progressed = self._drain_handoffs(i) or progressed
            if eng.scheduler.idle:
                continue
            t0 = time.perf_counter()
            with self._on_shard(i):
                progressed = eng.step() or progressed
            self.monitor.beat(i, time.monotonic(),
                              time.perf_counter() - t0)
            # hand completed prefills to decode shards at once: the
            # handoff is part of the same step
            progressed = self._drain_handoffs(i) or progressed
        return progressed

    def _drain_handoffs(self, i: int) -> bool:
        """Export shard ``i``'s parked completed prefills to decode
        peers; a request that reached a terminal state while parked is
        dropped instead (it would re-adopt dead work on the peer)."""
        eng = self.engines[i]
        moved = False
        while eng.handoff_ready:
            rid = eng.handoff_ready.pop(0)
            req = eng.requests.get(rid)
            if req is None or req.state in self._TERMINAL:
                continue
            self._handoff(i, rid)
            moved = True
        return moved

    @property
    def idle(self) -> bool:
        return all(self.engines[i].scheduler.idle for i in self.alive)

    def stall_reasons(self) -> dict[int, tuple[str, str]]:
        merged: dict[int, tuple[str, str]] = {}
        for i in self.alive:
            merged.update(self.engines[i].scheduler.stall_reasons())
        return merged

    def run(self) -> dict[int, np.ndarray]:
        """Drive every alive shard until drained; returns rid -> prompt +
        generated tokens of every finished request, also of those that
        finished on a shard that has died since (their output is on the
        host) and of those rescued FROM a dead shard."""
        while not self.idle:
            if not self.step():
                stalls = self.stall_reasons()
                detail = "; ".join(
                    f"rid={rid}[{state}]: {why}"
                    for rid, (state, why) in sorted(stalls.items()))
                raise RuntimeError(
                    "sharded engine stalled — last defer/swap_lost "
                    f"reason per request: {detail}")
        return {rid: r.full_sequence() for rid, r in self.requests.items()
                if r.state == State.FINISHED}

    # --------------------------------------------------------- migration

    def migrate(self, rid: int, dst: int | None = None) -> int:
        """Move a live request to ``dst`` (default: the least-loaded
        other alive shard) by swap-to-peer; returns the destination."""
        src = self.shard_of[rid]
        req = self.requests[rid]
        if req.state == State.FINISHED:
            raise ValueError(f"rid={rid} already finished")
        if dst is None:
            dst = self._place(exclude=src)
        if dst not in self.alive:
            raise ValueError(f"shard {dst} is not alive")
        if dst == src:
            return dst
        dst_eng = self.engines[dst]
        with self._on_shard(src) as eng:
            req = eng.export_request(rid, peer=dst_eng)
        with self._on_shard(dst):
            dst_eng.adopt_request(req)
        self.shard_of[rid] = dst
        self.migrations += 1
        return dst

    def _handoff(self, src: int, rid: int) -> int:
        """Move a completed prefill from shard ``src`` to a decode shard:
        the swap-to-peer serialization of ``migrate`` plus the modelled
        transfer — the destination parks the request for
        ``transfer_steps_overlap(bytes)`` of its own steps, and the two
        sides emit a ``handoff_out``/``handoff_in`` span pair sharing a
        ``handoff_id`` (the trace viewer's flow arrow)."""
        dst = self._place(tenant=self.engines[src].requests[rid].tenant)
        dst_eng = self.engines[dst]
        hid = self._next_handoff_id
        self._next_handoff_id += 1
        with self._on_shard(src) as se, \
                se.tracer.span("handoff_out", rid, handoff_id=hid,
                               peer=dst) as sp:
            req = se.export_request(rid, peer=dst_eng)
            n_bytes = R.host_bytes(req)
            sp.extra["bytes"] = n_bytes
        transfer_s = dst_eng.cost_model.transfer_latency_s(n_bytes)
        req.transfer_steps = dst_eng.cost_model.transfer_steps_overlap(
            n_bytes)
        with self._on_shard(dst), \
                dst_eng.tracer.span("handoff_in", rid, handoff_id=hid,
                                    peer=src, bytes=n_bytes,
                                    transfer_s=transfer_s):
            dst_eng.adopt_request(req)
        self.shard_of[rid] = dst
        self.handoffs += 1
        self.handoff_bytes += n_bytes
        return dst

    def recommend_roles(self) -> str:
        """A P:D split from observed pressure: prefill-queue tokens per
        prefill shard against committed-token load per decode shard.
        When one side's pressure exceeds twice the other's and the other
        side can give up a shard, one shard moves across.  Advisory
        only: nothing is re-roled live.  "" for topologies with no
        dedicated prefill shard."""
        pre = self._alive_roles(lambda r: r.hands_off)
        dec = self._alive_roles(lambda r: r.runs_decode)
        if not pre or not dec:
            return ""
        p, d = len(pre), len(dec)
        prefill_pressure = sum(self.prefill_depth(i) for i in pre) / p
        decode_pressure = sum(self.shard_load(i) for i in dec) / d
        rp, rd = p, d
        if prefill_pressure > 2 * decode_pressure and d > 1:
            rp, rd = p + 1, d - 1
        elif decode_pressure > 2 * prefill_pressure and p > 1:
            rp, rd = p - 1, d + 1
        return f"{rp}:{rd}"

    def rebalance(self, max_moves: int = 1) -> int:
        """Move up to ``max_moves`` QUEUED requests from the most- to the
        least-loaded shard of a role class when the gap exceeds one
        request's footprint (moving waiting work costs nothing: no state
        crosses).  Also refreshes the advisory P:D: a recommendation
        that differs from the topology is printed once per change and
        kept in ``stats()["recommended_roles"]``."""
        rec = self.recommend_roles()
        if rec and rec != self.recommended_roles:
            cur = "%d:%d" % (len(self._alive_roles(lambda r: r.hands_off)),
                             len(self._alive_roles(lambda r: r.runs_decode)))
            if rec != cur:
                print(f"[sharded] role auto-tune: observed pressure "
                      f"suggests roles {rec} (currently {cur}); "
                      f"re-launch with --roles {rec} to apply")
        self.recommended_roles = rec
        moved = 0
        groups = [g for g in (self._alive_roles(lambda r: r.hands_off),
                              self._alive_roles(lambda r: r.runs_decode))
                  if len(g) >= 2]
        for group in groups:
            while moved < max_moves:
                hi = max(group, key=self.shard_load)
                lo = min(group, key=lambda i: (self.shard_load(i), i))
                queued = [r for r in self.engines[hi].scheduler.queue
                          if r.state == State.QUEUED]
                if hi == lo or not queued:
                    break
                victim = max(queued, key=lambda r: r._order)   # youngest
                if self.shard_load(hi) - self.shard_load(lo) \
                        < victim.total_tokens:
                    break
                self.migrate(victim.rid, lo)
                moved += 1
        return moved

    # ------------------------------------------------------------- fault

    def kill_shard(self, i: int):
        """Lose shard ``i``: its device state is unreachable, but no
        request is dropped (the module docstring's rescue rules)."""
        if i not in self.alive:
            raise ValueError(f"shard {i} is not alive")
        self.alive.remove(i)
        if not self.alive:
            raise RuntimeError("last shard killed — nothing to rescue onto")
        if not self._alive_roles(lambda r: r.runs_decode):
            raise RuntimeError(
                "last decode-capable shard killed — the surviving "
                "prefill shards can never finish a request")
        eng = self.engines[i]
        for rid, req in list(eng.requests.items()):
            if req.state in self._TERMINAL:
                continue             # its output is on the host already
            # a SWAPPED request's state is in host copies and re-admits
            # on a survivor; anything still on the dead device is
            # recomputed from scratch.  A request that still needs
            # prompt compute (every lost one: recompute starts at 0)
            # goes through fresh-prompt placement, a swapped one past
            # its prompt to a decode shard
            lost = req.state != State.SWAPPED
            dst = (self._place_fresh() if lost or req.pos < req.prompt_len
                   else self._place())
            with self._on_shard(dst) as de:
                de.adopt_request(req, lost=lost)
            self.shard_of[rid] = dst
            if lost:
                self.requeued_lost += 1
        eng.requests.clear()
        eng.scheduler.queue.clear()
        eng.scheduler.running.clear()
        eng.handoff_ready.clear()

    def reap(self, now: float | None = None) -> list[int]:
        """Kill every shard the heartbeat monitor declares dead at
        ``now`` (default: ``time.monotonic()``)."""
        now = time.monotonic() if now is None else now
        dead = [h for h in self.monitor.dead_hosts(now) if h in self.alive]
        for h in dead:
            self.kill_shard(h)
        return dead

    # ----------------------------------------------------------- tracing

    def start_trace(self, prefix: str | None = None, *, ring: int = 4096,
                    capture_logits: bool = False):
        """Per-shard traces: ``{prefix}.shard{i}.jsonl``, each with its
        own meta record carrying the shard and its role (the trace
        viewer merges them into one timeline)."""
        out = []
        for i, eng in enumerate(self.engines):
            path = f"{prefix}.shard{i}.jsonl" if prefix else None
            out.append(eng.start_trace(path, ring=ring,
                                       capture_logits=capture_logits))
        return out

    def stop_trace(self):
        for eng in self.engines:
            eng.stop_trace()

    # ------------------------------------------------------------- stats

    def reset_stats(self, *, flush_prefix: bool = False):
        for eng in self.engines:
            eng.reset_stats(flush_prefix=flush_prefix)
        self.handoffs = 0
        self.handoff_bytes = 0

    def apply_replay_curve(self, curve: dict) -> int:
        """Hand the modelled verify-chunk break-even to every shard
        (``Engine.apply_replay_curve``)."""
        k = 0
        for eng in self.engines:
            k = eng.apply_replay_curve(curve)
        return k

    def stats(self) -> dict:
        per_shard = []
        agg_rate = 0.0
        for i, eng in enumerate(self.engines):
            wall = eng.tracer.span_total("step")
            # decode rate over the shard's OWN stepped wall time: the
            # JAX package's model of N hosts stepping concurrently sums
            # per-host rates
            rate = eng._decoded / wall if wall else 0.0
            per_shard.append({
                "shard": i,
                "role": self.roles[i],
                "alive": i in self.alive,
                "finished": sum(1 for r in eng.requests.values()
                                if r.state == State.FINISHED),
                "decoded_tokens": eng._decoded,
                "prefill_tokens": eng._prefilled,
                "wall_s": wall,
                "decode_tokens_per_s": rate,
                "swap_losts": eng.scheduler.swap_losts,
                "preemptions": eng.scheduler.preempts,
            })
            if i in self.alive or eng._decoded:
                agg_rate += rate
        finished = [r for r in self.requests.values()
                    if r.state == State.FINISHED]
        lat = sorted(r.finish_s - r.submit_s for r in finished
                     if r.finish_s is not None and r.submit_s is not None)
        # the handoffs' wall time is the host-side copy; the MODELLED
        # link transfer comes from a decode-capable shard's cost model
        decode_idx = self._alive_roles(lambda r: r.runs_decode)
        cm = self.engines[decode_idx[0] if decode_idx else 0].cost_model
        handoff_wall_s = sum(
            eng.tracer.span_total("handoff_out")
            + eng.tracer.span_total("handoff_in")
            for eng in self.engines)
        return {
            "n_shards": self.n_shards,
            "roles": list(self.roles),
            "alive_shards": list(self.alive),
            "finished": len(finished),
            "decoded_tokens": sum(p["decoded_tokens"] for p in per_shard),
            "prefill_tokens": sum(p["prefill_tokens"] for p in per_shard),
            "aggregate_decode_tokens_per_s": agg_rate,
            "p50_latency_s": nearest_rank(lat, 50),
            "p99_latency_s": nearest_rank(lat, 99),
            "migrations": self.migrations,
            "requeued_lost": self.requeued_lost,
            "recommended_roles": self.recommended_roles,
            "handoff": {
                **cm.handoff_report(handoffs=self.handoffs,
                                    handoff_bytes=self.handoff_bytes),
                "host_copy_wall_s": handoff_wall_s,
            },
            "per_shard": per_shard,
        }
