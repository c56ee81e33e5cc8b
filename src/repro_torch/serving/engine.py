"""Event-driven continuous-batching inference engine.

One ``Engine.step()`` = one scheduler decision + at most one chunked
prefill call + one decode call over every running sequence.  Requests
are admitted and retired PER STEP, so new traffic joins a running batch
without draining it (continuous batching).

The decode batch is padded to power-of-two buckets and prefill always
runs at the fixed (1, prefill_chunk) shape, as in the JAX package (there
the fixed shapes bound the jit cache; here they keep the kernels'
launch shapes few).  The mixer-state pools (K/V or latent blocks,
recurrent SSM slots, or both in a hybrid stack) live on the engine's
device and the step functions update them in place.

Token selection happens on the device, next to the logits
(serving/sampling.py): each request carries SamplingParams
(temperature / top-k / top-p / seed / stop tokens) and the random
stream of the token at sequence index i is keyed by
fold_in(PRNGKey(seed), i), JAX's own bits — so a sampled stream does not
depend on batch composition, padding, preemption or swap-in.  A stop
token finishes the request at its first occurrence, releasing its
blocks or slot immediately.

With the JAX engine's defaults a prompt is first matched against the
prefix index (adopted blocks are not prefilled again; a shared block is
copied before it is written; a recurrent slot restores the deepest
snapshot of its prompt head), and a preempted request's blocks and slot
are swapped to host memory and restored when it is re-admitted.

Speculative decoding (``spec_k > 0``) drafts tokens by prompt lookup
(an n-gram match against the request's own prompt and output, on the
host) and verifies the whole draft in ONE prefill-shaped forward per
step.  A rejected suffix rolls back per layout: block and ring tables
by committing only the accepted length (the stale writes past it are
masked by each row's kv_len and ring positions), recurrent slots by
restoring their pre-verify copies and re-advancing by the accepted
prefix.  Since sampling is a pure function of (seed, position), the
verified stream equals plain decoding's at any temperature.

Scoring requests (``submit(..., score=True)``) run teacher-forced
chunked prefill only: every chunk's logits rows are read back and the
log-probability of each next prompt token is summed on the host in
float64; the request finishes from its last chunk and never decodes.
``start_trace`` records the engine's structured trace
(serving/tracing.py): one record a step, the requests' lifecycle events
and the swap/snapshot copies, in the JAX package's schema.

With cfg.precision == "bnn" every projection runs the packed
XNOR-popcount GEMM — the paper's inference mode.  On a CUDA device the
projections and the paged attention are the hand-written Hopper
kernels (kernels/); ``Engine(..., device="cpu")`` runs their plain
PyTorch versions and exists for tests.  The attached PhotonicCostModel
reports what the modeled OXBNN accelerator would sustain on the same
token stream (``stats()["photonic"]``), next to the measured wall clock.
"""
from __future__ import annotations

import math
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as M
from repro_torch.serving import roles as R
from repro_torch.serving.block_cache import MixerStateCache
from repro_torch.serving.cost_model import PhotonicCostModel
from repro_torch.serving.request import Request, State
from repro_torch.serving.sampling import (SamplingParams, prompt_lookup_draft,
                                         sampling_rows)
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.tracing import Tracer

STEP_ACTIONS = ("prefix_hits", "snapshot_hits", "preempts", "swap_losts",
                "swap_outs", "swap_ins")


def nearest_rank(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an ascending sample: the smallest
    value with at least p% of the sample at or below it — 0-indexed
    ``ceil(p/100 * n) - 1``."""
    if not len(sorted_vals):
        return float("nan")
    n = len(sorted_vals)
    idx = max(math.ceil(p / 100 * n) - 1, 0)
    return sorted_vals[min(idx, n - 1)]


@dataclass(frozen=True)
class EngineConfig:
    block_size: int = 16
    num_blocks: int = 129            # 1 scratch + 128 allocatable
    max_batch: int = 8               # decode slots (padded to 2^k buckets)
    prefill_chunk: int = 16
    max_model_len: int = 256         # prompt + generation bound per request
    num_slots: int = 0               # recurrent slots (SSM layers), slot 0
                                     # scratch; 0 = max_batch + 1
    policy: str = "fcfs"             # fcfs | priority | slo
    max_tokens_in_flight: int = 0    # KV-footprint admission budget;
                                     # 0 = auto (2x the block pool's
                                     # token capacity; unbounded without
                                     # a block pool)
    max_batched_tokens: int = 256
    tenants: str = ""                # slo-policy tenant spec in the
                                     # canonical "name=class:budget,..."
                                     # form (policy.tenants_arg)
    accelerator: str = "OXBNN_50"    # photonic cost-model target
    prefix_cache: bool = True        # content-addressed prompt block reuse
    preempt_policy: str = "swap"     # swap | recompute (fallback)
    snapshot_slots: int = 0          # recurrent prefix-snapshot pool rows
                                     # (0 = 2 * max_batch; gated by
                                     # prefix_cache like the block index)
    spec_k: int = 0                  # speculative draft length (0 = off)
    spec_ngram: int = 3              # max n-gram for prompt-lookup drafts
    attn_impl: str = "auto"          # paged attention: auto | cuda | torch
    bnn_impl: str = "auto"           # packed BNN GEMM: auto | cuda | torch
                                     # (one dispatch in the port: the two
                                     # must be equal)
    role: str = "mixed"              # worker role: mixed | prefill | decode
                                     # (serving/roles.py; prefill shards
                                     # hand completed prompts to a decode
                                     # peer through the ShardedEngine)
    link_gbps: float = 100.0         # modeled inter-shard link bandwidth
                                     # (prefill->decode handoff transfer)

    def __post_init__(self):
        if self.preempt_policy not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt_policy {self.preempt_policy}")
        for impl in (self.attn_impl, self.bnn_impl):
            if impl not in kops.IMPLS:
                raise ValueError(f"unknown impl {impl!r} (want one of "
                                 f"{kops.IMPLS})")
        if self.attn_impl != self.bnn_impl:
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r} with bnn_impl="
                f"{self.bnn_impl!r}: the port dispatches every kernel "
                "through one impl, so the two must be equal")
        R.get_role(self.role)


def _resolve_device(device) -> torch.device:
    """``None`` means the card; without one the engine refuses to run
    rather than carry on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Engine: no CUDA device — pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


class Engine:
    def __init__(self, params, cfg, ecfg: EngineConfig = EngineConfig(),
                 device=None):
        self.device = _resolve_device(device)
        M.check_supported(cfg)
        w = params["embed"]["w"]
        if w.device.type != self.device.type:
            raise ValueError(f"params live on {w.device}, engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        # one tracer threaded through scheduler + caches: disabled by
        # default (near-zero cost), start_trace() turns recording on.
        # Its span accumulators back the wall-time stats either way.
        self.tracer = Tracer()
        self.cache = MixerStateCache(
            cfg, num_blocks=ecfg.num_blocks, block_size=ecfg.block_size,
            max_model_len=ecfg.max_model_len,
            prefix_cache=ecfg.prefix_cache,
            num_slots=ecfg.num_slots or ecfg.max_batch + 1,
            prefill_chunk=ecfg.prefill_chunk,
            snapshot_slots=ecfg.snapshot_slots or 2 * ecfg.max_batch,
            tracer=self.tracer, device=self.device)
        # ring rollback: a stale speculative write may only clobber
        # positions already outside the attention window, which the
        # prefill-sized ring guarantees when the verify chunk is no wider
        # than a prefill chunk (k + 1 <= prefill_chunk)
        self._spec_k = (min(ecfg.spec_k, ecfg.prefill_chunk - 1)
                        if ecfg.spec_k > 0 else 0)
        # worker role (serving/roles.py): gates which plan rows run and
        # whether completed prefills park for peer handoff; a prefill
        # worker never drafts, so its spec budget is zero
        self.role = R.get_role(ecfg.role)
        if not self.role.runs_decode:
            self._spec_k = 0
        # admission token budget: 0 = derive from the block pool (2x
        # its token capacity; a hybrid's too).  Slot-only stacks have
        # no block pool; max_batch and the slots bound their admission
        # instead.
        mtif = ecfg.max_tokens_in_flight
        if mtif == 0:
            a = self.cache.attn
            mtif = (2 * a.allocator.capacity * ecfg.block_size
                    if a is not None else 1 << 30)
        self.scheduler = Scheduler(
            SchedulerConfig(max_batch=ecfg.max_batch,
                            max_tokens_in_flight=mtif,
                            max_batched_tokens=ecfg.max_batched_tokens,
                            prefill_chunk=ecfg.prefill_chunk,
                            policy=ecfg.policy,
                            preempt_policy=ecfg.preempt_policy,
                            decode_cost=1 + self._spec_k,
                            tenants=ecfg.tenants),
            self.cache, tracer=self.tracer, role=self.role)
        # the fused CUDA kernel never spills packed activations to
        # device memory; the plain version prices the extra pack pass
        # per GEMM
        self.cost_model = PhotonicCostModel(
            cfg, ecfg.accelerator,
            fused_bnn=kops.resolve_impl("auto", w) == "cuda",
            link_gbps=ecfg.link_gbps)
        self.requests: dict[int, Request] = {}
        self.step_count = 0
        self._next_rid = 0
        # set by the ShardedEngine when this engine is one of its shards;
        # a single engine's trace reads None and 1
        self.shard: int | None = None
        self.n_shards: int = 1
        # a prefill worker's completed prompts, parked for the
        # ShardedEngine to hand off to a decode peer
        self.handoff_ready: list[int] = []
        self._step_rec: dict | None = None   # per-step trace assembly
        self._decoded = 0
        self._prefilled = 0
        self._prefill_calls = 0
        self._max_concurrent = 0
        self._decode_calls = 0
        self._decode_rows = 0            # scheduled rows across decode calls
        self._decode_produced = 0        # tokens committed by decode calls
        # speculative counters
        self._spec_steps = 0
        self._spec_rows = 0              # per-row verify passes
        self._verify_tokens = 0          # fed tokens across verify calls
        self._spec_committed = 0         # tokens committed by verify steps
        self._draft_tokens = 0
        self._draft_accepted = 0
        self._spec_repairs = 0
        # scoring workload counters (teacher-forced prefill-only)
        self._score_tokens = 0           # scored prompt positions
        self._score_passes = 0           # chunked scoring prefill calls
        self._score_requests = 0         # finished scoring requests
        self._cancelled = 0
        # incremental token-commit callback (streaming):
        # cb(rid, new_tokens, done) at every commit point.  None = no
        # streaming overhead.
        self.on_commit = None
        # sliding-window configs run their block tables as rings
        fns = R.build_step_fns(cfg, ring=self.cache.ring_blocks > 0,
                               impl=ecfg.bnn_impl, spec_k=self._spec_k,
                               role=self.role)
        self._prefill_fn = fns.prefill
        self._decode_fn = fns.decode
        self._spec_fn = fns.spec
        self._repair_fn = fns.repair
        self._has_slots = self.cache.ssm is not None

    # ---------------------------------------------------------------- API

    def start_trace(self, path: str | None = None, *, ring: int = 4096,
                    capture_logits: bool = False) -> Tracer:
        """Turn structured tracing on: every step/request/span event
        goes to a bounded in-memory ring and (when ``path`` is given)
        streams to JSONL.  The leading meta record makes the trace
        self-describing — the replay driver and the Perfetto exporter
        need nothing else (see serving/tracing.py)."""
        self.tracer.open(path, ring=ring, capture_logits=capture_logits)
        self.tracer.meta(
            arch=self.cfg.name, accelerator=self.ecfg.accelerator,
            config=asdict(self.cfg), engine=asdict(self.ecfg),
            spec_k=self._spec_k, shard=self.shard,
            n_shards=self.n_shards, role=self.ecfg.role,
            link_gbps=self.ecfg.link_gbps, t0=self.tracer.t0)
        return self.tracer

    def stop_trace(self):
        """Flush + close the trace stream (the ring stays readable)."""
        self.tracer.close()

    def submit(self, prompt, max_new: int, *, priority: int = 0,
               arrival_s: float = 0.0,
               sampling: SamplingParams | None = None,
               rid: int | None = None, tenant: str = "default",
               slo_class: str = "", score: bool = False) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if score:
            # scoring = chunked teacher-forced prefill only: no decode
            # loop, so there is no generation budget to reserve
            max_new = 0
            if prompt.size < 2:
                raise ValueError(
                    "scoring needs >= 2 prompt tokens (each scored "
                    "position conditions on at least one token)")
        if prompt.size + max_new > self.ecfg.max_model_len:
            raise ValueError(
                f"request needs {prompt.size + max_new} tokens > "
                f"max_model_len={self.ecfg.max_model_len}")
        if not self.cache.fits(prompt.size + max_new):
            raise ValueError(
                f"request needs {prompt.size + max_new} tokens of KV > "
                f"the whole block pool; raise num_blocks")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid, prompt, max_new, priority=priority,
                      arrival_s=arrival_s,
                      sampling=sampling or SamplingParams(),
                      tenant=tenant, slo_class=slo_class, score=score)
        req.submit_s = time.perf_counter()
        self.requests[rid] = req
        self.scheduler.submit(req, self.step_count)
        return rid

    def set_commit_callback(self, cb):
        """Install ``cb(rid, new_tokens, done)``, fired at every token
        commit: the prefill's first token and each decode token.
        ``new_tokens`` only ever contains tokens past the request's
        delivery watermark — recompute preemption regenerates an
        identical prefix, which is NOT re-delivered, so the concatenated
        stream equals ``run()`` output."""
        self.on_commit = cb

    def _commit(self, req: Request, done: bool):
        if self.on_commit is None:
            return
        new = req.out[req.streamed:]
        if new or done:
            req.streamed = len(req.out)
            self.on_commit(req.rid, list(new), done)

    def cancel(self, rid: int) -> bool:
        """Drop a request.  Queued requests leave the queue; running
        ones release their blocks through the same path preemption
        uses; swapped ones drop their host copies (``swap_out`` already
        freed the device blocks).  The request ends in the terminal
        CANCELLED state.  Returns False when rid is unknown or already
        terminal."""
        req = self.requests.get(rid)
        if req is None or req.state in (State.FINISHED, State.CANCELLED):
            return False
        sched = self.scheduler
        if req in sched.running:
            sched.running.remove(req)
            self.cache.release(req)
        elif req in sched.queue:
            sched.queue.remove(req)
            req.host_kv = None
            req.host_state = None
        if rid in self.handoff_ready:
            self.handoff_ready.remove(rid)
        req.state = State.CANCELLED
        req.finish_step = self.step_count
        req.finish_s = time.perf_counter()
        self._cancelled += 1
        sched._ev(self.step_count, "cancelled", rid, generated=len(req.out))
        self._commit(req, True)
        return True

    def _counter_marks(self) -> tuple:
        """Cheap cache/scheduler counter snapshot — the step record
        reports per-step deltas (prefix/snapshot hits, preempt/swap
        actions).  Built only while tracing is enabled."""
        c, s = self.cache, self.scheduler
        a, m = c.attn, c.ssm
        return (a.prefix_hits if a is not None else 0,
                m.snap_hits if m is not None else 0,
                s.preempts, s.swap_losts, c.swap_outs, c.swap_ins)

    def step(self) -> bool:
        """One engine iteration; False when nothing was schedulable.
        Its wall time goes into the ``step`` span total, and (tracing
        on) the very same float into the step record's ``dur_s``, so
        ``stats()["wall_s"]`` equals the sum of the step records."""
        t0 = time.perf_counter()
        step = self.step_count
        tr = self.tracer
        if tr.enabled:
            self._step_rec = {}
            marks = self._counter_marks()
        plan = self.scheduler.schedule(step)
        if plan.prefill is not None:
            self._run_prefill(step, plan.prefill, plan.prefill_tokens)
        # prefill-side preemption may have requeued planned rows
        decode = [r for r in plan.decode if r.state == State.DECODE
                  and r in self.scheduler.running]
        if decode:
            if self._spec_k:
                self._run_decode_spec(step, decode)
            else:
                self._run_decode(step, decode)
        self.step_count += 1
        dt = time.perf_counter() - t0
        tr.add_time("step", dt)
        if tr.enabled:
            rec = self._step_rec
            self._step_rec = None
            delta = [b - a for a, b in zip(marks, self._counter_marks())]
            actions = {k: d for k, d in zip(STEP_ACTIONS, delta) if d}
            ev = {"type": "step", "step": step, "dur_s": dt,
                  "kind": "+".join(
                      k for k in ("prefill", "decode", "spec_verify")
                      if k in rec) or "idle",
                  "role": self.ecfg.role}
            if self.shard is not None:
                ev["shard"] = self.shard
            ev.update(rec)
            if actions:
                ev["actions"] = actions
            tr.emit(ev)
        return plan.has_work

    def run(self) -> dict[int, np.ndarray]:
        """Drive until every submitted request finished; returns
        rid -> full token sequence (prompt + generated)."""
        while not self.scheduler.idle:
            if not self.step():
                stalls = self.scheduler.stall_reasons()
                detail = "; ".join(
                    f"rid={rid}[{state}]: {why}"
                    for rid, (state, why) in sorted(stalls.items()))
                raise RuntimeError(
                    "engine stalled with unschedulable requests — last "
                    f"defer reason per request: {detail}")
        return {rid: r.full_sequence() for rid, r in self.requests.items()
                if r.state == State.FINISHED}

    # ------------------------------------------- replay-curve feedback

    def apply_replay_curve(self, curve: dict) -> int:
        """Cap the speculative verify chunk at the modeled DWDM
        pipeline-fill break-even of a replayed ``decode_batch_curve``
        (serving/replay.py).  Beyond the break-even width, each extra
        verified token costs more than a sequential decode step on the
        modeled hardware, so drafting past it cannot win.  Lowers
        ``spec_k`` (never raises it — the ring-rollback bound still
        applies) and the scheduler's per-row decode budget charge.
        Returns the spec_k now in effect."""
        from repro_torch.serving.replay import spec_chunk_cap
        cap = spec_chunk_cap(curve)
        if cap is not None and self._spec_k and cap - 1 < self._spec_k:
            self._spec_k = max(cap - 1, 0)
            self.scheduler.decode_cost = 1 + self._spec_k
        return self._spec_k

    # ------------------------------------------------------ shard migration

    def export_request(self, rid: int, peer: "Engine | None" = None):
        """Detach a live request for migration to a peer shard.  A
        running request with computed state is serialized through the
        content-hash swap path — against the PEER's indexes when one is
        given, so blocks and snapshots the destination already holds
        never cross — into host (CPU) tensors.  Queued and swapped
        requests move as they are (their host copies are portable;
        re-adoption resolves against the destination at admission, and
        falls back to recompute as ``swap_lost`` if its chains are
        gone).  Returns the Request, no longer tracked here."""
        req = self.requests.pop(rid)
        step = self.step_count
        if rid in self.handoff_ready:
            self.handoff_ready.remove(rid)
        if req in self.scheduler.running:
            self.scheduler.running.remove(req)
            if req.pos > 0:
                self.cache.swap_out(req, peer=peer.cache if peer else None)
                req.park_swapped()
            else:
                self.cache.release(req)
                req.reset_for_requeue()
        elif req in self.scheduler.queue:
            self.scheduler.queue.remove(req)
        self.scheduler._ev(step, "migrate_out", req.rid, pos=req.pos,
                           state=req.state.value)
        return req

    def adopt_request(self, req: Request, *, lost: bool = False):
        """Take over a migrated request (``export_request``'s
        counterpart); its host copies go to this engine's device at
        swap-in.  ``lost=True``: rescued from a dead shard with its
        device state gone — reset for recompute from scratch, the loss
        shown as ``swap_lost`` (``Scheduler.adopt``)."""
        if lost:
            req.reset_for_requeue()
            req.transfer_steps = 0
            req.transfer_until_step = None
        if req.transfer_steps:
            # the modelled link still streams this request's state: the
            # scheduler defers it (transfer_pending) until the arrival
            # deadline, overlapping the transfer with this shard's steps
            req.transfer_until_step = self.step_count + req.transfer_steps
        self.requests[req.rid] = req
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.scheduler.adopt(req, self.step_count, lost=lost)

    # ------------------------------------------------------------ internals

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_prefill(self, step: int, req: Request, chunk: int):
        if not self.scheduler.grow_or_preempt(step, req, req.pos + chunk):
            return                     # req itself was preempted
        # copy-on-write: never scatter into a block another owner shares
        # (the full-prefix-match case re-prefills its final token here)
        for idx in self.cache.writable_indices(req.pos, chunk):
            if not self.scheduler.make_writable(step, req, idx):
                return
        cp = self.ecfg.prefill_chunk   # fixed padded shape
        tokens = np.zeros((1, cp), np.int64)
        tokens[0, :chunk] = req.prompt[req.pos:req.pos + chunk]
        table = self.cache.table_rows([req], 1)
        slots = self.cache.slot_rows([req], 1)
        srows = sampling_rows([req], 1)
        tok, logits, _pools = self._prefill_fn(
            self.params, self.cache.pools, self._tensor(tokens),
            self._tensor(table), self._tensor(np.array([req.pos], np.int32)),
            self._tensor(np.array([chunk], np.int32)), self._tensor(slots),
            *srows.as_args(self.device))
        # the chunk's real logits rows, read back once, when scoring or
        # capturing needs them (row j predicts prompt position pos+j+1)
        rows = (logits[0, :chunk].float().cpu().numpy()
                if req.score or (self._step_rec is not None
                                 and self.tracer.capture_logits) else None)
        if req.score:
            self._accumulate_score(req, rows, chunk)
            self._score_passes += 1
        req.pos += chunk
        self._prefilled += chunk
        self._prefill_calls += 1
        self.cache.register_prefix(req)
        self.scheduler._ev(step, "prefill", req.rid, tokens=chunk,
                           pos=req.pos)
        if self._step_rec is not None:
            info = {"rid": req.rid, "tokens": chunk, "pos": req.pos,
                    "prompt_len": req.prompt_len}
            if req.score:
                info["score"] = True
            if self.tracer.capture_logits:
                info["logits"] = rows.tolist()
            self._step_rec["prefill"] = info
        if req.pos == req.prompt_len:
            if req.score:
                # scoring never decodes: the request finishes straight
                # out of its last prefill chunk, releasing its state
                req.first_token_step = step
                req.first_token_s = time.perf_counter()
                self._score_requests += 1
                self.scheduler.finish(step, req)
                req.finish_s = req.first_token_s
                self._commit(req, True)
                return
            req.out.append(int(tok[0]))
            req.state = State.DECODE
            req.first_token_step = step
            req.first_token_s = time.perf_counter()
            self._decoded += 1
            self.scheduler._ev(step, "first_token", req.rid)
            if req.done:
                self.scheduler.finish(step, req)
                req.finish_s = time.perf_counter()
            elif self.role.hands_off:
                # a prefill worker is done with the prompt (and its first
                # token): park it for export to a decode peer, which the
                # ShardedEngine does right after this step
                self.handoff_ready.append(req.rid)
                self.scheduler._ev(step, "handoff_ready", req.rid,
                                   pos=req.pos)
            self._commit(req, req.done)

    def _accumulate_score(self, req: Request, logits: np.ndarray,
                          chunk: int):
        """Append log p(prompt[pos+1+j] | prefix) for each scored row
        of the chunk (row j predicts position pos+j+1; the final row
        has no target inside the prompt), in float64 on the host."""
        n = min(chunk, req.prompt_len - req.pos - 1)
        if n <= 0:
            return
        rows = logits[:n].astype(np.float64)
        mx = rows.max(axis=-1)
        lse = mx + np.log(np.exp(rows - mx[:, None]).sum(axis=-1))
        tgt = np.asarray(req.prompt[req.pos + 1:req.pos + 1 + n], np.int64)
        lp = rows[np.arange(n), tgt] - lse
        req.logprobs.extend(float(x) for x in lp)
        self._score_tokens += n

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return b

    def _ready_rows(self, step: int, reqs: list[Request],
                    lookahead) -> list[Request]:
        """Grow + copy-on-write every decodable row for ``lookahead(r)``
        new cache positions, dropping rows that get preempted along the
        way."""
        sched = self.scheduler
        ready = []
        for r in reqs:
            if r not in sched.running or r.state != State.DECODE:
                continue
            n_new = lookahead(r)
            if sched.grow_or_preempt(step, r, r.pos + n_new) and all(
                    sched.make_writable(step, r, idx)
                    for idx in self.cache.writable_indices(r.pos, n_new)):
                ready.append(r)
        # a later grow may have preempted an earlier 'ready' row
        return [r for r in ready
                if r in self.scheduler.running and r.state == State.DECODE]

    def _run_decode(self, step: int, reqs: list[Request]):
        ready = self._ready_rows(step, reqs, lambda r: 1)
        if not ready:
            return
        bucket = min(self._bucket(len(ready)), self.ecfg.max_batch)
        tokens = np.zeros((bucket, 1), np.int64)
        lengths = np.zeros(bucket, np.int32)
        active = np.zeros(bucket, bool)
        for i, r in enumerate(ready):
            tokens[i, 0] = r.last_token
            lengths[i] = r.pos
            active[i] = True
        table = self.cache.table_rows(ready, bucket)
        slots = self.cache.slot_rows(ready, bucket)
        srows = sampling_rows(ready, bucket)
        next_tok, logits, _pools = self._decode_fn(
            self.params, self.cache.pools, self._tensor(tokens),
            self._tensor(table), self._tensor(lengths),
            self._tensor(active), self._tensor(slots),
            *srows.as_args(self.device))
        next_tok = next_tok.cpu().numpy()
        self._max_concurrent = max(self._max_concurrent, len(ready))
        self._decode_calls += 1
        self._decode_rows += len(ready)
        self._decode_produced += len(ready)
        self.scheduler._ev(step, "decode", None,
                           rids=[r.rid for r in ready], batch=bucket)
        if self._step_rec is not None:
            info = {"rows": len(ready), "bucket": bucket,
                    "rids": [r.rid for r in ready],
                    "fed_tokens": len(ready), "committed": len(ready)}
            if self.tracer.capture_logits:
                info["logits"] = (logits[:len(ready), -1].float().cpu()
                                  .numpy().tolist())
            self._step_rec["decode"] = info
        now = time.perf_counter()
        for i, r in enumerate(ready):
            if r.state is not State.DECODE:
                continue    # cancelled mid-loop by a commit callback
            r.pos += 1
            r.out.append(int(next_tok[i]))
            self._decoded += 1
            if r.done:
                self.scheduler.finish(step, r)
                r.finish_s = now
            self._commit(r, r.done)

    # ------------------------------------------------- speculative decode

    def _run_decode_spec(self, step: int, reqs: list[Request]):
        """One verify step: draft by prompt lookup, score the whole draft
        in one multi-token forward, commit the accepted prefix plus the
        verifier's own next token, roll back the rest."""
        drafts: dict[int, np.ndarray] = {}

        def lookahead(r: Request) -> int:
            budget = min(self._spec_k, r.max_new - len(r.out) - 1)
            d = (prompt_lookup_draft(r.full_sequence(), budget,
                                     self.ecfg.spec_ngram)
                 if budget > 0 else np.empty(0, np.int32))
            drafts[r.rid] = d
            return len(d) + 1

        ready = self._ready_rows(step, reqs, lookahead)
        if not ready:
            return
        if all(len(drafts[r.rid]) == 0 for r in ready):
            # nothing to verify: a chunk-wide forward would commit the
            # same one token per row at prefill-shaped cost, so take the
            # (B, 1) decode (capacity and copy-on-write above already
            # cover one token)
            self._run_decode(step, ready)
            return
        bucket = min(self._bucket(len(ready)), self.ecfg.max_batch)
        c = self._spec_k + 1
        tokens = np.zeros((bucket, c), np.int64)
        draft = np.zeros((bucket, c - 1), np.int64)
        n_valid = np.zeros(bucket, np.int32)
        lengths = np.zeros(bucket, np.int32)
        for i, r in enumerate(ready):
            d = drafts[r.rid]
            tokens[i, 0] = r.last_token
            tokens[i, 1:1 + len(d)] = d
            draft[i, :len(d)] = d
            n_valid[i] = len(d) + 1
            lengths[i] = r.pos
        t_tokens, t_table, t_lengths, t_slots = (
            self._tensor(tokens),
            self._tensor(self.cache.table_rows(ready, bucket)),
            self._tensor(lengths),
            self._tensor(self.cache.slot_rows(ready, bucket)))
        srows = sampling_rows(ready, bucket)
        sampled, n_commit, _pools, snaps = self._spec_fn(
            self.params, self.cache.pools, t_tokens, t_table, t_lengths,
            self._tensor(n_valid), t_slots, self._tensor(draft),
            *srows.as_args(self.device))
        sampled = sampled.cpu().numpy()
        n_commit_h = n_commit.cpu().numpy()
        n = len(ready)
        # recurrent slots folded the WHOLE draft into their state; a
        # partial acceptance needs the restore + re-advance
        if self._has_slots and bool(np.any(n_commit_h[:n] < n_valid[:n])):
            self._repair_fn(self.params, self.cache.pools, t_tokens,
                            t_table, t_lengths, n_commit, t_slots, snaps)
            self._spec_repairs += 1
        self._max_concurrent = max(self._max_concurrent, n)
        self._decode_calls += 1
        self._decode_rows += n
        self._spec_steps += 1
        self._spec_rows += n
        now = time.perf_counter()
        committed_total = 0
        for i, r in enumerate(ready):
            if r.state is not State.DECODE:
                continue    # cancelled mid-loop by a commit callback
            m = int(n_commit_h[i])
            self._verify_tokens += int(n_valid[i])
            self._draft_tokens += int(n_valid[i]) - 1
            committed = 0
            for jj in range(m):
                r.pos += 1
                r.out.append(int(sampled[i, jj]))
                self._decoded += 1
                committed += 1
                if r.done:      # stop / max_new mid-draft: finish here
                    break
            # credit only draft tokens that committed: a stop landing
            # mid-draft truncates the accepted prefix
            self._draft_accepted += min(committed, m - 1)
            committed_total += committed
            if r.done:
                self.scheduler.finish(step, r)
                r.finish_s = now
            # the whole accepted burst is ONE commit
            self._commit(r, r.done)
        self._spec_committed += committed_total
        self._decode_produced += committed_total
        self.scheduler._ev(step, "spec_decode", None,
                           rids=[r.rid for r in ready], batch=bucket,
                           drafted=int(n_valid[:n].sum()) - n,
                           committed=committed_total)
        if self._step_rec is not None:
            self._step_rec["spec_verify"] = {
                "rows": n, "bucket": bucket,
                "rids": [r.rid for r in ready],
                "fed": n_valid[:n].tolist(),
                "fed_tokens": int(n_valid[:n].sum()),
                "drafted": int(n_valid[:n].sum()) - n,
                "accepted": int(np.minimum(
                    n_commit_h[:n] - 1, n_valid[:n] - 1).clip(0).sum()),
                "committed": committed_total}

    # -------------------------------------------------------------- stats

    def reset_stats(self, *, flush_prefix: bool = False):
        """Zero the token/wall/cache counters without touching request
        or scheduler state (a measured window after a warm-up);
        ``flush_prefix`` also drops every idle cached block."""
        self.tracer.reset_spans("step")
        self._decoded = self._prefilled = self._prefill_calls = 0
        self._max_concurrent = self._decode_calls = self._cancelled = 0
        self._decode_rows = self._decode_produced = 0
        self._spec_steps = self._spec_rows = 0
        self._verify_tokens = self._spec_committed = 0
        self._draft_tokens = self._draft_accepted = 0
        self._spec_repairs = 0
        self._score_tokens = self._score_passes = 0
        self._score_requests = 0
        self.cache.reset_stats(flush_prefix=flush_prefix)

    def stats(self) -> dict:
        finished = [r for r in self.requests.values()
                    if r.state == State.FINISHED]
        lat = sorted(r.finish_s - r.submit_s for r in finished
                     if r.finish_s is not None and r.submit_s is not None)
        prefix = self.cache.prefix_section()
        # the span accumulator (serving/tracing.py) is the single
        # source of wall-time truth
        wall_s = self.tracer.span_total("step")
        return {
            "steps": self.step_count,
            "role": self.ecfg.role,
            "device": str(self.device),
            "finished": len(finished),
            "decoded_tokens": self._decoded,
            "prefill_tokens": self._prefilled,
            "prefill_calls": self._prefill_calls,
            "decode_calls": self._decode_calls,
            "wall_s": wall_s,
            "decode_tokens_per_s": (self._decoded / wall_s
                                    if wall_s else float("nan")),
            "total_tokens_per_s": (
                (self._decoded + self._prefilled) / wall_s
                if wall_s else float("nan")),
            "p50_latency_s": nearest_rank(lat, 50),
            "p99_latency_s": nearest_rank(lat, 99),
            "max_concurrent_decode": self._max_concurrent,
            "preemptions": sum(r.preemptions
                               for r in self.requests.values()),
            "cancelled": self._cancelled,
            "scoring": {
                "requests": self._score_requests,
                "scored_tokens": self._score_tokens,
                "score_passes": self._score_passes,
            },
            "tenants": self.scheduler.tenant_report(),
            "speculative": self._spec_section(),
            "prefix_cache": prefix,
            "swap": self.cache.swap_section(),
            "mixer": self.cache.mixer_section(),
            "photonic": self._photonic_section(
                prefix["skipped_prefill_tokens"]),
        }

    def _spec_section(self) -> dict:
        drafted = self._draft_tokens
        return {
            "enabled": self._spec_k > 0,
            "spec_k": self._spec_k,
            "spec_steps": self._spec_steps,
            "draft_tokens": drafted,
            "accepted_tokens": self._draft_accepted,
            "acceptance_rate": (self._draft_accepted / drafted
                                if drafted else 0.0),
            # committed tokens per scheduled decode ROW-step: 1.0 for
            # plain decoding, > 1 when verify steps commit drafts
            "tokens_per_decode_step": (
                self._decode_produced / self._decode_rows
                if self._decode_rows else 0.0),
            "repairs": self._spec_repairs,
        }

    def _photonic_section(self, skipped_tokens: int) -> dict:
        """The modeled accelerator's report on the served stream, built
        as the JAX engine builds it."""
        cm = self.cost_model
        return {
            **cm.report(),
            **cm.serving_report(
                prefill_tokens=self._prefilled,
                decode_tokens=self._decoded,
                skipped_tokens=skipped_tokens,
                prefill_passes=self._prefill_calls,
                prefill_chunk=self.ecfg.prefill_chunk),
            **cm.speculative_report(verify_passes=self._spec_rows,
                                    verify_tokens=self._verify_tokens,
                                    committed_tokens=self._spec_committed),
            **cm.scoring_report(score_tokens=self._score_tokens,
                                score_passes=self._score_passes),
        }
