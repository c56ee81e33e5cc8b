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
copied before it is written), and a preempted request's blocks are
swapped to host memory and restored when it is re-admitted.  Stacks
with recurrent slots run without both until the slot snapshots are
ported (ROADMAP.md queue 1, item 7).

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
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as M
from repro_torch.serving import roles as R
from repro_torch.serving.block_cache import SLOT_SNAPSHOTS, MixerStateCache
from repro_torch.serving.cost_model import PhotonicCostModel
from repro_torch.serving.request import Request, State
from repro_torch.serving.sampling import SamplingParams, sampling_rows
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.tracing import Tracer


def nearest_rank(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an ascending sample: the smallest
    value with at least p% of the sample at or below it — 0-indexed
    ``ceil(p/100 * n) - 1``."""
    if not len(sorted_vals):
        return float("nan")
    n = len(sorted_vals)
    idx = max(math.ceil(p / 100 * n) - 1, 0)
    return sorted_vals[min(idx, n - 1)]


# options of the JAX package's EngineConfig that the port keeps at a
# fixed value: field -> (the value it supports, ROADMAP.md item that
# brings the rest)
_SLICE_ONLY = {
    "policy": ("fcfs", "queue 1, item 7"),
    "spec_k": (0, "queue 1, item 7"),
    "role": ("mixed", "queue 1, item 7"),
}


@dataclass(frozen=True)
class EngineConfig:
    block_size: int = 16
    num_blocks: int = 129            # 1 scratch + 128 allocatable
    max_batch: int = 8               # decode slots (padded to 2^k buckets)
    prefill_chunk: int = 16
    max_model_len: int = 256         # prompt + generation bound per request
    num_slots: int = 0               # recurrent slots (SSM layers), slot 0
                                     # scratch; 0 = max_batch + 1
    policy: str = "fcfs"             # only fcfs is ported
    max_tokens_in_flight: int = 0    # KV-footprint admission budget;
                                     # 0 = auto (2x the block pool's
                                     # token capacity; unbounded without
                                     # a block pool)
    max_batched_tokens: int = 256
    accelerator: str = "OXBNN_50"    # photonic cost-model target
    prefix_cache: bool = True        # content-addressed prompt block reuse
    preempt_policy: str = "swap"     # swap | recompute (fallback)
    snapshot_slots: int = 0          # recurrent prefix-snapshot pool rows
                                     # (the slot snapshots are not ported)
    spec_k: int = 0                  # speculative decoding: not ported
    attn_impl: str = "auto"          # paged attention: auto | cuda | torch
    bnn_impl: str = "auto"           # packed BNN GEMM: auto | cuda | torch
                                     # (one dispatch in the port: the two
                                     # must be equal)
    role: str = "mixed"              # disaggregated roles: not ported
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
        for name, (value, item) in _SLICE_ONLY.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (ROADMAP.md {item}); the port runs "
                    f"{name}={value!r}")


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
        if "ssm" in (mix for mix, _f in M.layer_plan(cfg)) and (
                ecfg.prefix_cache or ecfg.preempt_policy == "swap"):
            raise NotImplementedError(
                f"{cfg.name}: prefix_cache=True and preempt_policy='swap' "
                f"need the slot snapshots of its recurrent layers, not "
                f"ported yet ({SLOT_SNAPSHOTS}); pass prefix_cache=False, "
                f"preempt_policy='recompute'")
        w = params["embed"]["w"]
        if w.device.type != self.device.type:
            raise ValueError(f"params live on {w.device}, engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        # span accumulators: the wall-time source of stats()
        self.tracer = Tracer()
        self.cache = MixerStateCache(
            cfg, num_blocks=ecfg.num_blocks, block_size=ecfg.block_size,
            max_model_len=ecfg.max_model_len,
            prefix_cache=ecfg.prefix_cache,
            num_slots=ecfg.num_slots or ecfg.max_batch + 1,
            prefill_chunk=ecfg.prefill_chunk, tracer=self.tracer,
            device=self.device)
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
                            preempt_policy=ecfg.preempt_policy),
            self.cache)
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
        self._decoded = 0
        self._prefilled = 0
        self._prefill_calls = 0
        self._max_concurrent = 0
        self._decode_calls = 0
        self._cancelled = 0
        # incremental token-commit callback (streaming):
        # cb(rid, new_tokens, done) at every commit point.  None = no
        # streaming overhead.
        self.on_commit = None
        # sliding-window configs run their block tables as rings
        fns = R.build_step_fns(cfg, ring=self.cache.ring_blocks > 0,
                               impl=ecfg.bnn_impl)
        self._prefill_fn = fns.prefill
        self._decode_fn = fns.decode

    # ---------------------------------------------------------------- API

    def submit(self, prompt, max_new: int, *, priority: int = 0,
               sampling: SamplingParams | None = None,
               rid: int | None = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
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
                      sampling=sampling or SamplingParams())
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
        req.state = State.CANCELLED
        req.finish_step = self.step_count
        req.finish_s = time.perf_counter()
        self._cancelled += 1
        sched._ev(self.step_count, "cancelled", rid, generated=len(req.out))
        self._commit(req, True)
        return True

    def step(self) -> bool:
        """One engine iteration; False when nothing was schedulable."""
        with self.tracer.span("step"):
            step = self.step_count
            plan = self.scheduler.schedule(step)
            if plan.prefill is not None:
                self._run_prefill(step, plan.prefill, plan.prefill_tokens)
            # prefill-side preemption may have requeued planned rows
            decode = [r for r in plan.decode if r.state == State.DECODE
                      and r in self.scheduler.running]
            if decode:
                self._run_decode(step, decode)
            self.step_count += 1
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
        tok, _logits, _pools = self._prefill_fn(
            self.params, self.cache.pools, self._tensor(tokens),
            self._tensor(table), self._tensor(np.array([req.pos], np.int32)),
            self._tensor(np.array([chunk], np.int32)), self._tensor(slots),
            *srows.as_args(self.device))
        req.pos += chunk
        self._prefilled += chunk
        self._prefill_calls += 1
        self.cache.register_prefix(req)
        self.scheduler._ev(step, "prefill", req.rid, tokens=chunk,
                           pos=req.pos)
        if req.pos == req.prompt_len:
            req.out.append(int(tok[0]))
            req.state = State.DECODE
            req.first_token_step = step
            req.first_token_s = time.perf_counter()
            self._decoded += 1
            self.scheduler._ev(step, "first_token", req.rid)
            if req.done:
                self.scheduler.finish(step, req)
                req.finish_s = time.perf_counter()
            self._commit(req, req.done)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return b

    def _ready_rows(self, step: int, reqs: list[Request]) -> list[Request]:
        """Grow + copy-on-write every decodable row for one cache
        position, dropping rows that get preempted along the way."""
        sched = self.scheduler
        ready = [r for r in reqs
                 if r in sched.running and r.state == State.DECODE
                 and sched.grow_or_preempt(step, r, r.pos + 1)
                 and all(sched.make_writable(step, r, idx)
                         for idx in self.cache.writable_indices(r.pos, 1))]
        # a later grow may have preempted an earlier 'ready' row
        return [r for r in ready
                if r in self.scheduler.running and r.state == State.DECODE]

    def _run_decode(self, step: int, reqs: list[Request]):
        ready = self._ready_rows(step, reqs)
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
        next_tok, _logits, _pools = self._decode_fn(
            self.params, self.cache.pools, self._tensor(tokens),
            self._tensor(table), self._tensor(lengths),
            self._tensor(active), self._tensor(slots),
            *srows.as_args(self.device))
        next_tok = next_tok.cpu().numpy()
        self._max_concurrent = max(self._max_concurrent, len(ready))
        self._decode_calls += 1
        self.scheduler._ev(step, "decode", None,
                           rids=[r.rid for r in ready], batch=bucket)
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

    # -------------------------------------------------------------- stats

    def reset_stats(self, *, flush_prefix: bool = False):
        """Zero the token/wall/cache counters without touching request
        or scheduler state (a measured window after a warm-up);
        ``flush_prefix`` also drops every idle cached block."""
        self.tracer.reset_spans("step")
        self._decoded = self._prefilled = self._prefill_calls = 0
        self._max_concurrent = self._decode_calls = self._cancelled = 0
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
            "prefix_cache": prefix,
            "swap": self.cache.swap_section(),
            "mixer": self.cache.mixer_section(),
            "photonic": self._photonic_section(
                prefix["skipped_prefill_tokens"]),
        }

    def _photonic_section(self, skipped_tokens: int) -> dict:
        """The modeled accelerator's report on the served stream, built
        as the JAX engine builds it.  Speculative verify passes and
        scoring are not ported, so their counts are 0 (ROADMAP.md queue
        1, item 7)."""
        cm = self.cost_model
        return {
            **cm.report(),
            **cm.serving_report(
                prefill_tokens=self._prefilled,
                decode_tokens=self._decoded,
                skipped_tokens=skipped_tokens,
                prefill_passes=self._prefill_calls,
                prefill_chunk=self.ecfg.prefill_chunk),
            **cm.speculative_report(verify_passes=0, verify_tokens=0,
                                    committed_tokens=0),
            **cm.scoring_report(score_tokens=0, score_passes=0),
        }
