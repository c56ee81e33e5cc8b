"""Asyncio streaming front-end over the continuous-batching engine.

One ``Frontend`` wraps an ``Engine`` or ``ShardedEngine`` and runs its
step loop as a background asyncio task.  Callers submit requests
MID-FLIGHT (the next step admits them — continuous batching is the
engine's native mode), consume committed tokens as an async stream,
cancel in-flight requests, and run teacher-forced scoring — all
interleaved on one event loop:

  * ``submit`` / ``stream`` — tokens arrive exactly as the engine
    commits them: the prefill's first token, one per plain decode step,
    and speculative commits as whole accepted BURSTS (the engine's
    commit callback is the single source of truth — no one-at-a-time
    re-chunking, and the concatenated stream is byte-identical to the
    batch ``run()`` output by the delivery-watermark contract);
  * ``cancel`` — queued requests are dropped, running ones release
    their blocks/slots; the stream terminates immediately;
  * ``score`` — the second workload class: chunked teacher-forced
    prefill over the paged cache (no decode loop), returning per-token
    logprobs and perplexity.  Submitted as throughput-class work so it
    backfills capacity the latency class is not using.

The driver is cooperative, not threaded: ``engine.step()`` runs on the
event loop and yields between steps, so submissions and consumers
interleave at step granularity — the asyncio analogue of the engine's
step-level continuous batching.  The loop adds no device
synchronisation of its own (the engine's token readback is the only
one) and catches nothing: a failed step ends the driver task, and
``close()`` raises it.
"""
from __future__ import annotations

import asyncio

import numpy as np

from repro_torch.serving.policy import THROUGHPUT
from repro_torch.serving.sampling import SamplingParams


class Frontend:
    """Async server loop: submit/stream/cancel/score over one engine.

    Use as an async context manager — ``async with Frontend(eng) as fe``
    starts the driver task and tears it down on exit.
    """

    def __init__(self, engine):
        self.engine = engine
        self._streams: dict[int, asyncio.Queue] = {}
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False
        engine.set_commit_callback(self._on_commit)

    # ------------------------------------------------------------ driver

    def _idle(self) -> bool:
        # an Engine answers through its scheduler, a ShardedEngine itself
        sched = getattr(self.engine, "scheduler", None)
        return sched.idle if sched is not None else self.engine.idle

    def _stall_detail(self) -> str:
        sched = getattr(self.engine, "scheduler", None)
        stalls = (sched.stall_reasons() if sched is not None
                  else self.engine.stall_reasons())
        return "; ".join(f"rid={rid}[{state}]: {why}"
                         for rid, (state, why) in sorted(stalls.items()))

    async def _drive(self):
        while not self._closed:
            if self._idle():
                self._wake.clear()
                await self._wake.wait()
                continue
            worked = self.engine.step()
            if not worked and not self._idle():
                raise RuntimeError(
                    "front-end driver stalled with unschedulable "
                    f"requests: {self._stall_detail()}")
            # yield between steps: submissions, cancels, and stream
            # consumers run here — step-granular continuous batching
            await asyncio.sleep(0)

    async def __aenter__(self):
        self._task = asyncio.ensure_future(self._drive())
        return self

    async def __aexit__(self, *exc):
        await self.close()

    async def close(self):
        self._closed = True
        self._wake.set()
        if self._task is not None:
            try:
                await self._task
            finally:
                self._task = None

    # --------------------------------------------------------------- API

    def _on_commit(self, rid: int, tokens: list[int], done: bool):
        q = self._streams.get(rid)
        if q is not None:
            q.put_nowait((tokens, done))

    def submit(self, prompt, max_new: int, *,
               sampling: SamplingParams | None = None, priority: int = 0,
               tenant: str = "default", slo_class: str = "",
               score: bool = False) -> int:
        """Register a stream and hand the request to the engine; the
        driver picks it up on its next step.  Synchronous (no await):
        commits only happen inside ``step()``, which only runs when the
        event loop regains control, so the stream queue is always
        registered before the first commit can fire."""
        rid = self.engine.submit(prompt, max_new, sampling=sampling,
                                 priority=priority, tenant=tenant,
                                 slo_class=slo_class, score=score)
        self._streams[rid] = asyncio.Queue()
        self._wake.set()
        return rid

    def cancel(self, rid: int) -> bool:
        """Drop a request; its stream terminates (possibly mid-burst —
        already-delivered tokens stand, nothing further arrives)."""
        ok = self.engine.cancel(rid)
        self._wake.set()
        return ok

    async def stream(self, rid: int):
        """Async-iterate committed token batches for ``rid`` until the
        request finishes or is cancelled.  Each item is the list a
        single commit delivered (speculative bursts arrive whole)."""
        q = self._streams[rid]
        try:
            while True:
                tokens, done = await q.get()
                if tokens:
                    yield tokens
                if done:
                    return
        finally:
            self._streams.pop(rid, None)

    async def generate(self, prompt, max_new: int, **kw) -> np.ndarray:
        """Submit + collect the whole stream; returns the full sequence
        (prompt + generated) — byte-identical to ``Engine.run()``'s
        entry for the same request."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self.submit(prompt, max_new, **kw)
        out: list[int] = []
        async for tokens in self.stream(rid):
            out.extend(tokens)
        return np.concatenate([prompt, np.asarray(out, np.int32)])

    async def score(self, prompt, *, tenant: str = "default",
                    slo_class: str = THROUGHPUT) -> dict:
        """Teacher-forced logprob scoring: chunked prefill over the
        paged cache, no decode loop.  Defaults to throughput class so
        scoring backfills around latency traffic.  Returns per-position
        logprobs (position i+1 conditioned on tokens <= i) and ppl."""
        rid = self.submit(np.asarray(prompt, np.int32).reshape(-1), 0,
                          tenant=tenant, slo_class=slo_class, score=True)
        async for _ in self.stream(rid):
            pass                       # scoring streams no tokens
        req = self.engine.requests[rid]
        return {"rid": rid, "logprobs": list(req.logprobs),
                "scored_tokens": len(req.logprobs),
                "ppl": req.score_ppl()}
