"""Serving launcher: the port's counterpart of the JAX package's
``repro.launch.serve``, a thin CLI over the continuous-batching engine.

With ``--precision bnn`` every projection runs the packed XNOR-popcount
GEMM (1-bit weights and activations), the paper's inference mode.
Requests flow through ``repro_torch.serving.Engine`` with the JAX
engine's defaults: the prefix cache (prompt blocks shared by content
hash, copied before a shared block is written; recurrent slots restore
snapshots of shared heads, ``--snapshot-slots`` of them) and
swap-to-host preemption; ``--spec-k`` turns on speculative decoding
with prompt-lookup drafts (``--spec-ngram``);
``--temperature/--top-k/--top-p/--sampling-seed`` sample
on the card with JAX's (seed, position) keys, ``--stop-token`` ends a
request at its first occurrence.  ``--engine legacy`` runs the
token-by-token loop over a dense per-batch cache instead, the engine's
differential oracle: its greedy tokens equal the engine's.

``--policy`` picks the scheduler policy (fcfs, priority, slo);
``--tenants "name=class:budget,..."`` turns on the multi-tenant slo
policy (latency vs throughput classes, per-tenant token budgets —
serving/policy.py); with ``--stream`` it assigns requests round-robin
to the tenants.  ``--trace PATH``
records the engine's JSONL trace (view it with ``python -m
repro_torch.launch.trace_view PATH``), ``--replay-photonic`` re-prices
its steps on the photonic simulator.  Streaming front-end
(``--stream``): the same engine behind an asyncio server loop
(serving/frontend.py) — committed tokens stream per request,
``--cancel-after`` drops the last request mid-decode, and ``--score``
runs teacher-forced logprob/ppl scoring requests alongside generation.
``--shards N`` serves through a ``ShardedEngine`` (serving/sharded.py):
N engine shards over the devices (tiled when there are fewer: shards on
one card share its memory and step in turn), output equal to one
engine's; ``--roles P:D`` splits them into prefill and decode workers
(finished prompts handed off over swap-to-peer), and ``--trace PATH``
then writes ``PATH.shard{i}.jsonl`` per shard.

It runs on the card; ``--device cpu`` is the only way to run it on the
CPU (the plain PyTorch versions of the kernels).  Launched as one rank
of a process group of 256 processes (512 with ``--multi-pod``), a
non-smoke serve runs over the production mesh, as the JAX CLI does:
(16, 16) ("data", "model"), or (2, 16, 16) with "pod", the params
placed by the decode rules and every rank running the same engine
(``serving_mesh``; every family: dense, mixtral's MoE over a
sliding-window ring, deepseek's MLA and MoE, mamba2's SSD over recurrent
slots and the jamba hybrid).  In a single process it serves
on one device, and ``--multi-pod`` raises there, as the JAX CLI's
512-device mesh does.  ``setup``/``serve`` take a ``mesh=`` of any
("data", "model") shape, which tests and chip_smoke.py pass.

Setup and run are split (``setup``, ``make_prompts``, ``run``,
``run_stream``, ``run_legacy``): ``serve``/``serve_legacy`` take
``params`` and ``prompts`` as well, so the same weights and prompts can
be served by both packages.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bnn-lm-100m \\
      --precision bnn
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.dist import sharding as SH, spmd
from repro_torch.launch import mesh as MESH
from repro_torch.layers import common as C
from repro_torch.models import transformer as M
from repro_torch.serving import (Engine, EngineConfig, Frontend,
                                 SamplingParams, ShardedEngine,
                                 format_report, parse_tenants, replay_trace,
                                 tenants_arg)
from repro_torch.serving.engine import _resolve_device
from repro_torch.serving.sampling import categorical

def _config(arch: str, smoke: bool, precision: str | None):
    cfg = configs.get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    return cfg.replace(precision=precision) if precision else cfg


def serving_mesh(*, smoke: bool = False, multi_pod: bool = False,
                 device=None, mesh=None):
    """The mesh a serve runs over: ``mesh`` when given; a non-smoke
    serve under a process group, or one asked for ``multi_pod``, the
    production mesh (``make_production_mesh``: it raises unless the
    group has 256 ranks, 512 with ``multi_pod``), as the JAX CLI's
    ``_setup`` builds; else None (one device)."""
    return MESH.launch_mesh(smoke=smoke, multi_pod=multi_pod,
                            device=_resolve_device(device), mesh=mesh)


def setup(arch: str, *, smoke: bool = False, precision: str | None = None,
          seed: int = 0, device=None, multi_pod: bool = False, mesh=None):
    """(cfg, params): the config (``reduced`` with ``smoke``) at
    ``precision``, and weights drawn from a generator seeded ``seed`` on
    the device (``None``: the card, which must be there); over
    ``serving_mesh``'s mesh, when there is one, the params are DTensors
    placed by its decode rules (every rank draws the same weights and
    keeps its slices, one layer at a time: ``launch/mesh.init_on_ranks``)."""
    dev = _resolve_device(device)
    cfg = _config(arch, smoke, precision)
    mesh = serving_mesh(smoke=smoke, multi_pod=multi_pod, device=dev,
                        mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        return cfg, M.init(gen, cfg, device=dev)
    return cfg, MESH.init_on_ranks(gen, cfg, mesh, device=dev)


def _model(arch, smoke, precision, seed, device, params, mesh):
    """``setup``'s (cfg, params), or the config of the given params at
    their depth (a cut of the config's, as ``launch.train`` takes it)."""
    if params is None:
        return setup(arch, smoke=smoke, precision=precision, seed=seed,
                     device=device, mesh=mesh)
    cfg = _config(arch, smoke, precision)
    return cfg.replace(n_layers=len(params["layers"])), params


def make_prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """(batch, prompt_len) int32 prompts drawn from ``seed + 1``."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)


def engine_config(batch: int, prompt_len: int, gen: int, *,
                  block_size: int | None = None,
                  prefill_chunk: int | None = None, **kw) -> EngineConfig:
    """The JAX CLI's sizing: blocks of ``max(8, min(32, prompt_len))``
    tokens, a pool for every request plus one block each, a batch row
    per request, chunks of ``min(16, prompt_len)``; ``kw`` the rest of
    the EngineConfig."""
    max_len = prompt_len + gen
    bs = block_size or max(8, min(32, prompt_len))
    return EngineConfig(
        block_size=bs, num_blocks=1 + batch * (-(-max_len // bs) + 1),
        max_batch=max(batch, 1),
        prefill_chunk=prefill_chunk or min(16, prompt_len),
        max_model_len=max_len, **kw)


def make_engine(params, cfg, ecfg: EngineConfig, *, device=None,
                shards: int = 1, roles: str | None = None, mesh=None):
    """An ``Engine`` on ``device`` (over ``mesh`` when given), or with
    ``shards > 1`` a ``ShardedEngine`` of that many shards (worker
    ``roles``, a "P:D" spec or comma names) over ``device`` (tiled), or
    over every card when ``device`` is None; ``roles`` is ignored for
    one shard, as in the JAX CLI."""
    if mesh is not None:
        if shards > 1:
            raise NotImplementedError(
                "--shards over a mesh: the shards are data-axis engines "
                "of one device each (ROADMAP.md queue 1, item 11)")
        return Engine(params, cfg, ecfg, device=device, mesh=mesh)
    if shards > 1:
        return ShardedEngine(params, cfg, ecfg, shards, roles=roles,
                             devices=None if device is None else [device])
    return Engine(params, cfg, ecfg, device=device)


def run(params, cfg, prompts, gen: int, ecfg: EngineConfig, *,
        sampling=lambda b: SamplingParams(), request_kw=lambda b: {},
        late_after: int = 0, n_late: int = 0, watch=None, device=None,
        shards: int = 1, roles: str | None = None, mesh=None):
    """Serve ``prompts`` (a list of 1-D token arrays), ``gen`` new tokens
    each, request ``b`` under ``sampling(b)`` with the further submit
    keywords ``request_kw(b)`` (tenant, priority, ...); the last
    ``n_late`` are submitted after ``late_after`` steps.
    ``watch(engine)``, when given, is called on the new engine before
    the first request.  ``shards``/``roles``/``mesh``: ``make_engine``.
    Returns (the engine, each request's prompt + generated tokens, in
    order)."""
    eng = make_engine(params, cfg, ecfg, device=device, shards=shards,
                      roles=roles, mesh=mesh)
    if watch is not None:
        watch(eng)
    early = len(prompts) - n_late
    rids = [eng.submit(prompts[b], gen, sampling=sampling(b),
                       **request_kw(b)) for b in range(early)]
    for _ in range(late_after):
        eng.step()
    rids += [eng.submit(prompts[b], gen, sampling=sampling(b),
                        **request_kw(b))
             for b in range(early, len(prompts))]
    out = eng.run()
    return eng, [out[r] for r in rids]


def run_stream(params, cfg, prompts, gen: int, ecfg: EngineConfig, *,
               sampling=lambda b: SamplingParams(), request_kw=lambda b: {},
               scores=(), score_kw=lambda i: {}, cancel_after: int = 0,
               late_after: int = 0, n_late: int = 0, watch=None,
               device=None, shards: int = 1, roles: str | None = None,
               mesh=None):
    """``run`` through the asyncio front-end (serving/frontend.py):
    every request's committed tokens are consumed as a stream, the last
    one is cancelled once ``cancel_after`` tokens have streamed (0:
    none), and each prompt of ``scores`` runs as a teacher-forced
    scoring request (submit keywords ``score_kw(i)``) alongside.  The
    last ``n_late`` requests join after the engine has taken
    ``late_after`` steps (of the busiest shard, with ``shards > 1``:
    ``make_engine``, as are ``mesh`` and ``roles``).  Returns (the
    engine, the generation rids in order, rid -> streamed tokens, the
    scoring results in ``scores``' order: ``Frontend.score``'s dicts)."""
    eng = make_engine(params, cfg, ecfg, device=device, shards=shards,
                      roles=roles, mesh=mesh)
    engines = getattr(eng, "engines", [eng])
    if watch is not None:
        watch(eng)
    early = len(prompts) - n_late

    async def go():
        got: dict[int, list[int]] = {}
        async with Frontend(eng) as fe:
            rids = []

            def submit(b):
                rids.append(fe.submit(prompts[b], gen, sampling=sampling(b),
                                      **request_kw(b)))
                return rids[-1]

            async def consume(rid, cancel):
                toks: list[int] = []
                async for burst in fe.stream(rid):
                    toks.extend(burst)
                    if cancel and len(toks) >= cancel_after:
                        fe.cancel(rid)
                got[rid] = toks

            def consumer(b):
                rid = submit(b)
                last = b == len(prompts) - 1
                return consume(rid, bool(cancel_after) and last)

            async def late():
                while max(e.step_count for e in engines) < late_after:
                    await asyncio.sleep(0)
                return await asyncio.gather(
                    *(consumer(b) for b in range(early, len(prompts))))

            results = await asyncio.gather(
                *(consumer(b) for b in range(early)), late(),
                *(fe.score(p, **score_kw(i)) for i, p in enumerate(scores)))
        return rids, got, list(results[early + 1:])

    rids, got, scored = asyncio.run(go())
    return eng, rids, got, scored


@torch.no_grad()
def run_legacy(params, cfg, prompts: np.ndarray, gen: int, *,
               greedy: bool = True, device=None, mesh=None):
    """The legacy loop: a dense per-batch cache, the prompt fed one
    token a step, then ``gen`` tokens; greedy, or
    ``categorical(PRNGKey(i))`` at step i as the JAX loop draws.  Over
    ``mesh``, the caches placed by the decode rules and the steps under
    their sharding context.  Returns ((batch, prompt_len + gen) int32
    tokens, tokens/s)."""
    dev = _resolve_device(device)
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen
    ctx = contextlib.nullcontext()
    if mesh is not None:
        params = SH.placed(params, cfg, mesh)
        ctx = C.sharding_context(mesh, SH.decode_rules_of(mesh))
    caches = M.init_cache(cfg, batch, max_len, device=dev, mesh=mesh)
    pr = torch.from_numpy(np.asarray(prompts, np.int64)).to(dev)
    t0 = time.perf_counter()
    tok = pr[:, :1]
    out = [tok]
    with ctx:
        for i in range(max_len - 1):
            logits, caches = M.decode_step(params, cfg, tok, caches, i)
            logits = spmd.full(logits)
            if i + 1 < prompt_len:
                tok = pr[:, i + 1:i + 2]
            elif greedy:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            else:
                tok = categorical(i, logits[:, -1])[:, None]
            out.append(tok)
    seqs = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
    dt = time.perf_counter() - t0
    return seqs, batch * (max_len - 1) / dt


def serve_legacy(arch: str, *, smoke: bool = False, batch: int = 4,
                 prompt_len: int = 16, gen: int = 16,
                 precision: str | None = None, seed: int = 0,
                 greedy: bool = True, device=None, params=None,
                 prompts=None, verbose: bool = True,
                 mesh=None) -> np.ndarray:
    """Reference loop over the dense cache; ``params`` (on ``device``)
    and ``prompts`` replace the seeded ones; ``mesh`` as ``serve``'s
    (already resolved)."""
    cfg, params = _model(arch, smoke, precision, seed, device, params, mesh)
    if prompts is None:
        prompts = make_prompts(cfg, batch, prompt_len, seed)
    seqs, tps = run_legacy(params, cfg, np.asarray(prompts), gen,
                           greedy=greedy, device=device, mesh=mesh)
    if verbose:
        print(f"[serve:legacy] {arch} precision={cfg.precision} "
              f"batch={len(seqs)} tokens/s={tps:.1f}")
    return seqs


def serve(arch: str, *, smoke: bool = False, batch: int = 4,
          prompt_len: int = 16, gen: int = 16,
          precision: str | None = None, seed: int = 0, greedy: bool = True,
          engine: str = "paged", block_size: int | None = None,
          prefill_chunk: int | None = None, accelerator: str = "OXBNN_50",
          verbose: bool = True, prefix_cache: bool = True,
          preempt_policy: str = "swap", snapshot_slots: int = 0,
          spec_k: int = 0, spec_ngram: int = 3, temperature: float = 0.0,
          top_k: int = 0, top_p: float = 1.0, sampling_seed: int = 0,
          stop: tuple[int, ...] = (), attn_impl: str = "auto",
          bnn_impl: str = "auto", policy: str | None = None,
          tenants: str = "", trace: str | None = None,
          replay_photonic: bool = False, stream: bool = False,
          score: int = 0, cancel_after: int = 0, shards: int = 1,
          roles: str | None = None, device=None, params=None,
          prompts=None, multi_pod: bool = False, mesh=None):
    """Serve ``batch`` requests of ``prompt_len`` tokens, ``gen`` new
    each; returns (batch, prompt_len + gen) token ids, prompts included
    (a ragged list when stop tokens end some early; a cancelled request
    is left out).  ``params`` (on ``device``) and ``prompts`` replace
    the seeded ones.  ``multi_pod`` and ``mesh``: ``serving_mesh``;
    given params are placed on its mesh unless they are DTensors.

    ``tenants`` turns on the slo policy (unless ``policy`` says
    otherwise); with ``stream`` the requests are spread round-robin over
    the named tenants (the batch path submits them all under the
    default tenant, as the JAX CLI does).  ``trace`` records the
    engine's JSONL trace there, ``replay_photonic`` prints its replay
    report.  ``stream`` drives
    the engine through the asyncio front-end: requests stream their
    committed tokens, ``score`` teacher-forced scoring requests (over
    the prompts in turn) run alongside, and ``cancel_after`` cancels
    the last request after that many streamed tokens.  Uncancelled
    streamed output equals the batch path's for the same flags.
    ``shards > 1`` serves through a ``ShardedEngine`` (``roles``: its
    prefill/decode split), with the same tokens as one engine; its
    summary is the per-shard rows, the aggregate line and the handoffs,
    and ``trace`` then names the prefix of the per-shard files."""
    mesh = serving_mesh(smoke=smoke, multi_pod=multi_pod, device=device,
                        mesh=mesh)
    if engine == "legacy":
        return serve_legacy(arch, smoke=smoke, batch=batch,
                            prompt_len=prompt_len, gen=gen,
                            precision=precision, seed=seed, greedy=greedy,
                            device=device, params=params, prompts=prompts,
                            verbose=verbose, mesh=mesh)
    if engine != "paged":
        raise ValueError(f"unknown engine {engine!r}")
    cfg, params = _model(arch, smoke, precision, seed, device, params, mesh)
    if prompts is None:
        prompts = make_prompts(cfg, batch, prompt_len, seed)
    prompts = np.asarray(prompts)
    batch, prompt_len = prompts.shape
    if policy is None:
        policy = "slo" if tenants else "fcfs"
    ecfg = engine_config(batch, prompt_len, gen, block_size=block_size,
                         prefill_chunk=prefill_chunk,
                         accelerator=accelerator, prefix_cache=prefix_cache,
                         preempt_policy=preempt_policy,
                         snapshot_slots=snapshot_slots, spec_k=spec_k,
                         spec_ngram=spec_ngram, attn_impl=attn_impl,
                         bnn_impl=bnn_impl, policy=policy,
                         tenants=tenants_arg(tenants))
    names = list(parse_tenants(tenants)) or ["default"]

    def sampling(b):
        return SamplingParams(temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=sampling_seed + b,
                              stop=stop)

    def watch(eng):
        if trace or replay_photonic:
            eng.start_trace(trace, ring=1 << 16)

    sharded = dict(shards=shards, roles=roles, mesh=mesh)
    if stream:
        eng, rids, got, scored = run_stream(
            params, cfg, list(prompts), gen, ecfg, sampling=sampling,
            request_kw=lambda b: {"tenant": names[b % len(names)]},
            scores=[prompts[i % batch] for i in range(score)],
            score_kw=lambda i: {"tenant": names[i % len(names)]},
            cancel_after=cancel_after, watch=watch, device=device,
            **sharded)
        seqs = []
        for b, rid in enumerate(rids):
            req = eng.requests[rid]
            cancelled = req.state.name == "CANCELLED"
            if verbose:
                tag = " CANCELLED" if cancelled else ""
                print(f"[serve:stream] rid={rid} tenant={req.tenant} "
                      f"class={req.slo_class} streamed={len(got[rid])}{tag}")
            if not cancelled:
                seqs.append(np.concatenate(
                    [prompts[b], np.asarray(got[rid], np.int32)]))
        if verbose:
            for sc in scored:
                print(f"[serve:stream] score rid={sc['rid']} "
                      f"tokens={sc['scored_tokens']} ppl={sc['ppl']:.3f}")
    else:
        eng, seqs = run(params, cfg, list(prompts), gen, ecfg,
                        sampling=sampling, watch=watch, device=device,
                        **sharded)
    if trace or replay_photonic:
        shard_records = [e.tracer.events()
                         for e in getattr(eng, "engines", [eng])]
        eng.stop_trace()
        if trace and verbose:
            print(f"[serve] trace -> {trace} (view: python -m "
                  f"repro_torch.launch.trace_view {trace})")
        if replay_photonic:
            if shards > 1:
                for recs in shard_records:
                    print(format_report(replay_trace(
                        recs, cfg=cfg, accelerator=accelerator)))
            else:
                print(format_report(replay_trace(
                    trace or shard_records[0], cfg=cfg,
                    accelerator=accelerator)))
    if verbose and shards > 1:
        report_sharded(arch, eng, batch)
    elif verbose:
        report(arch, eng, batch)
    if len({len(s) for s in seqs}) > 1:      # early stop: ragged
        return seqs
    return np.stack(seqs)


def report(arch: str, eng: Engine, batch: int):
    """The JAX CLI's summary lines for one engine run of ``batch``
    generation requests."""
    st = eng.stats()
    ph, pc, sw = st["photonic"], st["prefix_cache"], st["swap"]
    print(f"[serve] {arch} precision={eng.cfg.precision} "
          f"batch={batch} device={st['device']} "
          f"decode-tokens/s={st['decode_tokens_per_s']:.1f} "
          f"total-tokens/s={st['total_tokens_per_s']:.1f} "
          f"steps={st['steps']} "
          f"max_concurrent={st['max_concurrent_decode']}")
    sp = st["speculative"]
    if sp["enabled"]:
        print(f"[serve] speculative k={sp['spec_k']}: "
              f"acceptance={sp['acceptance_rate']:.2f} "
              f"tokens/step={sp['tokens_per_decode_step']:.2f} "
              f"modeled-speedup={ph['modeled_spec_speedup']:.2f}x")
    for fam, mx in st["mixer"].items():
        extra = (f" ring_blocks={mx['ring_blocks']} "
                 f"reuse={100 * mx['ring_reuse_rate']:.0f}%"
                 if mx.get("ring_blocks") else "")
        print(f"[serve] mixer[{fam}] layout={mx['layout']} "
              f"layers={mx['layers']} "
              f"occupancy={100 * mx['occupancy']:.0f}%{extra}")
    print(f"[serve] prefix-cache {'on' if pc['enabled'] else 'off'}: "
          f"hit-rate={pc['hit_rate']:.2f} "
          f"skipped_prefill={pc['skipped_prefill_tokens']} "
          f"cow={pc['cow_copies']}; "
          f"swaps out/in={sw['swap_outs']}/{sw['swap_ins']}")
    print(f"[serve] modeled {ph['accelerator']}: "
          f"{ph['modeled_tokens_per_s']:.0f} tokens/s "
          f"(effective {ph['modeled_effective_tokens_per_s']:.0f} "
          f"with pipelined prefill + prefix credit; bottleneck: "
          f"{ph['bottleneck_stage']})")


def report_sharded(arch: str, eng: ShardedEngine, batch: int):
    """The JAX CLI's summary of a sharded run: a row per shard, the
    aggregate line and, when prompts were handed off, the handoffs."""
    st = eng.stats()
    for row in st["per_shard"]:
        print(f"[serve] shard {row['shard']} ({row['role']})"
              f"{'' if row['alive'] else ' (dead)'}: "
              f"decoded={row['decoded_tokens']} "
              f"decode-tokens/s={row['decode_tokens_per_s']:.1f} "
              f"finished={row['finished']} "
              f"swap_losts={row['swap_losts']}")
    print(f"[serve] {arch} precision={eng.cfg.precision} "
          f"shards={eng.n_shards} batch={batch} aggregate "
          f"decode-tokens/s={st['aggregate_decode_tokens_per_s']:.1f} "
          f"migrations={st['migrations']} "
          f"requeued_lost={st['requeued_lost']}")
    ho = st["handoff"]
    if ho["handoffs"]:
        print(f"[serve] handoffs={ho['handoffs']} "
              f"bytes={ho['handoff_bytes']} "
              f"modeled-transfer={1e3 * ho['modeled_transfer_s']:.3f}ms "
              f"@{ho['link_gbps']:.0f}Gb/s "
              f"(host-copy wall {1e3 * ho['host_copy_wall_s']:.1f}ms)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="bnn-lm-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="paged", choices=["paged", "legacy"])
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--accelerator", default="OXBNN_50")
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="content-addressed prompt prefix reuse")
    ap.add_argument("--preempt-policy", default="swap",
                    choices=["swap", "recompute"],
                    help="swap-to-host (default) or recompute-on-resume")
    ap.add_argument("--snapshot-slots", type=int, default=0,
                    help="recurrent prefix-snapshot pool rows "
                         "(0 = 2 * max_batch)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft length (0 = off)")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="max n-gram for prompt-lookup drafts")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus filter (1.0 = off)")
    ap.add_argument("--sampling-seed", type=int, default=0,
                    help="base per-request sampling seed")
    ap.add_argument("--stop-token", type=int, action="append", default=[],
                    help="stop/eos token id (repeatable)")
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="paged attention: the Hopper kernel, its plain "
                         "PyTorch version, or auto (by device)")
    ap.add_argument("--bnn-impl", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="packed BNN GEMM, as --attn-impl (each resolved "
                         "on its own)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain "
                         "versions on the CPU")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a structured JSONL engine trace (view "
                         "with python -m repro_torch.launch.trace_view)")
    ap.add_argument("--replay-photonic", action="store_true",
                    help="replay the recorded steps through the "
                         "photonic simulator (analytic-vs-simulated)")
    ap.add_argument("--policy", default=None,
                    choices=["fcfs", "priority", "slo"],
                    help="scheduler policy (default: slo when "
                         "--tenants is set, else fcfs)")
    ap.add_argument("--tenants", default="", metavar="NAME=CLASS:BUDGET",
                    help="comma-separated tenant spec, e.g. "
                         "'web=latency:0,bulk=throughput:2048'; "
                         "requests are assigned round-robin")
    ap.add_argument("--stream", action="store_true",
                    help="drive the engine through the asyncio "
                         "front-end: per-request token streams, "
                         "cancellation, scoring")
    ap.add_argument("--score", type=int, default=0,
                    help="teacher-forced scoring requests to run "
                         "alongside generation (requires --stream)")
    ap.add_argument("--cancel-after", type=int, default=0,
                    help="cancel the last request after this many "
                         "streamed tokens (requires --stream)")
    ap.add_argument("--shards", type=int, default=1,
                    help="serving shards (1 = one engine); shards share "
                         "a device when there are more shards than "
                         "devices")
    ap.add_argument("--roles", default=None, metavar="P:D",
                    help="split the shards into prefill/decode workers: "
                         "'P:D' counts (e.g. 1:2) or comma names "
                         "(prefill,decode,mixed); must cover --shards; "
                         "default all mixed")
    ap.add_argument("--multi-pod", action="store_true",
                    help="under a process group of 512 ranks: the "
                         "(2, 16, 16) mesh (raises elsewhere)")
    args = ap.parse_args(argv)
    return serve(
        args.arch, smoke=args.smoke, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, precision=args.precision,
        seed=args.seed, engine=args.engine, block_size=args.block_size,
        prefill_chunk=args.prefill_chunk, accelerator=args.accelerator,
        prefix_cache=args.prefix_cache, preempt_policy=args.preempt_policy,
        snapshot_slots=args.snapshot_slots, spec_k=args.spec_k,
        spec_ngram=args.spec_ngram,
        greedy=args.temperature <= 0,     # legacy-loop sampling mode
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        sampling_seed=args.sampling_seed, stop=tuple(args.stop_token),
        attn_impl=args.attn_impl, bnn_impl=args.bnn_impl,
        policy=args.policy, tenants=args.tenants, trace=args.trace,
        replay_photonic=args.replay_photonic, stream=args.stream,
        score=args.score, cancel_after=args.cancel_after,
        shards=args.shards, roles=args.roles, device=args.device,
        multi_pod=args.multi_pod)


if __name__ == "__main__":
    main()
