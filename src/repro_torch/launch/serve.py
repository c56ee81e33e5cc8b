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

It runs on the card; ``--device cpu`` is the only way to run it on the
CPU (the plain PyTorch versions of the kernels).  The options of later
slices (streaming, shards, roles, policies, tenants, scoring, tracing,
multi-pod meshes) raise and name their ROADMAP.md item.

Setup and run are split (``setup``, ``make_prompts``, ``run``,
``run_legacy``): ``serve``/``serve_legacy`` take ``params`` and
``prompts`` as well, so the same weights and prompts can be served by
both packages.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bnn-lm-100m \\
      --precision bnn
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.models import transformer as M
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.engine import _resolve_device
from repro_torch.serving.sampling import categorical

# options of the JAX CLI that later slices bring: argument -> (its
# default, the ROADMAP.md item that brings it)
LATER = {
    "multi_pod": (False, "queue 1, item 10"),
    "trace": (None, 'queue 1, item 7, "Tracing"'),
    "replay_photonic": (False, 'queue 1, item 7, "Tracing"'),
    "shards": (1, 'queue 1, item 7, "Sharded serving"'),
    "roles": (None, 'queue 1, item 7, "Worker roles"'),
    "policy": (None, 'queue 1, item 7, "Policies"'),
    "tenants": ("", 'queue 1, item 7, "Policies"'),
    "stream": (False, 'queue 1, item 7, "Front-end and replay"'),
    "score": (0, 'queue 1, item 7, "Front-end and replay"'),
    "cancel_after": (0, 'queue 1, item 7, "Front-end and replay"'),
}


def refuse_later(**opts):
    """Raise for any option of a later slice that is not at its default."""
    for name, value in opts.items():
        default, item = LATER[name]
        if value != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')}={value!r} is not ported yet "
                f"(ROADMAP.md {item})")


def _config(arch: str, smoke: bool, precision: str | None):
    cfg = configs.get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    return cfg.replace(precision=precision) if precision else cfg


def setup(arch: str, *, smoke: bool = False, precision: str | None = None,
          seed: int = 0, device=None):
    """(cfg, params): the config (``reduced`` with ``smoke``) at
    ``precision``, and weights drawn from a generator seeded ``seed`` on
    the device (``None``: the card, which must be there)."""
    dev = _resolve_device(device)
    cfg = _config(arch, smoke, precision)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, M.init(gen, cfg, device=dev)


def _model(arch, smoke, precision, seed, device, params):
    """``setup``'s (cfg, params), or the config of the given params."""
    if params is None:
        return setup(arch, smoke=smoke, precision=precision, seed=seed,
                     device=device)
    return _config(arch, smoke, precision), params


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


def run(params, cfg, prompts, gen: int, ecfg: EngineConfig, *,
        sampling=lambda b: SamplingParams(), late_after: int = 0,
        n_late: int = 0, watch=None, device=None):
    """Serve ``prompts`` (a list of 1-D token arrays), ``gen`` new tokens
    each, request ``b`` under ``sampling(b)``; the last ``n_late`` are
    submitted after ``late_after`` steps.  ``watch(engine)``, when given,
    is called on the new engine before the first request.  Returns (the
    engine, each request's prompt + generated tokens, in order)."""
    eng = Engine(params, cfg, ecfg, device=device)
    if watch is not None:
        watch(eng)
    early = len(prompts) - n_late
    rids = [eng.submit(prompts[b], gen, sampling=sampling(b))
            for b in range(early)]
    for _ in range(late_after):
        eng.step()
    rids += [eng.submit(prompts[b], gen, sampling=sampling(b))
             for b in range(early, len(prompts))]
    out = eng.run()
    return eng, [out[r] for r in rids]


@torch.no_grad()
def run_legacy(params, cfg, prompts: np.ndarray, gen: int, *,
               greedy: bool = True, device=None):
    """The legacy loop: a dense per-batch cache, the prompt fed one
    token a step, then ``gen`` tokens; greedy, or
    ``categorical(PRNGKey(i))`` at step i as the JAX loop draws.
    Returns ((batch, prompt_len + gen) int32 tokens, tokens/s)."""
    dev = _resolve_device(device)
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen
    caches = M.init_cache(cfg, batch, max_len, device=dev)
    pr = torch.from_numpy(np.asarray(prompts, np.int64)).to(dev)
    t0 = time.perf_counter()
    tok = pr[:, :1]
    out = [tok]
    for i in range(max_len - 1):
        logits, caches = M.decode_step(params, cfg, tok, caches, i)
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
                 prompts=None, verbose: bool = True) -> np.ndarray:
    """Reference loop over the dense cache; ``params`` (on ``device``)
    and ``prompts`` replace the seeded ones."""
    cfg, params = _model(arch, smoke, precision, seed, device, params)
    if prompts is None:
        prompts = make_prompts(cfg, batch, prompt_len, seed)
    seqs, tps = run_legacy(params, cfg, np.asarray(prompts), gen,
                           greedy=greedy, device=device)
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
          bnn_impl: str = "auto", device=None, params=None, prompts=None,
          **later):
    """Serve ``batch`` requests of ``prompt_len`` tokens, ``gen`` new
    each; returns (batch, prompt_len + gen) token ids, prompts included
    (a ragged list when stop tokens end some early).  ``params`` (on
    ``device``) and ``prompts`` replace the seeded ones; ``later`` takes
    the JAX CLI's options of later slices, which raise unless at their
    defaults."""
    refuse_later(**later)
    if engine == "legacy":
        return serve_legacy(arch, smoke=smoke, batch=batch,
                            prompt_len=prompt_len, gen=gen,
                            precision=precision, seed=seed, greedy=greedy,
                            device=device, params=params, prompts=prompts,
                            verbose=verbose)
    if engine != "paged":
        raise ValueError(f"unknown engine {engine!r}")
    cfg, params = _model(arch, smoke, precision, seed, device, params)
    if prompts is None:
        prompts = make_prompts(cfg, batch, prompt_len, seed)
    prompts = np.asarray(prompts)
    batch, prompt_len = prompts.shape
    ecfg = engine_config(batch, prompt_len, gen, block_size=block_size,
                         prefill_chunk=prefill_chunk,
                         accelerator=accelerator, prefix_cache=prefix_cache,
                         preempt_policy=preempt_policy,
                         snapshot_slots=snapshot_slots, spec_k=spec_k,
                         spec_ngram=spec_ngram, attn_impl=attn_impl,
                         bnn_impl=bnn_impl)

    def sampling(b):
        return SamplingParams(temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=sampling_seed + b,
                              stop=stop)

    eng, seqs = run(params, cfg, list(prompts), gen, ecfg,
                    sampling=sampling, device=device)
    if verbose:
        report(arch, eng)
    if len({len(s) for s in seqs}) > 1:      # early stop: ragged
        return seqs
    return np.stack(seqs)


def report(arch: str, eng: Engine):
    """The JAX CLI's summary lines for one engine run."""
    st = eng.stats()
    ph, pc, sw = st["photonic"], st["prefix_cache"], st["swap"]
    print(f"[serve] {arch} precision={eng.cfg.precision} "
          f"batch={len(eng.requests)} device={st['device']} "
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
                    help="packed BNN GEMM, as --attn-impl (must equal it)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain "
                         "versions on the CPU")
    # the JAX CLI's options of later slices: each raises when set
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--replay-photonic", action="store_true")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--roles", default=None)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--tenants", default="")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--score", type=int, default=0)
    ap.add_argument("--cancel-after", type=int, default=0)
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
        device=args.device,
        **{name: getattr(args, name) for name in LATER})


if __name__ == "__main__":
    main()
