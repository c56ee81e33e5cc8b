"""Shared traced runs of the two packages' engines on the same traffic
(tests/test_torch_tracing.py, tests/test_torch_replay.py).

The reduced bnn-lm-100m, seeded JAX weights carried across by
``interop.params_from_numpy``, a Poisson trace with shared prompt heads
and a pool small enough to swap, under the slo policy with two budgeted
tenants; each engine writes its JSONL trace (``start_trace``) to a
temporary directory, with ``capture_logits`` on."""
import numpy as np

import _torch_family as F
from repro.serving import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch.serving import Engine, EngineConfig

ARCH = "bnn-lm-100m"
ENGINE = dict(block_size=4, num_blocks=12, max_batch=3, prefill_chunk=4,
              max_model_len=40, policy="slo",
              tenants="a=latency:44,b=throughput:60")
GEN = 8
# per-run fields of a record, not of the engine's decisions: timestamps,
# durations and the tracer's clock anchor
TIMING = ("ts", "dur_s", "t0")
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)   # float32, tests/test_torch_model.py


def drive(eng, arrival, prompts, kw=lambda i: {}):
    """Submit each prompt at its arrival step (tenant a/b alternating),
    run to completion; returns each request's prompt + generated
    tokens, in order."""
    rids, i = {}, 0
    while i < len(prompts) or not eng.scheduler.idle:
        while i < len(prompts) and eng.step_count >= arrival[i]:
            rids[i] = eng.submit(prompts[i], GEN, tenant="ab"[i % 2],
                                 **kw(i))
            i += 1
        eng.step()
    return [eng.requests[rids[k]].full_sequence()
            for k in range(len(prompts))]


def traced_runs(tmp_dir, engine=ENGINE, capture_logits=True):
    """{"jax"|"torch": (engine, tokens, trace path)} on the same traffic
    and config, plus "plain": the port untraced."""
    jp, tp = F.models(ARCH)
    jcfg, tcfg = F.cfgs(ARCH, "bnn")
    arrival, prompts = F.poisson_trace(jcfg.vocab, 12, (4, 5, 2), n=9)
    out = {}
    for side in ("jax", "torch", "plain"):
        if side == "jax":
            eng = JEngine(jp, jcfg, JEngineConfig(**engine, attn_impl="xla",
                                                  bnn_impl="xla"))
        else:
            eng = Engine(tp, tcfg, EngineConfig(**engine), device="cpu")
        path = str(tmp_dir / f"{side}.jsonl")
        if side != "plain":
            eng.start_trace(path, capture_logits=capture_logits)
        toks = drive(eng, arrival, prompts)
        eng.stop_trace()
        out[side] = (eng, toks, path)
    return out


def strip(rec: dict) -> dict:
    """A record without its timing fields, its captured logits (held
    to a float tolerance apart) and the port's extra ``slot`` on admit
    events."""
    out = {k: v for k, v in rec.items() if k not in TIMING and k != "slot"}
    for kind in ("prefill", "decode"):
        if isinstance(out.get(kind), dict):
            out[kind] = {k: v for k, v in out[kind].items() if k != "logits"}
    return out


def logits_of(records) -> list[np.ndarray]:
    return [np.asarray(r[kind]["logits"], np.float32) for r in records
            if r["type"] == "step" for kind in ("prefill", "decode")
            if kind in r and "logits" in r[kind]]
