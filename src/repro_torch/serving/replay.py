"""Hardware-in-the-loop replay: recorded engine traces re-priced by the
transaction-level photonic simulator.

The serving cost model (serving/cost_model.py) prices steps
ANALYTICALLY — closed-form pipeline-interval / fill arithmetic over the
per-GEMM latencies.  This module feeds the engine's real per-step
behavior (a JSONL trace from ``Engine.start_trace``, see
serving/tracing.py) back through ``photonic/simulator.py`` — the
paper's B_ONN_SIM counterpart — as TRANSACTIONS, and reports both
prices side by side per step kind.  These are modelled numbers of the
photonic accelerator, not measurements of the device that served the
trace.

Mapping (extends the paper's batch-1 pipeline to a served batch): every
step feeds ``n`` tokens through the same per-token GEMM stack
(``cost_model.gemm_specs``).  A batched step becomes one pass per layer
with ``LayerSpec.batch = n``: each extra row adds VDP outputs — more
waves over the P OXG arrays (XPEs), each wave ``ceil(S/N)`` DWDM
wavelength slices wide — while the programmed MRR weight banks and the
per-layer pipeline fill are shared across the whole batch.  Decode
rows, prefill chunk tokens, and speculative verify positions all ride
this mapping, so continuous batching has a modeled hardware cost curve
(``decode_batch_curve`` in the report) beside the analytic model's
B-sequential-tokens assumption.

A trace is self-describing (its meta record carries the flat arch
config), so ``replay_trace(path)`` needs nothing else, and a trace the
JAX package wrote replays here too:

    PYTHONPATH=src python -m repro_torch.launch.trace_view trace.jsonl \
        --replay-photonic
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig
from repro_torch.photonic import accelerators
from repro_torch.photonic.simulator import SimKnobs, simulate_layer
from repro_torch.serving.cost_model import PhotonicCostModel, gemm_specs
from repro_torch.serving.tracing import read_trace, validate_trace

REPLAY_SCHEMA_VERSION = 1

STEP_KINDS = ("prefill", "decode", "spec_verify")


def load_config(meta: dict) -> ArchConfig:
    """Rebuild the arch config a trace was recorded with (the meta
    record stores the flat dataclass verbatim)."""
    return ArchConfig(**meta["config"])


@dataclass
class _KindTotals:
    steps: int = 0
    fed_tokens: int = 0
    committed_tokens: int = 0
    analytic_s: float = 0.0
    simulated_s: float = 0.0
    simulated_energy_j: float = 0.0

    def as_dict(self) -> dict:
        return {
            "steps": self.steps,
            "fed_tokens": self.fed_tokens,
            "committed_tokens": self.committed_tokens,
            "analytic_s": self.analytic_s,
            "simulated_s": self.simulated_s,
            "simulated_energy_j": self.simulated_energy_j,
            "analytic_over_simulated": (
                self.analytic_s / self.simulated_s
                if self.simulated_s else float("nan")),
        }


class TraceReplayer:
    """Prices recorded step events on the modeled accelerator, both
    analytically (cost model) and by transaction-level simulation."""

    def __init__(self, cfg, accelerator: str = "OXBNN_50",
                 knobs: SimKnobs = SimKnobs(), *, fused_bnn: bool = True,
                 link_gbps: float = 100.0):
        self.cfg = cfg
        self.acc = accelerators.by_name(accelerator)
        self.knobs = knobs
        self.fused_bnn = fused_bnn
        self.cost = PhotonicCostModel(cfg, accelerator, knobs,
                                      fused_bnn=fused_bnn,
                                      link_gbps=link_gbps)
        self.specs = gemm_specs(cfg)
        self._memo: dict[int, tuple[float, float]] = {}

    # ------------------------------------------------------- simulation

    def simulate_step(self, n_tokens: int) -> tuple[float, float]:
        """(latency_s, energy_j) of ONE batched pass over the layer
        stack with ``n_tokens`` rows riding the DWDM/OXG mapping.
        Memoized — a serving trace repeats a handful of shapes."""
        n_tokens = max(int(n_tokens), 1)
        hit = self._memo.get(n_tokens)
        if hit is not None:
            return hit
        lat = en = 0.0
        for spec in self.specs:
            lr = simulate_layer(self.acc, spec.with_batch(n_tokens),
                                self.knobs)
            lat += lr.latency_s
            en += lr.energy_j
        # unfused chain: every token's packed activations round-trip
        # through eDRAM between GEMMs (see PhotonicCostModel.__init__)
        lat += n_tokens * self.cost.pack_pass_s_per_token
        self._memo[n_tokens] = (lat, en)
        return lat, en

    # --------------------------------------------------------- analytic

    def analytic_step(self, kind: str, info: dict) -> float:
        """The serving cost model's price for the same step part."""
        if kind == "prefill":
            return self.cost.prefill_latency_s(info["tokens"], 1)
        if kind == "decode":
            return self.cost.step_latency_s(info["rows"])
        if kind == "spec_verify":
            # per-ROW verify passes on the batch-1 accelerator: every
            # row streams its fed tokens and pays its own fills
            return (info["fed_tokens"] * self.cost.pipeline_interval_s
                    + info["rows"] * self.cost.fill_s)
        raise ValueError(f"unknown step kind {kind!r}")

    # ------------------------------------------------------------ replay

    def replay(self, records: list[dict]) -> dict:
        validate_trace(records)
        meta = records[0] if records else {}
        by_kind: dict[str, _KindTotals] = {}
        max_rows = 1
        n_steps = 0
        for rec in records:
            if rec.get("type") != "step":
                continue
            n_steps += 1
            for kind in STEP_KINDS:
                info = rec.get(kind)
                if not info:
                    continue
                fed = info.get("fed_tokens", info.get("tokens", 0))
                committed = info.get(
                    "committed",
                    # a prompt-completing prefill commits the first token
                    1 if (kind == "prefill"
                          and info.get("pos") == info.get("prompt_len"))
                    else 0)
                t = by_kind.setdefault(kind, _KindTotals())
                t.steps += 1
                t.fed_tokens += fed
                t.committed_tokens += committed
                t.analytic_s += self.analytic_step(kind, info)
                lat, en = self.simulate_step(fed)
                t.simulated_s += lat
                t.simulated_energy_j += en
                if kind != "prefill":
                    max_rows = max(max_rows, info.get("rows", 1))
        finished = sum(1 for r in records
                       if r.get("type") == "request"
                       and r.get("event") == "finish")
        # prefill->decode handoff spans (schema v3): bytes moved over
        # the modeled link, priced by the cost model's transfer term.
        # The link streams while the destination keeps decoding, so
        # only the part no decode time can hide is EXPOSED.
        handoffs_in = handoffs_out = bytes_in = bytes_out = 0
        for rec in records:
            if rec.get("type") != "span":
                continue
            if rec.get("name") == "handoff_in":
                handoffs_in += 1
                bytes_in += rec.get("bytes", 0)
            elif rec.get("name") == "handoff_out":
                handoffs_out += 1
                bytes_out += rec.get("bytes", 0)
        transfer_s = self.cost.transfer_latency_s(bytes_in)
        analytic_s = sum(t.analytic_s for t in by_kind.values())
        simulated_s = sum(t.simulated_s for t in by_kind.values())
        energy_j = sum(t.simulated_energy_j for t in by_kind.values())
        committed = sum(t.committed_tokens for t in by_kind.values())
        # modeled cost curve of batched decode: per-step and per-token
        # latency at every power-of-two batch up to the observed max
        curve = {}
        sizes = []
        b = 1
        while b < max_rows:
            sizes.append(b)
            b <<= 1
        sizes.append(max_rows)
        for b in sizes:
            lat, _ = self.simulate_step(b)
            curve[str(b)] = {
                "step_latency_s": lat,
                "token_latency_s": lat / b,
                "analytic_step_latency_s": self.cost.step_latency_s(b),
            }
        return {
            "schema_version": REPLAY_SCHEMA_VERSION,
            "arch": self.cfg.name,
            "accelerator": self.acc.name,
            "fused_bnn": self.fused_bnn,
            "pack_pass_s_per_token": self.cost.pack_pass_s_per_token,
            # per-shard traces (ShardedEngine) carry their shard id in
            # the meta record; single-engine traces report shard=None
            "shard": meta.get("shard"),
            "n_shards": meta.get("n_shards", 1),
            "role": meta.get("role", "mixed"),
            "handoff": {
                "handoffs_in": handoffs_in,
                "handoffs_out": handoffs_out,
                "bytes_in": bytes_in,
                "bytes_out": bytes_out,
                "link_gbps": self.cost.link_gbps,
                "modeled_transfer_s": transfer_s,
                # transfer time no decode step overlapped away: what a
                # dedicated-link topology actually adds to the shard's
                # modeled serving time
                "exposed_transfer_s": max(
                    0.0, transfer_s - by_kind.get(
                        "decode", _KindTotals()).simulated_s),
            },
            "steps": n_steps,
            "by_kind": {k: t.as_dict() for k, t in by_kind.items()},
            "analytic_s": analytic_s,
            "simulated_s": simulated_s,
            "simulated_s_with_transfer": simulated_s + max(
                0.0, transfer_s - by_kind.get(
                    "decode", _KindTotals()).simulated_s),
            "simulated_energy_j": energy_j,
            "committed_tokens": committed,
            "finished_requests": finished,
            "analytic_tokens_per_s": (committed / analytic_s
                                      if analytic_s else float("nan")),
            "simulated_tokens_per_s": (committed / simulated_s
                                       if simulated_s else float("nan")),
            "simulated_fps": (finished / simulated_s
                              if simulated_s else float("nan")),
            "simulated_power_w": (energy_j / simulated_s
                                  if simulated_s else float("nan")),
            "decode_batch_curve": curve,
        }


def spec_chunk_cap(curve: dict) -> int | None:
    """Modeled DWDM pipeline-fill break-even of a ``decode_batch_curve``.

    The simulated curve is sublinear: extra rows/positions ride the
    same programmed MRR banks and share the pipeline fill, so the
    MARGINAL cost of widening a batched pass starts far below the cost
    of a separate single-token step — until the wavelength/OXG supply
    saturates and each extra position costs as much as its own step.
    The break-even is the widest point whose marginal step latency per
    added token is still below the single-token step latency; a
    speculative verify chunk wider than this cannot beat sequential
    decode on the modeled hardware (``Engine.apply_replay_curve`` caps
    ``spec_k`` with it).  None when the curve is empty or lacks the
    batch-1 anchor."""
    if not curve:
        return None
    pts = sorted((int(b), float(v["step_latency_s"]))
                 for b, v in curve.items())
    b0, t0 = pts[0]
    if b0 != 1 or t0 <= 0:
        return None
    cap = 1
    prev_b, prev_t = b0, t0
    for b, t in pts[1:]:
        marginal = (t - prev_t) / (b - prev_b)
        if marginal >= t0:
            break
        cap, prev_b, prev_t = b, b, t
    return cap


def replay_trace(source, cfg=None, accelerator: str | None = None,
                 knobs: SimKnobs = SimKnobs(), *,
                 fused_bnn: bool = True) -> dict:
    """Replay a trace (JSONL path or record list) through the photonic
    simulator.  ``cfg``/``accelerator`` default to what the trace's
    meta record says the engine ran with."""
    records = (read_trace(source) if isinstance(source, (str, bytes))
               or hasattr(source, "__fspath__") else list(source))
    validate_trace(records)
    meta = records[0]
    if cfg is None:
        cfg = load_config(meta)
    if accelerator is None:
        accelerator = meta.get("accelerator", "OXBNN_50")
    link_gbps = meta.get("link_gbps", 100.0)
    return TraceReplayer(cfg, accelerator, knobs, fused_bnn=fused_bnn,
                         link_gbps=link_gbps).replay(records)


def format_report(rep: dict) -> str:
    """Human-readable analytic-vs-simulated table per step kind."""
    lines = [
        f"[replay] {rep['arch']} on {rep['accelerator']}: "
        f"{rep['steps']} steps, {rep['committed_tokens']} committed "
        f"tokens, {rep['finished_requests']} finished requests",
        f"{'kind':<12} {'steps':>6} {'fed':>7} {'commit':>7} "
        f"{'analytic(s)':>12} {'simulated(s)':>13} {'ana/sim':>8}",
    ]
    for kind, t in rep["by_kind"].items():
        lines.append(
            f"{kind:<12} {t['steps']:>6d} {t['fed_tokens']:>7d} "
            f"{t['committed_tokens']:>7d} {t['analytic_s']:>12.4g} "
            f"{t['simulated_s']:>13.4g} "
            f"{t['analytic_over_simulated']:>8.2f}")
    lines.append(
        f"{'TOTAL':<12} {rep['steps']:>6d} {'':>7} "
        f"{rep['committed_tokens']:>7d} {rep['analytic_s']:>12.4g} "
        f"{rep['simulated_s']:>13.4g} "
        f"{(rep['analytic_s'] / rep['simulated_s']) if rep['simulated_s'] else float('nan'):>8.2f}")
    lines.append(
        f"[replay] simulated {rep['simulated_tokens_per_s']:.0f} tok/s, "
        f"{rep['simulated_fps']:.2f} req/s (FPS), "
        f"{rep['simulated_power_w']:.2f} W modeled")
    ho = rep.get("handoff") or {}
    if ho.get("handoffs_in") or ho.get("handoffs_out"):
        lines.append(
            f"[replay] role={rep.get('role', 'mixed')} handoffs: "
            f"{ho['handoffs_out']} out / {ho['handoffs_in']} in, "
            f"{ho['bytes_in']} B in at {ho['link_gbps']:g} Gb/s -> "
            f"{ho['modeled_transfer_s'] * 1e3:.3f} ms modeled transfer "
            f"({ho['exposed_transfer_s'] * 1e3:.3f} ms exposed past "
            f"decode overlap)")
    curve = rep.get("decode_batch_curve") or {}
    if curve:
        pts = "  ".join(
            f"B={b}: {v['token_latency_s'] * 1e9:.0f} ns/tok"
            for b, v in curve.items())
        lines.append(f"[replay] batched decode cost curve: {pts}")
    return "\n".join(lines)
