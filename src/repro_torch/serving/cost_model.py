"""Photonic cost-model hook: modeled OXBNN latency for one decode token.

Maps every GEMM of one decode step — attention projections, MLA latent
down/up-projections, and mamba2 SSD chunk matmuls (state write +
readout contractions) — onto the paper's XPC mapping (an FC layer:
S = fan-in, V = fan-out; see photonic/workloads.LayerSpec) and queries
the transaction-level simulator (photonic/simulator.simulate_layer)
for per-GEMM latency, so ``modeled_tokens_per_s`` is reported for every
paged arch family, not just GQA stacks.
The engine reports the resulting modeled accelerator tokens/s next to
wall-clock tokens/s, so scheduling decisions can be judged against the
paper's hardware rather than the device that serves the tokens.  These
are modelled numbers of the photonic accelerator, not measurements.

The accelerator processes one request at a time (the paper simulates
batch 1, layers in sequence), so a decode step over B rows is modeled
as B sequential tokens — continuous batching raises utilization, not
single-token latency.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.models.transformer import layer_plan
from repro_torch.photonic import accelerators
from repro_torch.photonic import params as P
from repro_torch.photonic.simulator import SimKnobs, simulate_layer
from repro_torch.photonic.workloads import LayerSpec, fc


def gemm_specs(cfg) -> list[LayerSpec]:
    """Per-token GEMMs of one decode step, as photonic FC LayerSpecs.

    Every mixer family maps onto the XPC datapath:
      * gqa — the four projection GEMMs;
      * mla — q (or its low-rank pair), the latent down-projection and
        the k/v up-projections that re-expand one token's latent, plus
        the output projection;
      * ssm — in/out projections, the depthwise conv tail (S = kernel
        taps per channel), and the two SSD recurrence matmuls of one
        token: the state write dt*(B (x) x) and the readout C . h, each
        an ssm_state-length contraction per (head, headdim) output.
    """
    specs: list[LayerSpec] = []
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for i, (mix, f) in enumerate(layer_plan(cfg)):
        if mix == "gqa":
            specs += [fc(f"l{i}.q", d, h * dh), fc(f"l{i}.k", d, hkv * dh),
                      fc(f"l{i}.v", d, hkv * dh), fc(f"l{i}.o", h * dh, d)]
        elif mix == "mla":
            qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            if cfg.q_lora_rank:
                specs += [fc(f"l{i}.q_down", d, cfg.q_lora_rank),
                          fc(f"l{i}.q_up", cfg.q_lora_rank, h * qk_head)]
            else:
                specs.append(fc(f"l{i}.q", d, h * qk_head))
            specs += [
                fc(f"l{i}.kv_down", d,
                   cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                fc(f"l{i}.k_up", cfg.kv_lora_rank, h * cfg.qk_nope_head_dim),
                fc(f"l{i}.v_up", cfg.kv_lora_rank, h * cfg.v_head_dim),
                fc(f"l{i}.o", h * cfg.v_head_dim, d)]
        elif mix == "ssm":
            d_inner = cfg.ssm_expand * d
            nh = d_inner // cfg.ssm_headdim
            conv_ch = d_inner + 2 * cfg.ssm_state
            specs += [
                fc(f"l{i}.in_proj", d, 2 * d_inner + 2 * cfg.ssm_state + nh),
                fc(f"l{i}.conv", cfg.ssm_conv, conv_ch),
                fc(f"l{i}.ssd_state", cfg.ssm_state, d_inner),
                fc(f"l{i}.ssd_out", cfg.ssm_state, d_inner),
                fc(f"l{i}.out_proj", d_inner, d)]
        if f in ("dense", "moe"):
            if f == "moe":
                # router + the ACTIVE experts a token actually traverses
                specs.append(fc(f"l{i}.router", d, cfg.n_experts))
                ff = cfg.moe_d_ff or cfg.d_ff
                n_mlps = cfg.top_k + cfg.n_shared_experts
            else:
                ff = cfg.d_ff
                n_mlps = 1
            for e in range(n_mlps):
                tag = f"l{i}.e{e}" if f == "moe" else f"l{i}"
                if cfg.act in ("swiglu", "geglu"):
                    specs += [fc(f"{tag}.gate", d, ff), fc(f"{tag}.up", d, ff)]
                else:
                    specs += [fc(f"{tag}.up", d, ff)]
                specs.append(fc(f"{tag}.down", ff, d))
    specs.append(fc("head", d, cfg.vocab))
    return specs


@dataclass(frozen=True)
class TokenCost:
    latency_s: float
    energy_j: float
    bottleneck: str      # dominant stage across GEMMs (by summed time)


class PhotonicCostModel:
    """Per-layer latencies for one arch on one accelerator config."""

    def __init__(self, cfg, accelerator: str = "OXBNN_50",
                 knobs: SimKnobs = SimKnobs(), *, fused_bnn: bool = True,
                 link_gbps: float = 100.0):
        self.cfg = cfg
        self.acc = accelerators.by_name(accelerator)
        self.knobs = knobs
        self.fused_bnn = fused_bnn
        self.link_gbps = link_gbps
        self.specs = gemm_specs(cfg)
        self.layers = [simulate_layer(self.acc, s, knobs)
                       for s in self.specs]
        # Fused chain (kernels/fused_bnn.py): the PCA comparator output
        # feeds the next layer's OXG operand drive directly, so packed
        # activations never round-trip through eDRAM between GEMMs.
        # Unfused, every GEMM's S-bit operand is written back and read
        # again — one store + one load of ceil(S/32) words through the
        # IO interface, each paying the eDRAM access latency.
        io_rate = knobs.io_words_per_cycle_per_tile * self.acc.num_tiles
        self.pack_pass_s_per_token = 0.0 if fused_bnn else sum(
            2 * math.ceil(math.ceil(s.s / 32) / io_rate) * P.EDRAM.latency_s
            for s in self.specs)

    @property
    def token_cost(self) -> TokenCost:
        lat = (sum(l.latency_s for l in self.layers)
               + self.pack_pass_s_per_token)
        en = sum(l.energy_j for l in self.layers)
        by_stage: dict[str, float] = {}
        for l in self.layers:
            for s in l.stages:
                by_stage[s.name] = by_stage.get(s.name, 0.0) + s.time_s
        if self.pack_pass_s_per_token:
            by_stage["pack"] = self.pack_pass_s_per_token
        return TokenCost(lat, en, max(by_stage, key=by_stage.get))

    @property
    def token_latency_s(self) -> float:
        return self.token_cost.latency_s

    @property
    def modeled_tokens_per_s(self) -> float:
        return 1.0 / self.token_latency_s

    def step_latency_s(self, n_tokens: int) -> float:
        """Batch-1-sequential accelerator: B rows = B tokens back-to-back."""
        return n_tokens * self.token_latency_s

    # -------------------------------------------- prefill->decode handoff

    def transfer_latency_s(self, n_bytes: int) -> float:
        """Modeled time to stream one handoff's serialized state (KV
        block tails + recurrent snapshots + the token ids) over the
        inter-shard link at ``link_gbps`` — the explicit transfer stage
        of a disaggregated prefill->decode topology.  The destination
        overlaps it with its own decode steps (``transfer_steps_overlap``
        converts it to a step count for the admission gate)."""
        return n_bytes * 8.0 / (self.link_gbps * 1e9)

    def transfer_steps_overlap(self, n_bytes: int, *,
                               max_steps: int = 256) -> int:
        """Destination decode steps the modeled transfer overlaps: the
        link streams while the decode batch keeps stepping, so the
        request parks for ceil(transfer / token_latency) steps (at
        least 1 — the handoff is never free — and clamped so a modeled
        slow link cannot park a request forever)."""
        steps = math.ceil(self.transfer_latency_s(n_bytes)
                          / self.token_latency_s)
        return max(1, min(steps, max_steps))

    def handoff_report(self, *, handoffs: int, handoff_bytes: int) -> dict:
        """Transfer-stage summary for ``stats()``/replay: total modeled
        link time and the per-handoff mean, next to the bandwidth it
        was priced at."""
        total_s = self.transfer_latency_s(handoff_bytes)
        return {
            "handoffs": handoffs,
            "handoff_bytes": handoff_bytes,
            "link_gbps": self.link_gbps,
            "modeled_transfer_s": total_s,
            "modeled_transfer_ms_per_handoff": (
                total_s / handoffs * 1e3 if handoffs else 0.0),
        }

    # --------------------------------------------------- speculative decode

    @property
    def pipeline_interval_s(self) -> float:
        """Summed per-layer bottleneck-stage time: the marginal cost of
        streaming ONE MORE token through the weight-stationary XPC/PCA
        pipeline (every layer's fills are already paid).  The unfused
        pack round-trip is serial with the stream — each extra token's
        packed activations still traverse eDRAM — so it rides the
        marginal interval, not the one-time fill."""
        return (sum(max(s.time_s for s in l.stages) for l in self.layers)
                + self.pack_pass_s_per_token)

    @property
    def fill_s(self) -> float:
        """Summed per-layer pipeline fill/drain — paid once per pass
        over the layer stack, however many tokens stream through."""
        return sum(l.latency_s - max(s.time_s for s in l.stages)
                   for l in self.layers)

    def verify_latency_s(self, n_tokens: int) -> float:
        """Modeled latency of ONE multi-token verify pass: n tokens
        stream through each layer's pipelined stages back-to-back, so
        each layer costs n bottleneck intervals plus one fill — the
        simulator's own per-layer model (latency = max stage + fill)
        extended from 1 to n transactions.  This is why speculative
        decoding pays off on the paper's batch-1 accelerator: verifying
        k+1 tokens costs little more than one."""
        return n_tokens * self.pipeline_interval_s + self.fill_s

    def speculative_report(self, *, verify_passes: int, verify_tokens: int,
                           committed_tokens: int) -> dict:
        """Modeled accelerator speedup of the served speculative
        stream: committed tokens decoded sequentially vs the verify
        passes that actually produced them.  ``verify_passes`` counts
        per-ROW passes — the batch-1 accelerator streams each row
        through the layer stack separately, so every row pays its own
        pipeline fills (a no-draft pass then costs exactly one token
        and the speedup degenerates to 1.0, as it should)."""
        if verify_passes <= 0 or committed_tokens <= 0:
            return {"modeled_spec_speedup": 1.0}
        spent = (verify_tokens * self.pipeline_interval_s
                 + verify_passes * self.fill_s)
        return {
            "modeled_spec_speedup":
                committed_tokens * self.token_latency_s / spent,
        }

    def scoring_report(self, *, score_tokens: int,
                       score_passes: int) -> dict:
        """Modeled accelerator cost of the teacher-forced scoring
        workload.  Scoring IS chunked prefill — no decode loop ever
        runs — so each pass is priced exactly like a prefill pass:
        chunk tokens through the weight-stationary pipeline plus one
        fill (``prefill_latency_s``).  Reported separately from the
        serving totals so a mixed trace can see what the scoring share
        alone would sustain."""
        if score_tokens <= 0:
            return {"modeled_scoring_tokens_per_s": 0.0,
                    "modeled_scoring_wall_s": 0.0}
        wall = self.prefill_latency_s(score_tokens, max(score_passes, 1))
        return {"modeled_scoring_tokens_per_s": score_tokens / wall,
                "modeled_scoring_wall_s": wall}

    def prefill_latency_s(self, n_tokens: int, n_passes: int) -> float:
        """Modeled latency of chunked prefill: n tokens streamed
        through the weight-stationary pipeline in n_passes chunk-sized
        forwards — n bottleneck intervals plus one fill per pass, the
        SAME accounting ``verify_latency_s`` applies to the identical
        prefill-shaped forward (one pass of n tokens ==
        ``verify_latency_s(n)``).  The old model charged every prefill
        token a full sequential token latency, so the prefill and
        verify sides of the report disagreed about the same GEMMs.

        Skipped-prefix credit applies per token regardless of family:
        a prompt token adopted from the block index skipped its
        attention projections, one resumed from a slot snapshot skipped
        its SSD chunk matmuls — both are whole rows of ``gemm_specs``
        that never ran."""
        return n_tokens * self.pipeline_interval_s + n_passes * self.fill_s

    def serving_report(self, *, prefill_tokens: int, decode_tokens: int,
                       skipped_tokens: int = 0,
                       prefill_passes: int | None = None,
                       prefill_chunk: int = 16) -> dict:
        """Modeled accelerator cost of a served token stream: decode
        tokens are sequential (batch-1 accelerator), prefill tokens are
        pipelined per chunk pass (``prefill_latency_s``).  Prompt
        tokens adopted from the prefix cache never ran their GEMMs, so
        they cost nothing on the modeled OXBNN either — the effective
        rate credits them as served, and ``prefill_skip_speedup`` is
        the wall ratio against prefilling them in full chunks."""
        chunk = max(prefill_chunk, 1)
        if prefill_passes is None:
            prefill_passes = -(-prefill_tokens // chunk)
        computed = prefill_tokens + decode_tokens
        wall = (self.step_latency_s(decode_tokens)
                + self.prefill_latency_s(prefill_tokens, prefill_passes))
        # counterfactual: the skipped prompt tokens prefilled in chunks.
        # Extra fills are FLOOR(skipped / chunk): a partial-chunk
        # remainder merges into the request's first real prefill pass,
        # which ``prefill_passes`` already charges — exact for
        # slot-snapshot skips (always chunk-grid multiples), a
        # non-inflating lower bound for block-aligned attn skips.
        wall_no_skip = wall + self.prefill_latency_s(
            skipped_tokens, skipped_tokens // chunk)
        return {
            "modeled_wall_s": wall,
            "modeled_tokens_per_s": self.modeled_tokens_per_s,
            "modeled_effective_tokens_per_s": (
                (computed + skipped_tokens) / wall if wall
                else self.modeled_tokens_per_s),
            "prefill_skip_speedup": wall_no_skip / wall if wall else 1.0,
        }

    def report(self) -> dict:
        tc = self.token_cost
        return {
            "accelerator": self.acc.name,
            "arch": self.cfg.name,
            "token_latency_s": tc.latency_s,
            "modeled_tokens_per_s": 1.0 / tc.latency_s,
            "token_energy_j": tc.energy_j,
            "bottleneck_stage": tc.bottleneck,
            "n_gemms": len(self.layers),
            "fused_bnn": self.fused_bnn,
            "pack_pass_s_per_token": self.pack_pass_s_per_token,
        }
