"""The engine's step functions, for the mixed worker role.

The JAX package splits serving onto ``mixed``, ``prefill`` and
``decode`` workers; the port runs the ``mixed`` role only — one worker
interleaves chunked prefill into its decode batch (``EngineConfig.role``
refuses the others, ROADMAP.md queue 1, item 7, "Worker roles").

``build_step_fns`` builds the prefill and decode closures.  Where the
JAX package jitted them and donated the pools, these are plain torch
callables that update the pools IN PLACE (``attn_block.scatter_blocks``,
the slot writes of ``mamba2``) and select the next token on the device,
next to the logits, from the per-row sampling operands
(``sampling.sampling_rows``; four ``None`` when every row is greedy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import transformer as M
from repro_torch.serving.sampling import sample_tokens


@dataclass(frozen=True)
class StepFns:
    """The engine's step closures."""
    prefill: Callable
    decode: Callable


def build_step_fns(cfg, *, ring: bool = False, impl: str = "auto"
                   ) -> StepFns:
    """Construct the prefill/decode closures of a mixed-role worker;
    ``cfg``, ``ring`` (the block tables are sliding-window rings) and
    the kernels' ``impl`` (``kernels/ops.resolve_impl``) are baked in;
    params, pools and the per-step arrays (block table, lengths,
    recurrent slots, the sampling operands) stay arguments.
    Each returns (next tokens (B,), logits, pools); the token at
    absolute position i is drawn from its (seed, i) stream, as in the
    JAX package."""

    @torch.no_grad()
    def _prefill(params, pools, tokens, table, lengths, n_valid, slots,
                 seeds=None, temps=None, top_k=None, top_p=None):
        logits, pools = M.prefill_chunk(params, cfg, tokens, pools, table,
                                        lengths, n_valid, slots, ring=ring,
                                        impl=impl)
        # chunk-final logits row -> the would-be next token (used by
        # the engine only when this chunk completes the prompt)
        last = (n_valid.long() - 1).clamp_min(0)
        rows = torch.arange(logits.shape[0], device=logits.device)
        tok = sample_tokens(logits[rows, last], lengths + n_valid, seeds,
                            temps, top_k, top_p)
        return tok, logits, pools

    @torch.no_grad()
    def _decode(params, pools, tokens, table, lengths, active, slots,
                seeds=None, temps=None, top_k=None, top_p=None):
        logits, pools = M.paged_decode_step(params, cfg, tokens, pools,
                                            table, lengths, active, slots,
                                            ring=ring, impl=impl)
        tok = sample_tokens(logits[:, -1], lengths + 1, seeds, temps,
                            top_k, top_p)
        return tok, logits, pools

    return StepFns(prefill=_prefill, decode=_decode)
