"""The engine's step functions, for the mixed worker role.

The JAX package splits serving onto ``mixed``, ``prefill`` and
``decode`` workers; this slice runs the ``mixed`` role only — one
worker interleaves chunked prefill into its decode batch
(``EngineConfig.role`` refuses the others until the serving-breadth
slice, ROADMAP.md queue 1, item 7).

``build_step_fns`` builds the prefill and decode closures.  Where the
JAX package jitted them and donated the pools, these are plain torch
callables that update the pools IN PLACE (``attn_block.scatter_blocks``,
the slot writes of ``mamba2``) and select the next token on the device,
next to the logits.
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


def build_step_fns(cfg, *, ring: bool = False) -> StepFns:
    """Construct the prefill/decode closures of a mixed-role worker;
    ``cfg`` and ``ring`` (the block tables are sliding-window rings) are
    baked in, params, pools and the per-step arrays (block table,
    lengths, recurrent slots) stay arguments.  Each returns (next tokens
    (B,), logits, pools)."""

    @torch.no_grad()
    def _prefill(params, pools, tokens, table, lengths, n_valid, slots):
        logits, pools = M.prefill_chunk(params, cfg, tokens, pools, table,
                                        lengths, n_valid, slots, ring=ring)
        # chunk-final logits row -> the would-be next token (used by
        # the engine only when this chunk completes the prompt)
        last = (n_valid.long() - 1).clamp_min(0)
        rows = torch.arange(logits.shape[0], device=logits.device)
        return sample_tokens(logits[rows, last]), logits, pools

    @torch.no_grad()
    def _decode(params, pools, tokens, table, lengths, active, slots):
        logits, pools = M.paged_decode_step(params, cfg, tokens, pools,
                                            table, lengths, active, slots,
                                            ring=ring)
        return sample_tokens(logits[:, -1]), logits, pools

    return StepFns(prefill=_prefill, decode=_decode)
