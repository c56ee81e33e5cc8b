"""The engine's step functions, for the mixed worker role.

The JAX package splits serving onto ``mixed``, ``prefill`` and
``decode`` workers; the port runs the ``mixed`` role only — one worker
interleaves chunked prefill into its decode batch (``EngineConfig.role``
refuses the others, ROADMAP.md queue 1, item 7, "Worker roles").

``build_step_fns`` builds the prefill and decode closures, and with
``spec_k > 0`` the speculative verify and repair closures.  Where the
JAX package jitted them and donated the pools, these are plain torch
callables that update the pools IN PLACE (``attn_block.scatter_blocks``,
the slot writes of ``mamba2``) and select the next token on the device,
next to the logits, from the per-row sampling operands
(``sampling.sampling_rows``; four ``None`` when every row is greedy).
Because the verify step writes the pools in place, its slot snapshots
(``transformer.snapshot_slot_state``) are copies, taken before it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import transformer as M
from repro_torch.serving.sampling import sample_tokens


@dataclass(frozen=True)
class StepFns:
    """The engine's step closures (``spec``/``repair`` only when
    ``spec_k > 0``)."""
    prefill: Callable
    decode: Callable
    spec: Callable | None = None
    repair: Callable | None = None


def build_step_fns(cfg, *, ring: bool = False, impl: str = "auto",
                   spec_k: int = 0) -> StepFns:
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

    if not spec_k:
        return StepFns(prefill=_prefill, decode=_decode)

    @torch.no_grad()
    def _spec(params, pools, tokens, table, lengths, n_valid, slots, draft,
              seeds=None, temps=None, top_k=None, top_p=None):
        b, c = tokens.shape
        logits, pools, snaps = M.spec_verify(params, cfg, tokens, pools,
                                             table, lengths, n_valid, slots,
                                             ring=ring, impl=impl)
        # sample EVERY position with its own (seed, index) key: what
        # plain decoding would draw there
        idx = (lengths.long()[:, None] + 1
               + torch.arange(c, device=tokens.device)[None, :])
        rep = (lambda a: None if a is None
               else torch.repeat_interleave(a, c))
        sampled = sample_tokens(logits.reshape(b * c, -1), idx.reshape(-1),
                                rep(seeds), rep(temps), rep(top_k),
                                rep(top_p)).reshape(b, c)
        # the accepted draft prefix: position j counts while the
        # verifier's token agrees with the draft's
        j = torch.arange(c - 1, device=tokens.device)[None, :]
        ok = (sampled[:, :-1] == draft) & (j < (n_valid.long() - 1)[:, None])
        acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        n_commit = torch.where(n_valid > 0, acc + 1, 0)
        return sampled, n_commit, pools, snaps

    @torch.no_grad()
    def _repair(params, pools, tokens, table, lengths, n_commit, slots,
                snaps):
        # SSM rollback of partly accepted rows: restore the slots as
        # they were before the verify, then re-advance every row by
        # exactly its committed prefix (the masked prefill writes the
        # same K/V into the block layers again)
        M.restore_slot_state(cfg, pools, slots, snaps)
        M.prefill_chunk(params, cfg, tokens, pools, table, lengths,
                        n_commit.to(torch.int32), slots, ring=ring,
                        impl=impl)
        return pools

    return StepFns(prefill=_prefill, decode=_decode, spec=_spec,
                   repair=_repair)
