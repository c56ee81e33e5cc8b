"""Worker roles for disaggregated prefill/decode serving, and the
engine's step functions.

Production serving splits the two phases of a request's life onto
different workers: prefill is a long batched pipeline fill, decode a
latency-bound steady state.  The roles, as in the JAX package:

  * ``mixed``   — one worker interleaves chunked prefill into its
                  decode batch.  The default everywhere, and the
                  correctness oracle;
  * ``prefill`` — runs chunked prefill ONLY.  A prompt that completes
                  emits its first token locally, then parks for handoff:
                  the ``ShardedEngine`` (serving/sharded.py) moves its
                  blocks and recurrent state to a decode shard over the
                  content-hash swap-to-peer path;
  * ``decode``  — runs the full datapath (prompts rescued from a dead
                  prefill shard recompute here), but the placement plane
                  never routes a fresh prompt to it while a prefill
                  shard is alive.

A role is a set of behaviour flags, not a subclass: it gates which plan
rows run and whether finished prefills park.  Sampling keys are a pure
function of (seed, position) and a handoff rides the swap serialization,
so any topology gives the mixed oracle's tokens.

Transfer accounting: a handoff moves ``host_bytes(req)`` over the
modelled inter-shard link; the destination's scheduler keeps the
request parked (defer reason ``transfer_pending``) until the modelled
transfer has overlapped ``req.transfer_steps`` of its steps.

``build_step_fns`` builds the prefill closure, and on a decode-capable
role the decode closure, and with ``spec_k > 0`` the speculative verify
and repair closures.  Where the JAX package jitted them and donated the
pools, these are plain torch callables that update the pools IN PLACE
(``attn_block.scatter_blocks``, the slot writes of ``mamba2``) and
select the next token on the device, next to the logits, from the
per-row sampling operands (``sampling.sampling_rows``; four ``None``
when every row is greedy).  Because the verify step writes the pools in
place, its slot snapshots (``transformer.snapshot_slot_state``) are
copies, taken before it.

Over a mesh (the engine's ``mesh=``) the closures run the model under
the sharding context of the mesh's decode rules and sample from the logits
gathered whole, so every rank draws the same tokens.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.dist import sharding as S, spmd
from repro_torch.layers import common as C
from repro_torch.models import transformer as M
from repro_torch.serving.sampling import sample_tokens


@dataclass(frozen=True)
class Role:
    """Behaviour flags of one worker role (see the module docstring)."""
    name: str
    runs_decode: bool      # decode / spec-verify plan rows run here
    hands_off: bool        # completed prefills park for peer handoff


MIXED = Role("mixed", runs_decode=True, hands_off=False)
PREFILL = Role("prefill", runs_decode=False, hands_off=True)
DECODE = Role("decode", runs_decode=True, hands_off=False)

ROLES = {r.name: r for r in (MIXED, PREFILL, DECODE)}


def get_role(name: str) -> Role:
    try:
        return ROLES[name]
    except KeyError:
        raise ValueError(
            f"unknown role {name!r}; expected one of {sorted(ROLES)}") \
            from None


def parse_roles(spec: str, n_shards: int | None = None) -> list[str]:
    """A topology spec as a per-shard role list: ``"P:D"`` counts
    (``"1:2"`` = one prefill shard and two decode shards) or
    comma-separated names (``"prefill,decode,decode"``).  Checked
    against ``n_shards`` when given; at least one shard must decode."""
    spec = spec.strip()
    if ":" in spec and "," not in spec:
        p_s, d_s = spec.split(":", 1)
        p, d = int(p_s), int(d_s)
        if p < 0 or d < 1:
            raise ValueError(
                f"roles spec {spec!r}: need >= 0 prefill and >= 1 "
                "decode shards")
        roles = ["prefill"] * p + ["decode"] * d
    else:
        roles = [r.strip() for r in spec.split(",") if r.strip()]
    validate_roles(roles, n_shards)
    return roles


def validate_roles(roles: list[str], n_shards: int | None = None):
    for r in roles:
        get_role(r)
    if not any(get_role(r).runs_decode for r in roles):
        raise ValueError(
            f"role topology {roles} has no decode-capable shard — "
            "nothing could ever finish a request")
    if n_shards is not None and len(roles) != n_shards:
        raise ValueError(
            f"{len(roles)} roles for {n_shards} shards: {roles}")


# ------------------------------------------------------------- transfer

def host_bytes(req) -> int:
    """Bytes a handoff or migration of ``req`` moves over the
    inter-shard link: the host copies ``swap_out`` made (the KV blocks'
    tail and the recurrent slot; content the destination already holds
    by hash was not copied) plus the token stream itself."""
    n = req.prompt.nbytes + 4 * len(req.out)
    for bufs in (req.host_kv, req.host_state):
        for layer in bufs or ():
            if layer is None:
                continue
            for arr in (layer.values() if hasattr(layer, "values")
                        else layer):
                if arr is not None and hasattr(arr, "nbytes"):
                    n += arr.nbytes
    return n


def transfer_pending(req, step: int) -> bool:
    """The admission-side transfer gate: True while ``req`` is still
    streaming over the modelled link (the destination's scheduler
    defers it as ``transfer_pending``); once ``step`` reaches the
    arrival deadline it clears the marks and returns False."""
    until = getattr(req, "transfer_until_step", None)
    if until is None:
        return False
    if step < until:
        return True
    req.transfer_until_step = None
    req.transfer_steps = 0
    return False


# ------------------------------------------------------- step closures

@dataclass(frozen=True)
class StepFns:
    """The engine's step closures, built per role: a prefill worker
    gets only ``prefill``; ``spec``/``repair`` only when
    ``spec_k > 0``."""
    prefill: Callable
    decode: Callable | None = None
    spec: Callable | None = None
    repair: Callable | None = None


def build_step_fns(cfg, *, ring: bool = False, impl: str = "auto",
                   attn_impl: str | None = None, spec_k: int = 0,
                   role: Role = MIXED, mesh=None) -> StepFns:
    """Construct the step closures of one worker of ``role``;
    ``cfg``, ``ring`` (the block tables are sliding-window rings), the
    BNN GEMMs' ``impl`` and the paged attention's ``attn_impl``
    (``None``: ``impl``; both ``kernels/ops.resolve_impl``) are baked
    in, as the JAX package's engine bakes in ``bnn_impl`` and
    ``attn_impl``;
    params, pools and the per-step arrays (block table, lengths,
    recurrent slots, the sampling operands) stay arguments.
    Each returns (next tokens (B,), logits, pools); the token at
    absolute position i is drawn from its (seed, i) stream, as in the
    JAX package.  With ``mesh`` the model runs under the sharding
    context of its decode rules and the logits returned are gathered
    whole."""
    def sharded():
        return (C.sharding_context(mesh, S.decode_rules_of(mesh))
                if mesh is not None else contextlib.nullcontext())

    @torch.no_grad()
    def _prefill(params, pools, tokens, table, lengths, n_valid, slots,
                 seeds=None, temps=None, top_k=None, top_p=None):
        with sharded():
            logits, pools = M.prefill_chunk(
                params, cfg, tokens, pools, table, lengths, n_valid, slots,
                ring=ring, impl=impl, attn_impl=attn_impl)
        logits = spmd.full(logits)
        # chunk-final logits row -> the would-be next token (used by
        # the engine only when this chunk completes the prompt)
        last = (n_valid.long() - 1).clamp_min(0)
        rows = torch.arange(logits.shape[0], device=logits.device)
        tok = sample_tokens(logits[rows, last], lengths + n_valid, seeds,
                            temps, top_k, top_p)
        return tok, logits, pools

    if not role.runs_decode:
        return StepFns(prefill=_prefill)

    @torch.no_grad()
    def _decode(params, pools, tokens, table, lengths, active, slots,
                seeds=None, temps=None, top_k=None, top_p=None):
        with sharded():
            logits, pools = M.paged_decode_step(
                params, cfg, tokens, pools, table, lengths, active, slots,
                ring=ring, impl=impl, attn_impl=attn_impl)
        logits = spmd.full(logits)
        tok = sample_tokens(logits[:, -1], lengths + 1, seeds, temps,
                            top_k, top_p)
        return tok, logits, pools

    if not spec_k:
        return StepFns(prefill=_prefill, decode=_decode)

    @torch.no_grad()
    def _spec(params, pools, tokens, table, lengths, n_valid, slots, draft,
              seeds=None, temps=None, top_k=None, top_p=None):
        b, c = tokens.shape
        with sharded():
            logits, pools, snaps = M.spec_verify(
                params, cfg, tokens, pools, table, lengths, n_valid, slots,
                ring=ring, impl=impl, attn_impl=attn_impl)
        logits = spmd.full(logits)
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
        with sharded():
            M.prefill_chunk(params, cfg, tokens, pools, table, lengths,
                            n_commit.to(torch.int32), slots, ring=ring,
                            impl=impl, attn_impl=attn_impl)
        return pools

    return StepFns(prefill=_prefill, decode=_decode, spec=_spec,
                   repair=_repair)
