"""Decoder LM: GQA (optionally sliding-window) or MLA attention, or the
Mamba-2 SSD mixer, then a GLU FFN, a MoE FFN or none, per layer.

Families this port runs (``check_supported``):
  dense   GQA attention + GLU FFN                    (bnn-lm-100m, llama,
                                                      qwen, gemma)
  moe     GQA + sliding window (ring caches) + MoE   (mixtral)
          MLA + MoE with shared experts, leading
          dense layers of width ``dense_d_ff``        (deepseek-v2-lite)
  ssm     Mamba-2 SSD mixer over recurrent slots,
          no FFN                                     (mamba2)
  hybrid  SSD layers over recurrent slots, one GQA
          layer over paged blocks per
          ``attn_period``, MoE every ``moe_every``
          layers, a dense FFN on the others           (jamba)

Parameters are a plain dict: ``embed``, ``final_norm``, ``head`` (tied
to ``embed.w.T`` when ``cfg.tie_embeddings``) and ``layers``, a list of
per-layer dicts in plan order (``norm1``, ``attn`` (the mixer, the SSD
block's too, as in the JAX package), ``norm2``, ``ffn``).
The JAX package stacks the repeated layer period along a leading axis
for ``lax.scan``; the port keeps one dict per layer, which is what its
eager layer loop walks (``interop.params_from_numpy`` unstacks).

Every projection dispatches through the OXBNN precision modes
(kernels/ops.bnn_dense, ops.expert_dense): bf16 baseline and bnn
(packed XNOR-popcount inference).  The modality front-ends (musicgen,
pixtral) are not ported yet (ROADMAP.md queue 1, item 6).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers import attn_block, common as C, ffn, mamba2, mla, moe

# ---------------------------------------------------------------------------
# layer plan


def layer_plan(cfg: ArchConfig) -> list[tuple[str, str]]:
    """Per-layer (mixer, ffn) kinds."""
    plan = []
    for i in range(cfg.n_layers):
        if cfg.attn_kind == "none":
            mix = "ssm"
        elif cfg.attn_period:
            mix = "gqa" if i % cfg.attn_period == cfg.attn_offset else "ssm"
        else:
            mix = cfg.attn_kind
        if cfg.n_experts and i >= cfg.first_dense and \
                i % max(cfg.moe_every, 1) == max(cfg.moe_every, 1) - 1:
            f = "moe"
        elif cfg.d_ff or (i < cfg.first_dense and cfg.dense_d_ff):
            f = "dense"
        else:
            f = "none"
        plan.append((mix, f))
    return plan


def segments(cfg: ArchConfig):
    """[('unroll', plan_prefix, 1)] + [('scan', period_plan, n_groups)]:
    the JAX package's parameter layout, which ``interop`` unstacks."""
    plan = layer_plan(cfg)
    segs = []
    i = cfg.first_dense
    if i:
        segs.append(("unroll", plan[:i], 1))
    rest = plan[i:]
    p = cfg.scan_period
    if len(rest) % p:
        raise ValueError(f"{cfg.name}: scan_period {p} does not tile "
                         f"{len(rest)} layers")
    period = rest[:p]
    for j in range(0, len(rest), p):
        if rest[j:j + p] != period:
            raise ValueError("scan_period does not tile the plan")
    segs.append(("scan", period, len(rest) // p))
    return segs


def check_supported(cfg: ArchConfig):
    """Raise for what the port does not run yet: the modality
    front-ends."""
    for mix, f in layer_plan(cfg):
        if mix not in ("gqa", "mla", "ssm") or \
                f not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer kind ({mix}, {f}) is not ported")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.frontend} front-end is not ported "
            "(ROADMAP.md queue 1, item 6)")


# ---------------------------------------------------------------------------
# init


def _init_layer(gen, cfg: ArchConfig, mix: str, f: str, dense_width: bool,
                device) -> dict:
    """One layer; ``dense_width`` marks the leading dense layers, whose
    FFN is ``dense_d_ff`` wide where the config sets one."""
    mod = {"mla": mla, "ssm": mamba2}.get(mix, attn_block)
    p = {"norm1": C.norm_init(cfg.d_model, cfg.norm, device=device),
         "attn": mod.init(gen, cfg, device=device)}
    if f != "none":
        p["norm2"] = C.norm_init(cfg.d_model, cfg.norm, device=device)
    if f == "dense":
        width = cfg.dense_d_ff if (dense_width and cfg.dense_d_ff) \
            else cfg.d_ff
        p["ffn"] = ffn.init(gen, cfg.d_model, width, cfg.act, device=device)
    elif f == "moe":
        p["ffn"] = moe.init(gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                            cfg.n_experts, cfg.act,
                            n_shared=cfg.n_shared_experts,
                            shared_d_ff=cfg.moe_d_ff or cfg.d_ff,
                            device=device)
    return p


def init(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """Random parameters drawn from ``gen`` (its device must match
    ``device``).  Same distributions as the JAX package's init, not the
    same numbers: for parity, convert JAX weights with ``interop``."""
    check_supported(cfg)
    params = {"embed": C.embed_init(gen, cfg.vocab, cfg.d_model,
                                    device=device),
              "final_norm": C.norm_init(cfg.d_model, cfg.norm, device=device)}
    params["head"] = ({"w": params["embed"]["w"].t()} if cfg.tie_embeddings
                      else C.dense_init(gen, cfg.d_model, cfg.vocab,
                                        device=device))
    params["layers"] = [_init_layer(gen, cfg, mix, f, i < cfg.first_dense,
                                    device)
                        for i, (mix, f) in enumerate(layer_plan(cfg))]
    return params


def _iter_layers(cfg: ArchConfig, params):
    """Yield (mix, ffn_kind, layer_params) in plan order."""
    for (mix, f), p in zip(layer_plan(cfg), params["layers"], strict=True):
        yield mix, f, p


def _ffn(params, cfg: ArchConfig, f: str, x, impl, *, paged: bool,
         taps=None):
    """The layer's FFN with its residual, after any mixer (an SSD
    layer's too).  A MoE layer dispatches with the config's finite
    capacity over a full sequence, as the JAX package does, and
    drop-free on the serving path (``paged``): a finite capacity would
    let batch composition, padding and the chunk width decide which
    tokens keep their experts (in the JAX package it made jamba's
    logits depend on the chunk width)."""
    if f == "none":
        return x
    h = C.norm(x, params["norm2"], cfg.norm, cfg.norm_eps)
    if f == "moe":
        y, _aux = moe.forward(
            params["ffn"], h, top_k=cfg.top_k, kind=cfg.act,
            capacity_factor=0.0 if paged else cfg.capacity_factor,
            precision=cfg.precision,
            dispatch_groups=1 if paged else cfg.moe_dispatch_groups,
            impl=impl, taps=taps)
    else:
        y = ffn.forward(params["ffn"], h, cfg.act, cfg.precision, impl, taps)
    return x + y


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["w"][tokens]
    if cfg.embed_scale:
        x = x * (cfg.d_model ** 0.5)
    return x


# ---------------------------------------------------------------------------
# full forward


def hidden_states(params, cfg: ArchConfig, tokens: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """Run the decoder stack over (B, T) tokens; returns hidden (B,T,d)."""
    x = _embed(params, cfg, tokens)
    b, t = tokens.shape
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    for mix, f, p in _iter_layers(cfg, params):
        h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
        if mix == "mla":
            y = mla.forward(p["attn"], cfg, h, positions,
                            precision=cfg.precision,
                            window=cfg.sliding_window, impl=impl)
        elif mix == "ssm":
            y = mamba2.forward(p["attn"], cfg, h, chunk=cfg.ssd_chunk,
                               precision=cfg.precision, impl=impl)
        else:
            y = attn_block.forward(p["attn"], cfg, h, positions,
                                   precision=cfg.precision, impl=impl)
        x = _ffn(p, cfg, f, x + y, impl, paged=False)
    return C.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)


def logits_fn(params, cfg: ArchConfig, tokens: torch.Tensor, *,
              impl: str = "auto") -> torch.Tensor:
    h = hidden_states(params, cfg, tokens, impl=impl)
    return torch.matmul(h, params["head"]["w"])


# ---------------------------------------------------------------------------
# paged decode / chunked prefill (continuous-batching serving path; see
# repro_torch/serving/engine.py).  The pools are updated in place.
# Every mixer kind has the same entry points over its own pool layout —
# paged K/V blocks (gqa), paged compressed latents (mla) or one
# recurrent slot per request (ssm); a sliding-window config runs its
# block tables as rings (ring=True).  ``mixer_decode`` and
# ``mixer_prefill`` run one layer's mixer; attention layers read the
# block table and lengths, SSM layers the slots.


def _mixer(mix: str):
    return mla if mix == "mla" else attn_block


def mixer_decode(mix: str, p, cfg: ArchConfig, h, cache, block_table,
                 lengths, slots, active, *, ring: bool, impl: str,
                 taps: list | None = None):
    """One layer's mixer at decode; returns its output."""
    if mix == "ssm":
        y, _ = mamba2.paged_decode_step(p, cfg, h, cache, slots,
                                        precision=cfg.precision,
                                        active=active, impl=impl, taps=taps)
    else:
        y, _ = _mixer(mix).paged_decode_step(
            p, cfg, h, cache, block_table, lengths, precision=cfg.precision,
            active=active, ring=ring, impl=impl, taps=taps)
    return y


def mixer_prefill(mix: str, p, cfg: ArchConfig, h, cache, block_table,
                  lengths, n_valid, slots, *, ring: bool, impl: str,
                  taps: list | None = None):
    """One layer's mixer over a prefill chunk; returns its output."""
    if mix == "ssm":
        y, _ = mamba2.prefill_chunk(p, cfg, h, cache, slots, n_valid,
                                    precision=cfg.precision, impl=impl,
                                    taps=taps)
    else:
        y, _ = _mixer(mix).prefill_chunk(
            p, cfg, h, cache, block_table, lengths, n_valid,
            precision=cfg.precision, ring=ring, impl=impl, taps=taps)
    return y


def init_paged_state(cfg: ArchConfig, num_blocks: int, block_size: int,
                     num_slots: int = 0, dtype=torch.float32,
                     device=None) -> list[dict]:
    """Flat per-layer list of pools (layer order == plan order): K/V
    blocks for GQA layers, latent blocks for MLA layers, ``num_slots``
    recurrent slots (slot 0 scratch) for SSM layers; a hybrid stack
    holds both kinds, each at its layer's place."""
    check_supported(cfg)
    pools = []
    for mix, _f in layer_plan(cfg):
        if mix == "ssm":
            if num_slots < 2:
                raise ValueError(f"{cfg.name}: SSM layers need num_slots >= "
                                 f"2 (slot 0 is scratch), got {num_slots}")
            pools.append(mamba2.init_paged_state(cfg, num_slots, dtype,
                                                 device))
        else:
            pools.append(_mixer(mix).init_paged_state(
                cfg, num_blocks, block_size, dtype, device))
    return pools


def paged_decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, caches,
                      block_table: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor | None = None,
                      slots: torch.Tensor | None = None, *,
                      ring: bool = False, impl: str = "auto"):
    """One decode token per row against the paged pools.

    tokens (B, 1) int; block_table (B, max_blocks) int32; lengths (B,)
    int32 per-row cache fill; active (B,) masks padded batch slots;
    slots (B,) int32 recurrent slot ids for SSM layers; ring=True runs
    the block tables as sliding-window rings.
    Returns (logits (B, 1, V), caches).
    """
    x = _embed(params, cfg, tokens)
    for li, (mix, f, p) in enumerate(_iter_layers(cfg, params)):
        h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
        y = mixer_decode(mix, p["attn"], cfg, h, caches[li], block_table,
                         lengths, slots, active, ring=ring, impl=impl)
        x = _ffn(p, cfg, f, x + y, impl, paged=True)
    x = C.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return torch.matmul(x, params["head"]["w"]), caches


def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, caches,
                  block_table: torch.Tensor, lengths: torch.Tensor,
                  n_valid: torch.Tensor, slots: torch.Tensor | None = None,
                  *, ring: bool = False, impl: str = "auto",
                  taps: list | None = None):
    """Chunked prefill: append a chunk of C tokens per row.

    tokens (B, C) int (padded past n_valid); lengths (B,) tokens already
    cached; n_valid (B,) real tokens in this chunk; slots (B,) recurrent
    slot ids for SSM layers; ring as in ``paged_decode_step``.  ``taps``,
    when a list, receives per layer ``(name, tensor)``: the input of
    each projection (q, k, v or q, kv_down; o; or in_proj, out_proj;
    then the FFN's or the MoE layer's, see ``moe.forward``) and
    ``("hidden", layer output)``.
    Returns (logits (B, C, V), caches) — logits at every chunk position.
    """
    x = _embed(params, cfg, tokens)
    for li, (mix, f, p) in enumerate(_iter_layers(cfg, params)):
        h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
        y = mixer_prefill(mix, p["attn"], cfg, h, caches[li], block_table,
                          lengths, n_valid, slots, ring=ring, impl=impl,
                          taps=taps)
        x = _ffn(p, cfg, f, x + y, impl, paged=True, taps=taps)
        if taps is not None:
            taps.append(("hidden", x))
    x = C.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return torch.matmul(x, params["head"]["w"]), caches
