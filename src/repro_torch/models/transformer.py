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

  audio / vlm  dense backbone, stub modality front-end
          (precomputed frame / patch embeddings)     (musicgen, pixtral)

Every projection dispatches through the OXBNN precision modes
(kernels/ops.bnn_dense, ops.expert_dense): bf16 baseline, bnn_train
(STE-binarized, differentiable) and bnn (packed XNOR-popcount
inference).  The stub front-ends are the JAX
package's: the full-sequence forward takes ``prefix_embeds`` (the vlm
patch embeddings) and ``embeds`` (the audio frame embeddings) beside
the tokens; the serving paths and the legacy decode loop take tokens.

Over a mesh (the params DTensors: ``dist/sharding.place_params``) every
family runs tensor-parallel over ``model`` and data-parallel over
``data`` under the decode rules: the embedding is a vocab-parallel
lookup (each rank's rows of the table, summed: one rank contributes
each row, so the sum is exact), the stub front-ends' embeddings are
taken whole and placed by batch beside it, each layer as
``attn_block``, ``mla``, ``mamba2``, ``ffn`` and ``moe`` say (heads,
SSD heads, experts and the hidden over ``model``), the logits come out
vocab-sharded (callers gather them, ``spmd.full``), and activations
take the JAX package's ``lsc`` constraints (the batch over ``data``
under a sharding context).  Caches and pools are placed by
``sharding.state_rules_of``.

Three ways through the stack: the full-sequence forward
(``hidden_states`` / ``logits_fn``, and ``loss_fn`` for training: the
chunked cross entropy with the MoE aux loss, over ``trainable``'s
leaves), the legacy decode loop over a
dense per-batch cache (``init_cache`` / ``decode_step``, the serving
engine's oracle), and the serving paths over paged pools
(``prefill_chunk`` / ``paged_decode_step``).
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as S, spmd
from repro_torch.kernels import ops as kops
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
    """Raise for a layer kind the port does not run (every config of
    ``configs/`` runs)."""
    for mix, f in layer_plan(cfg):
        if mix not in ("gqa", "mla", "ssm") or \
                f not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer kind ({mix}, {f}) is not ported")
    if cfg.frontend not in ("none", "audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: front-end {cfg.frontend!r} is not ported")


# ---------------------------------------------------------------------------
# init


def _init_layer(gen, cfg: ArchConfig, mix: str, f: str, dense_width: bool,
                device, keep=None) -> dict:
    """One layer; ``dense_width`` marks the leading dense layers, whose
    FFN is ``dense_d_ff`` wide where the config sets one; ``keep`` as
    ``moe.init``'s."""
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
                            device=device, keep=keep)
    return p


def init(gen: torch.Generator, cfg: ArchConfig, device=None, *,
         place=None) -> dict:
    """Random parameters drawn from ``gen`` (its device must match
    ``device``).  Same distributions as the JAX package's init, not the
    same numbers: for parity, convert JAX weights with ``interop``.
    ``place(tree, specs)``, when given, takes each piece (the embedding,
    the final norm, the head, a layer) with its ``param_specs`` as soon
    as it is drawn and returns what to keep of it
    (``launch/mesh.init_on_ranks``: a rank's slices, so the whole of one
    layer at a time is held, and of a MoE layer one expert stack: each
    stack is handed to ``place`` alone as it is drawn, and ``place``
    keeps a leaf it gets as a DTensor as it is); the draws, and so the
    numbers, are the same."""
    check_supported(cfg)
    specs = param_specs(cfg) if place is not None else None

    def put(tree, key, i=None):
        if place is None:
            return tree
        return place(tree, specs[key] if i is None else specs[key][i])
    params = {"embed": put(C.embed_init(gen, cfg.vocab, cfg.d_model,
                                        device=device), "embed"),
              "final_norm": put(C.norm_init(cfg.d_model, cfg.norm,
                                            device=device), "final_norm")}
    params["head"] = ({"w": spmd.transpose(params["embed"]["w"])}
                      if cfg.tie_embeddings
                      else put(C.dense_init(gen, cfg.d_model, cfg.vocab,
                                            device=device), "head"))
    def keep(i):
        if place is None:
            return None
        return lambda name, w: place(w, specs["layers"][i]["ffn"][name])
    params["layers"] = [
        put(_init_layer(gen, cfg, mix, f, i < cfg.first_dense, device,
                        keep(i)), "layers", i)
        for i, (mix, f) in enumerate(layer_plan(cfg))]
    return params


def abstract_init(cfg: ArchConfig, seed: int = 0) -> dict:
    """The params' shapes and dtypes without allocating anything: the
    init on the ``meta`` device (the JAX package's ``eval_shape``)."""
    return init(torch.Generator().manual_seed(seed), cfg, device="meta")


def _layer_specs(cfg: ArchConfig, mix: str, f: str) -> dict:
    """Logical axes of ``_init_layer``'s leaves."""
    mod = {"mla": mla, "ssm": mamba2}.get(mix, attn_block)
    s = {"norm1": C.norm_specs(cfg.norm), "attn": mod.specs(cfg)}
    if f != "none":
        s["norm2"] = C.norm_specs(cfg.norm)
    if f == "dense":
        s["ffn"] = ffn.specs(cfg.act)
    elif f == "moe":
        s["ffn"] = moe.specs(cfg.act, cfg.n_shared_experts)
    return s


def param_specs(cfg: ArchConfig) -> dict:
    """The params' logical axes: a tuple of axis names per leaf, in a
    tree shaped as ``trainable(params, cfg)`` (a tied head is
    ``embed.w`` and has no entry of its own, as the JAX package's tree
    has no ``head`` then).  The JAX package prepends "layers" to every
    leaf of a scanned segment; the port keeps one dict per layer, so
    that axis has no counterpart here."""
    check_supported(cfg)
    s = {"embed": C.embed_specs(), "final_norm": C.norm_specs(cfg.norm)}
    if not cfg.tie_embeddings:
        s["head"] = C.dense_specs(("embed", "vocab"))
    s["layers"] = [_layer_specs(cfg, mix, f) for mix, f in layer_plan(cfg)]
    return s


def _iter_layers(cfg: ArchConfig, params):
    """Yield (mix, ffn_kind, layer_params) in plan order."""
    for (mix, f), p in zip(layer_plan(cfg), params["layers"], strict=True):
        yield mix, f, p


def _ffn(params, cfg: ArchConfig, f: str, x, impl, *, paged: bool,
         taps=None, aux: list | None = None):
    """The layer's FFN with its residual, after any mixer (an SSD
    layer's too).  A MoE layer dispatches with the config's finite
    capacity over a full sequence, as the JAX package does, and
    drop-free on the serving path (``paged``): a finite capacity would
    let batch composition, padding and the chunk width decide which
    tokens keep their experts (in the JAX package it made jamba's
    logits depend on the chunk width).  ``aux``, when a list, receives
    a MoE layer's load-balance loss."""
    if f == "none":
        return x
    h = C.norm(x, params["norm2"], cfg.norm, cfg.norm_eps)
    if f == "moe":
        y, layer_aux = moe.forward(
            params["ffn"], h, top_k=cfg.top_k, kind=cfg.act,
            capacity_factor=0.0 if paged else cfg.capacity_factor,
            precision=cfg.precision,
            dispatch_groups=1 if paged else cfg.moe_dispatch_groups,
            impl=impl, taps=taps)
        if aux is not None:
            aux.append(layer_aux)
    else:
        y = ffn.forward(params["ffn"], h, cfg.act, cfg.precision, impl, taps)
    return x + y


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return _embed_inputs(params, cfg, tokens)


def _lookup(w, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the table ``w``.  Of a DTensor table, a rank
    looks up its own rows of ``tokens`` (a DTensor placed by batch, or
    whole); where ``w`` is cut along the vocab, each rank looks them up
    in its slice (zero rows for the rest) and the ranks' rows are
    summed: one rank contributes each row, so the sum is exact.  The
    result is placed as ``tokens``' rows are."""
    if not spmd.is_dtensor(w):
        return torch.nn.functional.embedding(tokens, w)
    mesh, wl, tl = w.device_mesh, w.to_local(), spmd.local(tokens)
    cut = [i for i, p in enumerate(w.placements)
           if p.is_shard() and p.dim == 0]
    if cut:
        i = cut[0]
        ids = tl - mesh.get_coordinate()[i] * wl.shape[0]
        off = (ids < 0) | (ids >= wl.shape[0])
        e = torch.nn.functional.embedding(ids.masked_fill(off, 0), wl)
        e = spmd.all_reduce(e.masked_fill(off[..., None], 0.0), mesh, i)
    else:
        e = torch.nn.functional.embedding(tl, wl)
    if not spmd.is_dtensor(tokens):
        return spmd.replicate(e, mesh)
    return spmd.wrap(e, mesh, tokens.placements, (*tokens.shape, e.shape[-1]))


def _embed_inputs(params, cfg: ArchConfig, tokens=None, embeds=None,
                  prefix_embeds=None) -> torch.Tensor:
    """The input hidden sequence: ``prefix_embeds`` (vlm patch
    embeddings), ``embeds`` (audio frame embeddings), then the tokens'
    embeddings, concatenated along the sequence in that order, then
    ``embed_scale`` over the whole, as in the JAX package.  The lookup
    is ``F.embedding``: its backward sums a row's gradients in a fixed
    order, where indexing's accumulating backward does not (a
    multi-threaded CPU run then differs from run to run).  Over a mesh
    the sequence is placed by batch first (a front-end's embeddings
    taken whole, plain or DTensors, then cut; the tokens cut), so each
    rank embeds its own rows only."""
    w = spmd.gather_data(params["embed"]["w"])
    mesh = w.device_mesh if spmd.is_dtensor(w) else None

    def by_batch(t):
        if mesh is None:
            return t
        t = spmd.replicate(spmd.full(t), mesh)
        return C.lsc(t, "batch", *([None] * (t.ndim - 1)))
    parts = [by_batch(e) for e in (prefix_embeds, embeds) if e is not None]
    if tokens is not None:
        parts.append(_lookup(w, by_batch(tokens)))

    def join(*ts):
        x = ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)
        return x * (cfg.d_model ** 0.5) if cfg.embed_scale else x
    x = spmd.on_local(join, *parts)
    return C.lsc(x, "batch", None, None)


# ---------------------------------------------------------------------------
# full forward


def _layer(p, cfg: ArchConfig, mix: str, f: str, x, positions, impl):
    """One layer over the full sequence: (x', the layer's aux loss, 0
    without a MoE FFN).  Params placed by the train rules are gathered
    over the data dims first (FSDP, ``spmd.gather_data``): inside the
    layer's remat checkpoint, so a recompute gathers them again."""
    p = spmd.gather_data_tree(p)
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
    aux: list = []
    x = C.lsc(_ffn(p, cfg, f, x + y, impl, paged=False, aux=aux),
              "batch", None, None)
    return x, (aux[0] if aux else torch.zeros((), device=x.device))


def _stack(params, cfg: ArchConfig, x: torch.Tensor, *, impl: str,
           remat: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder stack and the final norm over the embedded sequence
    x; returns (hidden, the MoE aux loss summed over the layers in
    order, float32).  ``remat`` checkpoints each layer: its activations
    are recomputed on the backward pass (the JAX package checkpoints
    each scan step, one layer period)."""
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    aux_total = torch.zeros((), device=x.device)
    for mix, f, p in _iter_layers(cfg, params):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer, p, cfg, mix, f, x, positions, impl,
                use_reentrant=False)
        else:
            x, aux = _layer(p, cfg, mix, f, x, positions, impl)
        aux_total = aux_total + aux
    return C.norm(x, spmd.gather_data_tree(params["final_norm"]), cfg.norm,
                  cfg.norm_eps), aux_total


def hidden_states(params, cfg: ArchConfig, tokens: torch.Tensor | None = None,
                  *, embeds: torch.Tensor | None = None,
                  prefix_embeds: torch.Tensor | None = None,
                  impl: str = "auto") -> torch.Tensor:
    """Run the decoder stack over (B, T) tokens, or the stub front-ends'
    (B, T, d) embeddings, or both (``_embed_inputs``); returns hidden
    (B, T_total, d).  ``loss_fn`` takes the MoE aux loss too."""
    # the embedded input is not named here: the stack frees it after the
    # first layer
    return _stack(params, cfg, _embed_inputs(params, cfg, tokens, embeds,
                                             prefix_embeds),
                  impl=impl, remat=False)[0]


def logits_fn(params, cfg: ArchConfig, tokens: torch.Tensor | None = None,
              *, embeds: torch.Tensor | None = None,
              prefix_embeds: torch.Tensor | None = None,
              impl: str = "auto") -> torch.Tensor:
    """(B, T, V) logits; over a mesh vocab-sharded (``spmd.full``
    gathers them)."""
    h = hidden_states(params, cfg, tokens, embeds=embeds,
                      prefix_embeds=prefix_embeds, impl=impl)
    return apply_head(params, h)


def apply_head(params, h):
    """The float LM head (``kernels/ops.row_gemm``: each logit summed in
    one order set by d alone, so its bits are one rank's whatever rows
    and vocab columns run beside it).  Over a mesh each rank multiplies its
    own rows by its own vocab slice of the head, and the logits come
    out cut along the vocab (and the batch over ``data``), as the JAX
    package places them; a tied head's slice is the rank's shard of the
    embedding, read transposed."""
    w = params["head"]["w"]
    if not spmd.is_dtensor(w):
        return kops.row_gemm(h, w).to(h.dtype)
    from torch.distributed.tensor import Shard
    w = spmd.whole(w, 0)
    last = h.ndim - 1
    h = spmd.replicate(h, w.device_mesh) if not spmd.is_dtensor(h) else h
    out = []
    for pw, ph in zip(w.placements, h.placements):
        if pw == Shard(1) and ph.is_shard():
            raise ValueError(f"apply_head: h {h.placements} and the head "
                             f"{w.placements} cut one mesh dim")
        out.append(Shard(last) if pw == Shard(1) else ph)
    hl = h.to_local()
    y = kops.row_gemm(hl, w.to_local()).to(hl.dtype)
    return spmd.wrap(y, w.device_mesh, out, (*h.shape[:-1], w.shape[1]))


def head_matrix(params, cfg: ArchConfig) -> torch.Tensor:
    """The LM head (d, V): tied, ``embed.w.T`` read inside the autograd
    graph (``params["head"]["w"]`` is a view made before any gradient
    was asked for); else ``head.w``."""
    return params["embed"]["w"].t() if cfg.tie_embeddings else \
        params["head"]["w"]


def trainable(params, cfg: ArchConfig) -> dict:
    """The leaves training updates, the JAX package's tree: the tied
    head is left out (it is ``embed.w``), so the gradient norm, the
    weight decay and the checkpoint count the embedding once."""
    return {k: v for k, v in params.items()
            if not (k == "head" and cfg.tie_embeddings)}


def _chunk_nll(hc, lc, head):
    """(sum of -log p(label), count) over one chunk's rows, in float32;
    label -1 is padding."""
    logits = torch.matmul(hc, head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.clamp_min(0)[..., None])[..., 0]
    mask = (lc >= 0).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def _chunk_nll_cut(hc, lc, head, v0: int, mesh, dims: list[int]):
    """``_chunk_nll`` over a rank's vocab slice: ``head`` (d, V/m) holds
    the whole head's columns v0 .. v0 + V/m, and the mesh dims ``dims``
    cut the vocab.  The logsumexp is reduced over them: the rows' max
    (no gradient: a shift the result does not depend on) all-reduced
    by max, then the sum of exp(logit - max) beside the gold logit
    (zero where the label lies in another rank's slice), the pair
    summed in one all-reduce.  Every rank of ``dims`` returns the same
    sums; under ``dist/spmd``'s backward convention a rank's gradient
    of ``hc`` is its slice's share."""
    logits = torch.matmul(hc, head).float()
    shift = logits.detach().amax(dim=-1)
    for i in dims:
        shift = spmd.all_reduce_max(shift, mesh, i)
    n = logits.shape[-1]
    ids = lc - v0
    off = (ids < 0) | (ids >= n)
    gold = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    stats = torch.stack([torch.exp(logits - shift[..., None]).sum(dim=-1),
                         gold.masked_fill(off, 0.0)])
    for i in dims:
        stats = spmd.all_reduce(stats, mesh, i)
    mask = (lc >= 0).float()
    nll = shift + torch.log(stats[0]) - stats[1]
    return torch.sum(nll * mask), torch.sum(mask)


def _vocab_cut(params, cfg: ArchConfig):
    """Over a mesh that cuts the vocab (a mesh dim of more than one rank
    along the head's vocab dim): the rank's head (d, V/m), gathered over
    the data dims only (a tied head is the rank's slice of ``embed.w``,
    read transposed), its first column v0 in the whole, and the mesh
    dims that cut the vocab.  None where the vocab is held whole."""
    w, vdim = ((params["embed"]["w"], 0) if cfg.tie_embeddings
               else (params["head"]["w"], 1))
    if not spmd.is_dtensor(w):
        return None
    mesh = w.device_mesh
    dims = [i for i in spmd.mesh_dims(w, vdim) if mesh.size(i) > 1]
    if not dims:
        return None
    w = spmd.gather_data(w)
    v0, _ = spmd.rank_slice(w, vdim)
    wl = w.to_local()
    return (wl.t() if vdim == 0 else wl), v0, dims


def loss_fn(params, cfg: ArchConfig, batch: dict, *, loss_chunk: int = 2048,
            aux_weight: float = 0.01, remat: bool = False):
    """Chunked next-token cross entropy plus ``aux_weight`` x the MoE
    aux loss; returns (loss, {"xent", "aux"}).

    ``batch`` holds ``labels`` (B, T_lab) and the inputs of
    ``hidden_states``: ``tokens``, ``embeds``, ``prefix_embeds``.  The
    loss reads the last T_lab positions (a vlm's prefix conditions
    only); the sequence is padded to a multiple of ``loss_chunk`` with
    label -1 (masked) and the logits are made one chunk at a time in
    float32, so (B, T, V) is never built whole (with ``remat`` a chunk's
    logits are recomputed on the backward pass, not kept).

    Over a mesh (``batch`` whole on every rank, the params DTensors
    under a sharding context) the rows are cut over ``data`` (the
    ``lsc`` of ``_embed_inputs``) and, where the mesh cuts the vocab
    over ``model``, each rank multiplies its rows by its own vocab
    slice of the head (gathered over the data dims only), so a chunk's
    logits are (rows, chunk, V/m) and no rank holds the head whole: a
    vocab-parallel cross entropy (``_chunk_nll_cut``), as the JAX
    package's placement of the head (vocab over ``model``) computes
    it.  Where the vocab is whole (``model`` of one rank, or a vocab
    ``model`` does not divide) each rank takes its rows' cross entropy
    against the head gathered whole.  The sum of -log p and the label
    count are summed over the data dims, so every rank's loss is the
    global mean, as the JAX package's; the MoE aux loss is every
    group's mean (``moe._mean_over_rows``)."""
    x = _embed_inputs(params, cfg, batch.get("tokens"), batch.get("embeds"),
                      batch.get("prefix_embeds"))
    h, aux = _stack(params, cfg, x, impl="auto", remat=remat)
    labels = batch["labels"]
    data: list[int] = []
    nll_of = _chunk_nll
    if spmd.is_dtensor(h):
        mesh, data = h.device_mesh, spmd.mesh_dims(h, 0)
        labels = spmd.rows(labels, h)
        h = spmd.local(h)
        cut = _vocab_cut(params, cfg)
        if cut is None:
            head = (spmd.full(params["embed"]["w"]).t()
                    if cfg.tie_embeddings else spmd.full(params["head"]["w"]))
        else:
            head, v0, dims = cut
            nll_of = functools.partial(_chunk_nll_cut, v0=v0, mesh=mesh,
                                       dims=dims)
    else:
        head = head_matrix(params, cfg)
    t = labels.shape[1]
    h = h[:, -t:]
    loss_chunk = min(loss_chunk, t)
    pad = (-t) % loss_chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(0, t + pad, loss_chunk):
        args = (h[:, i:i + loss_chunk], labels[:, i:i + loss_chunk].long(),
                head)
        nll, n = (torch.utils.checkpoint.checkpoint(
            nll_of, *args, use_reentrant=False) if remat
            else nll_of(*args))
        tot = tot + nll
        cnt = cnt + n
    for i in data:
        tot = spmd.all_reduce(tot, mesh, i)
        cnt = spmd.all_reduce(cnt, mesh, i)
    loss = tot / cnt.clamp_min(1.0)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# legacy decode: one token for the whole batch at one scalar position,
# over a dense per-batch cache (the serving engine's oracle; the JAX
# package's ``serve --engine legacy``).  Layers in plan order, as
# ``_iter_layers`` walks them; the caches are one dict per layer.


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None, *,
               mesh=None) -> list[dict]:
    """Per-layer dense caches: (B, L, Hkv, Dh) K/V for GQA (a window's
    ring for a sliding-window config), (B, L, R) latents for MLA, the
    recurrent state for SSM layers.  Over ``mesh``, DTensors placed by
    ``cache_specs`` under ``sharding.state_rules_of`` (its decode rules,
    which the forward's sharding context must have, without the
    ``head_dim`` and ``kv_lora`` splits)."""
    check_supported(cfg)
    caches = []
    for mix, _f in layer_plan(cfg):
        if mix == "ssm":
            caches.append(mamba2.init_cache(cfg, batch, dtype, device))
        else:
            caches.append(_mixer(mix).init_cache(cfg, batch, max_len, dtype,
                                                 device))
    if mesh is None:
        return caches
    return S.place_tree(caches, cache_specs(cfg), mesh,
                        S.state_rules_of(mesh))


def cache_specs(cfg: ArchConfig) -> list[dict]:
    """Logical axes of ``init_cache``'s leaves, one dict per layer."""
    check_supported(cfg)
    return [mamba2.cache_specs() if mix == "ssm" else
            _mixer(mix).cache_specs() for mix, _f in layer_plan(cfg)]


def _decode_layer(p, cfg: ArchConfig, mix: str, f: str, x, cache,
                  length: int, impl: str):
    h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
    if mix == "ssm":
        y, cache = mamba2.decode_step(p["attn"], cfg, h, cache,
                                      precision=cfg.precision, impl=impl)
    else:
        y, cache = _mixer(mix).decode_step(p["attn"], cfg, h, cache, length,
                                           precision=cfg.precision,
                                           impl=impl)
    # drop-free MoE routing (``paged``), as the JAX package's legacy step
    return _ffn(p, cfg, f, x + y, impl, paged=True), cache


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, caches,
                length: int, *, impl: str = "auto"):
    """tokens (B, 1) int; ``length`` the cache fill (one scalar for the
    whole batch).  Returns (logits (B, 1, V), caches): attention caches
    are written in place, an SSM layer's entry is its new state."""
    x = _embed(params, cfg, tokens)
    new = []
    for li, (mix, f, p) in enumerate(_iter_layers(cfg, params)):
        x, c = _decode_layer(p, cfg, mix, f, x, caches[li], length, impl)
        new.append(c)
    x = C.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return apply_head(params, x), new


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
                 attn_impl: str | None = None, taps: list | None = None):
    """One layer's mixer at decode; returns its output.  Paged
    attention resolves ``attn_impl`` (``None``: ``impl``), every BNN
    GEMM ``impl``."""
    if mix == "ssm":
        y, _ = mamba2.paged_decode_step(p, cfg, h, cache, slots,
                                        precision=cfg.precision,
                                        active=active, impl=impl, taps=taps)
    else:
        y, _ = _mixer(mix).paged_decode_step(
            p, cfg, h, cache, block_table, lengths, precision=cfg.precision,
            active=active, ring=ring, impl=impl, attn_impl=attn_impl,
            taps=taps)
    return y


def mixer_prefill(mix: str, p, cfg: ArchConfig, h, cache, block_table,
                  lengths, n_valid, slots, *, ring: bool, impl: str,
                  attn_impl: str | None = None, taps: list | None = None):
    """One layer's mixer over a prefill chunk; returns its output
    (``attn_impl`` as in ``mixer_decode``)."""
    if mix == "ssm":
        y, _ = mamba2.prefill_chunk(p, cfg, h, cache, slots, n_valid,
                                    precision=cfg.precision, impl=impl,
                                    taps=taps)
    else:
        y, _ = _mixer(mix).prefill_chunk(
            p, cfg, h, cache, block_table, lengths, n_valid,
            precision=cfg.precision, ring=ring, impl=impl,
            attn_impl=attn_impl, taps=taps)
    return y


def paged_state_specs(cfg: ArchConfig) -> list[dict]:
    """Logical axes of ``init_paged_state``'s pools over a mesh: a GQA
    layer's K/V blocks (plain or ring), an MLA layer's latent blocks or
    an SSM layer's slots, a layer each."""
    check_supported(cfg)
    return [mamba2.paged_state_specs() if mix == "ssm" else
            _mixer(mix).paged_state_specs() for mix, _f in layer_plan(cfg)]


def place_pools(cfg: ArchConfig, pools: list[dict], layer_ids, mesh
                ) -> list[dict]:
    """The pools of layers ``layer_ids`` (plain, whole) placed on
    ``mesh`` by ``paged_state_specs`` under ``sharding.state_rules_of``
    (a serving cache's member holds some of the layers: the slot
    member's SSM layers, its snapshot rows); as they are without a
    mesh."""
    if mesh is None:
        return pools
    specs = paged_state_specs(cfg)
    rules = S.state_rules_of(mesh)
    return [S.place_tree(p, specs[li], mesh, rules)
            for li, p in zip(layer_ids, pools, strict=True)]


def init_paged_state(cfg: ArchConfig, num_blocks: int, block_size: int,
                     num_slots: int = 0, dtype=torch.float32,
                     device=None, *, mesh=None) -> list[dict]:
    """Flat per-layer list of pools (layer order == plan order): K/V
    blocks for GQA layers, latent blocks for MLA layers, ``num_slots``
    recurrent slots (slot 0 scratch) for SSM layers; a hybrid stack
    holds both kinds, each at its layer's place.  Over ``mesh``,
    DTensors placed by ``paged_state_specs`` under
    ``sharding.state_rules_of``: K/V by kv heads over ``model`` where
    they divide it, else whole; latents whole; an SSM slot's ``h`` by
    heads, its conv tail whole; every block and slot on every data
    rank."""
    if mesh is not None:
        return place_pools(
            cfg, init_paged_state(cfg, num_blocks, block_size, num_slots,
                                  dtype, device),
            range(cfg.n_layers), mesh)
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
                      ring: bool = False, impl: str = "auto",
                      attn_impl: str | None = None,
                      taps: list | None = None):
    """One decode token per row against the paged pools.

    tokens (B, 1) int; block_table (B, max_blocks) int32; lengths (B,)
    int32 per-row cache fill; active (B,) masks padded batch slots;
    slots (B,) int32 recurrent slot ids for SSM layers; ring=True runs
    the block tables as sliding-window rings.  The BNN GEMMs resolve
    ``impl``, the paged attention ``attn_impl`` (``None``: ``impl``),
    as the JAX package's engine takes ``bnn_impl`` and ``attn_impl``.
    ``taps`` as in ``prefill_chunk``.  Returns (logits (B, 1, V), caches).
    """
    x = _embed(params, cfg, tokens)
    for li, (mix, f, p) in enumerate(_iter_layers(cfg, params)):
        h = C.norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
        y = mixer_decode(mix, p["attn"], cfg, h, caches[li], block_table,
                         lengths, slots, active, ring=ring, impl=impl,
                         attn_impl=attn_impl, taps=taps)
        x = _ffn(p, cfg, f, x + y, impl, paged=True, taps=taps)
        if taps is not None:
            taps.append(("hidden", x))
    x = C.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return apply_head(params, x), caches


def prefill_chunk(params, cfg: ArchConfig, tokens: torch.Tensor, caches,
                  block_table: torch.Tensor, lengths: torch.Tensor,
                  n_valid: torch.Tensor, slots: torch.Tensor | None = None,
                  *, ring: bool = False, impl: str = "auto",
                  attn_impl: str | None = None, taps: list | None = None):
    """Chunked prefill: append a chunk of C tokens per row.

    tokens (B, C) int (padded past n_valid); lengths (B,) tokens already
    cached; n_valid (B,) real tokens in this chunk; slots (B,) recurrent
    slot ids for SSM layers; ring, impl and attn_impl as in
    ``paged_decode_step``.  ``taps``,
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
                          attn_impl=attn_impl, taps=taps)
        x = _ffn(p, cfg, f, x + y, impl, paged=True, taps=taps)
        if taps is not None:
            taps.append(("hidden", x))
    x = C.norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return apply_head(params, x), caches


def snapshot_slot_state(cfg: ArchConfig, caches, slots: torch.Tensor
                        ) -> list:
    """Per-layer copies of the rows' recurrent slots before a verify step
    (None for block-family layers; over a mesh each rank's slices of
    every row's slot, plain tensors).  Block layouts roll back by
    rewinding ``lengths`` (writes past the committed length are masked);
    an SSM slot has folded every verified token into its state, so its
    only rollback is restore-and-re-advance from this copy."""
    return [mamba2.snapshot_slots(caches[li], slots) if mix == "ssm" else None
            for li, (mix, _f) in enumerate(layer_plan(cfg))]


def restore_slot_state(cfg: ArchConfig, caches, slots: torch.Tensor,
                       snaps: list):
    """Write the slot copies back, in place (the speculative rollback);
    block-family layers are untouched."""
    for li, snap in enumerate(snaps):
        if snap is not None:
            mamba2.restore_slots(caches[li], slots, snap)
    return caches


def spec_verify(params, cfg: ArchConfig, tokens: torch.Tensor, caches,
                block_table: torch.Tensor, lengths: torch.Tensor,
                n_valid: torch.Tensor, slots: torch.Tensor | None = None, *,
                ring: bool = False, impl: str = "auto",
                attn_impl: str | None = None):
    """Multi-token speculative verify: one prefill-shaped forward over
    ``[last token, draft...]`` rows scores every draft position at once.

    The contract of ``prefill_chunk`` (logits at all C positions, per-row
    lengths / n_valid), plus the recurrent slots as they were before the
    step, so the caller can roll back a rejected suffix: block and ring
    layouts by committing only ``lengths + accepted``, slot layouts by
    ``restore_slot_state`` and a masked ``prefill_chunk``.
    Returns (logits (B, C, V), caches, slot snapshots).
    """
    snaps = snapshot_slot_state(cfg, caches, slots)
    logits, caches = prefill_chunk(params, cfg, tokens, caches, block_table,
                                   lengths, n_valid, slots, ring=ring,
                                   impl=impl, attn_impl=attn_impl)
    return logits, caches, snaps
