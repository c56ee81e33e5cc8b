"""The train step: microbatched gradient accumulation, then the AdamW
update — the JAX package's ``repro.launch.steps.build_train_step`` —
the serving steps of the dry-run's prefill and decode cells
(``build_prefill_step``, ``build_decode_step``), and the abstract
inputs of one shape cell (``input_specs``, ``cache_specs_abstract``,
``to_dtype_structs``): ``meta`` tensors, the counterpart of the JAX
package's ``ShapeDtypeStruct`` stand-ins, which the dry-run places on
a mesh.  The serving steps run on DTensor params over a mesh too,
under the sharding context the caller sets.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.dist import spmd
from repro_torch.models import transformer as M
from repro_torch.optim import optimizer as opt_mod


# ---------------------------------------------------------------------------
# abstract input specs (meta tensors; no allocation)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, cell: ShapeCell, *,
                compute_dtype=torch.bfloat16) -> dict:
    """The batch of one shape cell as ``meta`` tensors: tokens (the
    audio front-end's frame embeddings, the vlm front-end's patch
    prefix beside the tokens) and, for training, the labels; a decode
    cell takes one new token a row and the cache fill."""
    b, t = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.frontend == "audio":
            batch["embeds"] = _meta((b, t, cfg.d_model), compute_dtype)
        elif cfg.frontend == "vlm":
            p = cfg.frontend_prefix
            batch["prefix_embeds"] = _meta((b, p, cfg.d_model), compute_dtype)
            batch["tokens"] = _meta((b, t - p), i32)
        else:
            batch["tokens"] = _meta((b, t), i32)
        if cell.kind == "train":
            t_lab = t - cfg.frontend_prefix if cfg.frontend == "vlm" else t
            batch["labels"] = _meta((b, t_lab), i32)
        return batch
    # decode: one new token against a full cache of length seq_len
    return {"tokens": _meta((b, 1), i32), "length": _meta((), i32)}


def cache_specs_abstract(cfg: ArchConfig, cell: ShapeCell,
                         compute_dtype=torch.bfloat16) -> list[dict]:
    """The legacy decode caches of a decode cell (``M.init_cache``) as
    ``meta`` tensors."""
    return M.init_cache(cfg, cell.global_batch, cell.seq_len, compute_dtype,
                        device="meta")


def to_dtype_structs(tree, dtype=torch.bfloat16):
    """Re-type the float leaves of a tree to ``dtype`` as ``meta``
    tensors (the dry-run's bf16 params); other leaves keep theirs."""
    return T.map_(lambda s: _meta(s.shape, dtype if s.is_floating_point()
                                  else s.dtype), tree)


@contextlib.contextmanager
def requires_grad(leaves):
    """Ask autograd for the gradients of ``leaves`` within the block;
    their flags are as they were afterwards."""
    before = [l.requires_grad for l in leaves]
    for l in leaves:
        l.requires_grad_(True)
    try:
        yield
    finally:
        for l, b in zip(leaves, before):
            l.requires_grad_(b)


def value_and_grad(params, cfg: ArchConfig, batch: dict, *, loss_chunk: int,
                   remat: bool):
    """(loss, metrics, grads) of ``M.loss_fn``: the loss and metrics
    detached, the gradients as a tree shaped as ``M.trainable(params,
    cfg)``.  On one rank a leaf the batch never reached gets float32
    zeros, as the JAX package's gradient of an unused leaf is.

    Over a mesh (the params DTensors under a sharding context, the
    batch whole on every rank) each rank differentiates its share of
    the global loss, the loss over the mesh's size (``dist/spmd``'s
    convention), and a leaf held whole along a mesh dim has its
    gradient all-reduced over that dim, so every leaf's gradient is
    the whole gradient, placed as the leaf.  A leaf without a gradient
    raises, naming it: over a mesh a missing gradient is a graph cut by
    a collective or a cache, not an unused leaf; the one leaf a batch
    may leave unused, the embedding table of a batch without tokens
    (the audio front-end's frame embeddings), gets zeros."""
    tree = M.trainable(params, cfg)
    leaves = T.leaves(tree)
    mesh = spmd.mesh_of(leaves)
    with requires_grad(leaves):
        loss, metrics = M.loss_fn(params, cfg, batch, loss_chunk=loss_chunk,
                                  remat=remat)
        share = loss / mesh.size() if mesh is not None else loss
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
    if mesh is None:
        grads = [torch.zeros_like(l) if g is None else g
                 for l, g in zip(leaves, grads)]
    else:
        unused = {"embed/w"} if batch.get("tokens") is None else set()
        grads = [_whole_grad(l, g, path, path in unused) for l, g, path in
                 zip(leaves, grads, T.paths(tree))]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            T.unflatten(tree, grads))


def _whole_grad(leaf, g, path: str, unused: bool = False):
    """A leaf's gradient over a mesh: the ranks' shares summed over the
    mesh dims that hold the leaf whole (module ``dist/spmd``); zeros
    for a leaf the batch leaves ``unused``."""
    if g is None and unused:
        return spmd.wrap_like(torch.zeros_like(spmd.local(leaf)), leaf)
    if g is None:
        raise RuntimeError(f"value_and_grad: the leaf {path} got no "
                           "gradient over the mesh")
    mesh = leaf.device_mesh
    gl = spmd.local(g).detach().clone()
    for i, p in enumerate(leaf.placements):
        if p.is_replicate() and mesh.size(i) > 1:
            gl = spmd.all_reduce(gl, mesh, i)
    return spmd.wrap(gl, mesh, leaf.placements, leaf.shape)


def _shardwise(fn, *trees):
    """An elementwise ``fn`` over the leaves of ``trees``, on each rank's
    shards where they are DTensors placed alike (a gradient and its
    sum), the result placed as the first tree's leaf."""
    return T.map_(lambda *ts: spmd.wrap_like(fn(*map(spmd.local, ts)),
                                             ts[0]), *trees)


def build_train_step(cfg: ArchConfig, opt_cfg: opt_mod.AdamWConfig, *,
                     microbatches: int = 8, loss_chunk: int = 2048):
    """Returns train_step(params, opt_state, batch) -> (params, state',
    metrics {"loss", "grad_norm", "lr"}); the params are updated in
    place.

    With ``microbatches`` g > 1 the batch splits along its rows into g
    equal parts, in order; their gradients are summed in float32 and
    divided by g, and so are the losses, as the JAX package's
    ``lax.scan`` does.  Each layer is rematerialized on the backward
    pass, as in the JAX package.  Over a mesh (``value_and_grad``) the
    batch is the global one, whole on every rank: it is split into
    microbatches first, and each microbatch's rows are then cut over
    ``data`` by the model's ``lsc``, so a rank's rows of microbatch i
    are the JAX package's.  The collectives of microbatch i carry the
    tag ``microbatch=i`` (``spmd.tagged``); the update's carry none."""

    def grads_for(params, mb):
        return value_and_grad(params, cfg, mb, loss_chunk=loss_chunk,
                              remat=True)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            with spmd.tagged(microbatch=0):
                loss, _, grads = grads_for(params, batch)
        else:
            g = microbatches
            rows = next(iter(batch.values())).shape[0]
            if rows % g:
                raise ValueError(f"batch of {rows} rows does not split "
                                 f"into {g} microbatches")
            n = rows // g
            gacc = None
            loss = torch.zeros((), device=next(iter(batch.values())).device)
            for i in range(g):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                with spmd.tagged(microbatch=i):
                    l, _, gr = grads_for(params, mb)
                gacc = (_shardwise(lambda gg: gg.float(), gr)
                        if gacc is None else
                        _shardwise(lambda a, gg: a + gg.float(), gacc, gr))
                loss = loss + l
            grads = _shardwise(lambda a: a / g, gacc)
            loss = loss / g
        _, new_state, om = opt_mod.update(opt_cfg, grads, opt_state,
                                          M.trainable(params, cfg))
        return params, new_state, {"loss": loss, **om}

    return train_step


def build_prefill_step(cfg: ArchConfig):
    """prefill_step(params, batch) -> the last position's logits (B, V):
    the forward over ``batch``'s ``tokens`` and the stub front-ends'
    ``embeds`` / ``prefix_embeds`` (no cache write-back, as in the JAX
    package's dry-run step); over a mesh vocab-sharded, as
    ``logits_fn``."""

    @torch.no_grad()
    def prefill_step(params, batch):
        h = M.hidden_states(params, cfg, batch.get("tokens"),
                            embeds=batch.get("embeds"),
                            prefix_embeds=batch.get("prefix_embeds"))
        return M.apply_head(params, spmd.on_local(lambda t: t[:, -1], h))

    return prefill_step


def build_decode_step(cfg: ArchConfig):
    """decode_step(params, caches, batch) -> (next token ids (B,) int32,
    caches): one token in (``batch["tokens"]`` (B, 1), the cache fill
    ``batch["length"]``) against the legacy dense caches (written in
    place), greedy over the logits gathered whole, so every rank of a
    mesh returns the same ids."""

    @torch.no_grad()
    def decode_step(params, caches, batch):
        logits, caches = M.decode_step(params, cfg, batch["tokens"], caches,
                                       int(batch["length"]))
        logits = spmd.full(logits)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), caches

    return decode_step
