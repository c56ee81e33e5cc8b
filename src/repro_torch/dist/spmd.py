"""SPMD over a ``DeviceMesh``: DTensors as the container of each rank's
shard, and the collectives of the forward over several ranks.

The port's tensor-parallel forward computes on local shards.  A
DTensor carries a rank's shard with its mesh, its placements and the
global shape; the layers take its ``local`` tensor, run their kernels
on it, and ``wrap`` the result with the placements it has.  An
activation moves between placements (the sharding context's ``lsc``,
the rows a pool write needs, the logits' gather) through
``redistribute``, and a row-parallel GEMM sums its partial products
through ``all_reduce``; each is one collective over one mesh dim's
process group (``all_gather`` or ``all_reduce``, and in a backward
pass ``reduce_scatter``), counted in ``COLLECTIVES``.  DTensor's own
redistribute is not used: these calls are all a step needs, each is
visible here (counted, and ordered as the step issues it), and they
run on NCCL and on ``gloo`` alike, on a card's tensors too (ranks that
share a card cannot use NCCL: ``launch/mesh.rank_world``).

Placements are ``Shard(dim)`` with dim >= 0 or ``Replicate()``; no
step makes a ``Partial`` one.  Every sharded dim divides evenly
(``layers.common.logical_to_pspec`` drops a mesh axis that does not).
On plain tensors every helper is the identity, so a one-rank path runs
exactly as it did without them.  ``torch.distributed.tensor`` is
imported only where a mesh is used (it takes a second to import).

Training over a mesh differentiates through the collectives.  Where its
input needs a gradient, each collective is a ``torch.autograd.Function``
whose backward is its exact adjoint: ``all_reduce``'s is an all-reduce
of the gradient, ``all_gather``'s a ``reduce_scatter`` (the gradient
summed over the group, the rank's slice kept); a slice (``redistribute``
to a ``Shard``) is an ordinary autograd op.  The one
convention every backward follows: the objective is the sum over the
mesh's ranks of each rank's own loss, and each rank's loss is the
global loss (the same number on every rank, its sums reduced over
``data``) divided by the mesh's size (``launch/steps.value_and_grad``).
So the gradient a rank holds of any tensor is its share of the whole,
and the shares sum to the gradient over the ranks that hold that
tensor: work done identically on several ranks (a norm of the same
rows on every model rank) gets 1/W of the gradient on each and counts
once.  A parameter held whole along a mesh dim (``Replicate``) is
used by every rank of that dim, so its
gradient is the all-reduce of the ranks' shares over that dim
(``steps.value_and_grad``); a sharded one's reaches the rank whole
through the reduce-scatters.  Without a gradient (serving, under
``torch.no_grad``) a collective runs as before: in place, no copy.
``gather_data`` is the FSDP gather: a parameter placed by the train
rules (cut over ``data`` along ``embed``) gathered over the data dims
to the placements the decode rules give it, once at each use (again on
a remat recompute); its backward reduce-scatters the gradient back to
the rank's FSDP shard.

``recording`` keeps, beside the counts, each collective as an event:
its kind, its group's size, the bytes the rank sent in, and the tags
open where it was issued (``tagged``: the train step tags each
microbatch, ``kernels/ops.cached_per_weight`` what it makes for its
cache; a backward collective carries the tags of its forward).
The dry-run reads a step's schedule from them
(``launch/collectives.py``).
"""
from __future__ import annotations

import collections
import contextlib
import sys
import threading

import torch
import torch.distributed as dist

# kind -> calls, and kind + "_bytes" -> bytes a rank sent into them,
# since the process started or the caller last cleared it
COLLECTIVES: collections.Counter = collections.Counter()


class _Recording(threading.local):
    def __init__(self):
        self.lists: list[list] = []   # the open recordings' events
        self.tags: dict = {}
        self.paused = False


_REC = _Recording()


@contextlib.contextmanager
def recording():
    """A list that receives, while the block runs, one event a
    collective: (kind, group size, bytes sent, the tags as a sorted
    tuple of (name, value))."""
    events: list = []
    _REC.lists.append(events)
    try:
        yield events
    finally:
        _REC.lists.remove(events)


def current_tags() -> dict:
    """The tags open here (``tagged``)."""
    return _REC.tags


@contextlib.contextmanager
def tagged(**tags):
    """The collectives issued within the block carry ``tags`` (beside
    the enclosing block's)."""
    before = _REC.tags
    _REC.tags = {**before, **tags}
    try:
        yield
    finally:
        _REC.tags = before


def is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_of(xs):
    """The mesh of the first DTensor among ``xs`` (None: all plain)."""
    return next((x.device_mesh for x in xs if is_dtensor(x)), None)


def local(x):
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def global_shape(local_shape, mesh, placements) -> tuple:
    shape = list(local_shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    return tuple(shape)


def wrap(t: torch.Tensor, mesh, placements, shape=None):
    """``t``, this rank's shard, as a DTensor of ``shape`` (default: the
    local shape scaled by the sharded dims)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape) if shape is not None else \
        global_shape(t.shape, mesh, placements)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def wrap_like(t: torch.Tensor, like):
    """A local result as a DTensor with ``like``'s mesh and placements
    (its sharded dims must mean what they meant in ``like``); plain
    when ``like`` is plain."""
    return wrap(t, like.device_mesh, like.placements) if is_dtensor(like) \
        else t


def on_local(fn, x, *args, **kw):
    """``fn`` over the local shards of ``x`` and of any DTensor among
    ``args``, re-wrapped with ``x``'s placements: a row-wise function
    (a norm over a dim ``x`` holds whole, a head reshape, RoPE, the
    attention of the rank's heads)."""
    return wrap_like(fn(local(x), *(local(a) for a in args), **kw), x)


def replicate(t: torch.Tensor, mesh):
    """A tensor every rank holds whole, as a DTensor."""
    return wrap(t, mesh, [_replicate()] * mesh.ndim)


def transpose(x):
    """A 2-D tensor's transpose; a DTensor's is a view of its shard with
    the sharded dims swapped."""
    if not is_dtensor(x):
        return x.t()
    from torch.distributed.tensor import Shard
    pl = [Shard(1 - p.dim) if p.is_shard() else p for p in x.placements]
    return wrap(x.to_local().t(), x.device_mesh, pl, (x.shape[1], x.shape[0]))


# --------------------------------------------------------------- collectives


def _count(kind: str, t: torch.Tensor, group: int):
    nbytes = t.numel() * t.element_size()
    COLLECTIVES[kind] += 1
    COLLECTIVES[kind + "_bytes"] += nbytes
    if _REC.lists and not _REC.paused:
        event = (kind, group, nbytes, tuple(sorted(_REC.tags.items())))
        for events in _REC.lists:
            events.append(event)


def _moves(t: torch.Tensor) -> bool:
    """Whether a collective has values to move: a ``meta`` tensor (the
    dry-run's, under a fake group) has none, so only its shape is made
    (and the call counted)."""
    return t.device.type != "meta"


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _all_reduce(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    _count("all_reduce", t, mesh.size(dim))
    t = t.contiguous()
    if _moves(t):
        dist.all_reduce(t, group=mesh.get_group(dim))
    return t


def _all_gather(t: torch.Tensor, mesh, dim: int, along: int) -> torch.Tensor:
    _count("all_gather", t, mesh.size(dim))
    t = t.contiguous()
    n = mesh.size(dim)
    if not _moves(t):
        # no values to move: the parts and their concatenation as shapes
        parts = t.new_empty((n, *t.shape))
        shape = list(t.shape)
        shape[along] *= n
        out = t.new_empty(shape)
        del parts
        return out
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group(dim))
    return torch.cat(parts, along)


def reduce_scatter(t: torch.Tensor, mesh, dim: int, along: int
                   ) -> torch.Tensor:
    """The sum of ``t`` over mesh dim ``dim``'s ranks, of which this
    rank keeps its slice along tensor dim ``along`` (the slices in rank
    order, as ``all_gather`` concatenates them): the adjoint of
    ``all_gather``."""
    n = mesh.size(dim)
    _count("reduce_scatter", t, n)
    x = t.movedim(along, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if _moves(x):
        dist.reduce_scatter_tensor(out, x, group=mesh.get_group(dim))
    return out.movedim(0, along)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim, ctx.tags = mesh, dim, _REC.tags
        return _all_reduce(t.clone(), mesh, dim)

    @staticmethod
    def backward(ctx, g):
        with tagged(**ctx.tags):
            return _all_reduce(g.clone(), ctx.mesh, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim, along):
        ctx.mesh, ctx.dim, ctx.along = mesh, dim, along
        ctx.tags = _REC.tags
        return _all_gather(t, mesh, dim, along)

    @staticmethod
    def backward(ctx, g):
        with tagged(**ctx.tags):
            return (reduce_scatter(g, ctx.mesh, ctx.dim, ctx.along), None,
                    None, None)


def all_reduce(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The sum of ``t`` over mesh dim ``dim``'s ranks (without a
    gradient ``t`` itself is overwritten: pass a fresh partial result;
    with one, a new tensor whose backward all-reduces the gradient)."""
    if _needs_grad(t):
        return _AllReduce.apply(t, mesh, dim)
    return _all_reduce(t, mesh, dim)


def all_reduce_max(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The elementwise max of ``t`` over mesh dim ``dim``'s ranks, in
    place and without a gradient (a shift that leaves its result
    unchanged: the vocab-parallel logsumexp's); counted and recorded as
    an ``all_reduce``."""
    if _needs_grad(t):
        raise ValueError("all_reduce_max: the input needs a gradient")
    _count("all_reduce", t, mesh.size(dim))
    t = t.contiguous()
    if _moves(t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(dim))
    return t


def all_gather(t: torch.Tensor, mesh, dim: int, along: int) -> torch.Tensor:
    """Mesh dim ``dim``'s ranks' ``t``, concatenated along tensor dim
    ``along`` in rank order (its backward: ``reduce_scatter``)."""
    if _needs_grad(t):
        return _AllGather.apply(t, mesh, dim, along)
    return _all_gather(t, mesh, dim, along)


# --------------------------------------------------------------- placements


def redistribute(x, placements):
    """DTensor ``x`` moved to ``placements``: gathers (a Shard that
    changes) in reverse mesh-dim order, then slices (to a Shard) in
    mesh-dim order, so two mesh dims on one tensor dim nest as
    ``layers.common.to_placements`` lays them out.  A slice needs no
    collective."""
    mesh = x.device_mesh
    cur, want = list(x.placements), list(placements)
    if cur == want:
        return x
    t = x.to_local()
    for i in reversed(range(mesh.ndim)):
        if cur[i] != want[i] and cur[i].is_shard():
            t = all_gather(t, mesh, i, cur[i].dim)
            cur[i] = _replicate()
        elif not (cur[i].is_shard() or cur[i].is_replicate()):
            raise ValueError(f"redistribute: placement {cur[i]} on mesh "
                             f"dim {i}")
    coord = mesh.get_coordinate()
    for i in range(mesh.ndim):
        if cur[i] != want[i]:
            t = torch.chunk(t, mesh.size(i), want[i].dim)[coord[i]]
            cur[i] = want[i]
    return wrap(t.contiguous(), mesh, want, x.shape)


def place(t: torch.Tensor, mesh, placements):
    """A DTensor of ``t`` over ``mesh``, where every rank holds the whole
    of ``t`` (weights drawn from one seed, a zeroed pool): each rank
    keeps its slice (a copy, so the whole can be freed, and a rank's
    writes reach no other: tensors handed to spawned ranks share their
    memory), and no collective runs."""
    x = replicate(t, mesh)
    return wrap(redistribute(x, placements).to_local().clone(), mesh,
                placements, t.shape)


def full(x) -> torch.Tensor:
    """The whole tensor on every rank (gathered: a concatenation, so
    exact); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return redistribute(x, [_replicate()] * x.device_mesh.ndim).to_local()


def whole(x, dim: int):
    """``x`` with tensor dim ``dim`` held whole on every rank (gathered
    where it is cut), its other placements kept; a plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    return redistribute(x, [_replicate() if p.is_shard() and p.dim == dim
                            else p for p in x.placements])


DATA_DIMS = ("pod", "data")   # the mesh dims of the batch axis


def data_dims(mesh) -> list[int]:
    """The mesh dims the train rules cut a parameter's ``embed`` over."""
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n in DATA_DIMS]


def gather_data(x):
    """A parameter placed by the train rules with its shards over the
    data dims gathered (FSDP: module docstring), its other placements
    kept: the placements the decode rules give it.  A plain tensor, or
    a DTensor held whole over those dims, as it is."""
    if not is_dtensor(x):
        return x
    dims = data_dims(x.device_mesh)
    if not any(x.placements[i].is_shard() for i in dims):
        return x
    return redistribute(x, [_replicate() if i in dims else p
                            for i, p in enumerate(x.placements)])


def gather_data_tree(tree):
    """``gather_data`` at every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: gather_data_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_data_tree(v) for v in tree]
    return gather_data(tree)


def all_rows(x):
    """``x`` with its leading (row) dim held whole on every rank, its
    other placements kept; a plain tensor as it is."""
    return whole(x, 0)


def mesh_dims(x, dim: int) -> list[int]:
    """The mesh dims that cut tensor dim ``dim`` of ``x`` (none of a
    plain tensor)."""
    if not is_dtensor(x):
        return []
    return [i for i, p in enumerate(x.placements)
            if p.is_shard() and p.dim == dim]


def rank_slice(x, dim: int) -> tuple[int, int]:
    """(start, length) of this rank's slice of tensor dim ``dim`` of
    ``x`` in the whole (mesh dims nested in order, as ``redistribute``
    lays them out); (0, the length) for a plain tensor."""
    if not is_dtensor(x):
        return 0, x.shape[dim]
    n, start = x.shape[dim], 0
    coord = x.device_mesh.get_coordinate()
    for i in mesh_dims(x, dim):
        n //= x.device_mesh.size(i)
        start += coord[i] * n
    return start, n


def rows(t: torch.Tensor, like) -> torch.Tensor:
    """The rows of a per-row tensor ``t`` (every rank holds all of them:
    a block table, the lengths) that ``like``'s local shard holds."""
    if not is_dtensor(like):
        return t
    mesh, coord = like.device_mesh, like.device_mesh.get_coordinate()
    for i, p in enumerate(like.placements):
        if p.is_shard() and p.dim == 0:
            t = torch.chunk(t, mesh.size(i), 0)[coord[i]]
    return t


def shards(x, dim: int) -> int:
    """How many pieces tensor dim ``dim`` of ``x`` is cut into (1 for a
    plain tensor)."""
    if not is_dtensor(x):
        return 1
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim:
            n *= x.device_mesh.size(i)
    return n


def check_agree(t: torch.Tensor, mesh, what: str):
    """Raise unless every rank of ``mesh`` holds the same ``t``: along
    each mesh dim the ranks' copies are gathered and compared (a debug
    check; its gathers are neither counted in ``COLLECTIVES`` nor
    recorded)."""
    before, paused = COLLECTIVES.copy(), _REC.paused
    _REC.paused = True
    try:
        for i in range(mesh.ndim):
            parts = all_gather(t[None], mesh, i, 0)
            if not all(torch.equal(p, parts[0]) for p in parts):
                raise RuntimeError(
                    f"{what}: the ranks of mesh dim "
                    f"{mesh.mesh_dim_names[i]!r} disagree: "
                    f"{parts.cpu().tolist()}")
    finally:
        _REC.paused = paused
        COLLECTIVES.clear()
        COLLECTIVES.update(before)
