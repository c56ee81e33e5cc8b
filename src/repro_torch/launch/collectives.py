"""A step's collective record and memory, read from a run on one rank's
``meta`` shards: the port's counterpart of the JAX package's
``launch/hlo_analysis.py`` (and of its dry-run's ``memory_summary``).

JAX reads the schedule from the optimized HLO.  The port has no HLO:
the dry-run runs the step itself under a fake process group, where
every collective goes through ``dist/spmd.py`` and is recorded as an
event (kind, group size, bytes the rank sent in, the microbatch tag),
and ``LiveBytes`` counts the bytes the step allocates.

The record has JAX's keys and byte meaning.  Per kind (JAX's spelling:
``KINDS``) a ``count`` and ``bytes_static`` over one pass of each
scanned body (a layer period of ``transformer.segments``' scan segment,
one microbatch) with what runs outside them, and ``bytes_executed``
over the whole step; bytes are those of the collective's result, as
JAX counts an HLO op's result shape (an all-gather's are the group
times its input, a reduce-scatter's its input over the group).
``entries`` (kind, group, calls, sent bytes, trips) give both.

A step at full depth is too slow to walk on meta for a sweep, so the
dry-run runs the step twice, with a and a + 1 periods of the scan
segment (the unrolled leading layers whole), two microbatches each,
and ``scale`` carries every count and byte to the whole depth by the
difference, as ``known_trip_count`` carries a while body's: whatever
the second run adds is one period's, and the rest is outside the
scan (the gradient norm's stacks grow with the leaves: a byte count
that moves by the period).  A microbatch's events are taken once for
the static count and ``microbatches`` times for the executed one (the
update's, untagged, once).  Temp bytes scale the same way: the peak of
a remat step grows by a period's saved inputs or gradients, that of a
serving step by what a period keeps (an SSM layer's new state), from
the second layer on: a step of one layer may peak lower (musicgen's
train step then peaks without a layer output and a layer's gradients
that every deeper one holds), so where a period is one layer the runs
are at two and three (a = 2).
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist import spmd

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# spmd's kind -> JAX's
JAX_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter"}

NO_GENERATED_CODE = ("torch runs the step eagerly and compiles no program, "
                     "so there is no generated code to size")


def result_bytes(kind: str, group: int, sent: int) -> int:
    """The bytes of a collective's result on a rank, from the bytes it
    sent in (``kind`` in spmd's spelling)."""
    if kind == "all_gather":
        return sent * group
    if kind == "reduce_scatter":
        return sent // group
    return sent


def analyze(entries) -> dict:
    """JAX's ``analyze_collectives`` record from ``entries``: (spmd
    kind, group size, calls, bytes sent in all of them, trips), the
    calls counted once statically and ``trips`` times executed."""
    stats = {k: {"count": 0, "bytes_static": 0, "bytes_executed": 0}
             for k in KINDS}
    for kind, group, calls, sent, trips in entries:
        s = stats[JAX_KIND[kind]]
        b = result_bytes(kind, group, sent)
        s["count"] += calls
        s["bytes_static"] += b
        s["bytes_executed"] += b * trips
    stats["total_bytes_static"] = sum(stats[k]["bytes_static"]
                                      for k in KINDS)
    stats["total_bytes_executed"] = sum(stats[k]["bytes_executed"]
                                        for k in KINDS)
    return stats


def sent_totals(entries) -> dict:
    """The whole step's calls and sent bytes by kind, in
    ``spmd.COLLECTIVES``' spelling and meaning."""
    out: collections.Counter = collections.Counter()
    for kind, _group, calls, sent, trips in entries:
        out[kind] += calls * trips
        out[kind + "_bytes"] += sent * trips
    return dict(out)


def _tally(events) -> dict:
    """{(in a microbatch, kind, group): [calls, sent bytes]} of one run's
    events, the microbatch's of microbatch 0 only (the others must be
    alike)."""
    by_mb: dict = collections.defaultdict(collections.Counter)
    for kind, group, sent, tags in events:
        by_mb[dict(tags).get("microbatch")][(kind, group, sent)] += 1
    mbs = sorted(k for k in by_mb if k is not None)
    for i in mbs[1:]:
        if by_mb[i] != by_mb[mbs[0]]:
            raise RuntimeError(f"microbatch {i}'s collectives differ from "
                               f"microbatch {mbs[0]}'s")
    out: dict = collections.defaultdict(lambda: [0, 0])
    for mb in ([mbs[0]] if mbs else []) + [None]:
        for (kind, group, sent), n in by_mb.get(mb, {}).items():
            cell = out[(mb is not None, kind, group)]
            cell[0] += n
            cell[1] += n * sent
    return out


def affine(va, vb, a: int, n: int):
    """The value at ``n`` periods of a count that is ``va`` at ``a``
    periods and ``vb`` at ``a + 1``."""
    return va + (n - a) * (vb - va)


def scale(run_a: dict, run_b: dict, a: int, periods: int,
          microbatches: int) -> tuple[list, dict]:
    """(entries, memory) of the whole step of ``periods`` periods from
    its runs at ``a`` and ``a + 1`` (where one run is the whole depth,
    ``run_b`` is ``run_a``); a run is ``{"events": spmd events}`` and,
    where they were measured, its "peaks" (``LiveBytes.peaks``), its
    "output" and "alias" bytes (module docstring).  The temp bytes are
    the largest of the phases' peaks, each scaled on its own."""
    ta, tb = _tally(run_a["events"]), _tally(run_b["events"])
    entries = []
    for key in sorted(set(ta) | set(tb)):
        in_mb, kind, group = key
        ca, ba = ta.get(key, (0, 0))
        cb, bb = tb.get(key, (0, 0))
        if not in_mb:
            # outside the scans: static is executed; its count is fixed
            if ca != cb:
                raise RuntimeError(f"{kind} over {group} outside the "
                                   f"microbatches: {ca} calls at {a} "
                                   f"periods, {cb} at {a + 1}")
            entries.append((kind, group, ca, affine(ba, bb, a, periods), 1))
            continue
        # a period's calls (the second run's extra), and the rest
        cp, bp = cb - ca, bb - ba
        if ca - a * cp:
            entries.append((kind, group, ca - a * cp, ba - a * bp,
                            microbatches))
        if cp:
            entries.append((kind, group, cp, bp, microbatches * periods))
    memory = {k: affine(run_a[k], run_b[k], a, periods)
              for k in ("output", "alias") if k in run_a}
    if "peaks" in run_a:
        # each phase's peak grows by the period; the phase that peaks
        # highest may change with the depth
        memory["temp"] = max(
            affine(run_a["peaks"].get(k, 0), run_b["peaks"].get(k, 0), a,
                   periods) for k in set(run_a["peaks"]) | set(run_b["peaks"]))
    return entries, memory


def _storages(x, out: dict):
    """{storage id: storage} of the tensors in ``x`` (nested lists,
    tuples and dicts; a DTensor's local shard's) into ``out``."""
    t = type(x)
    if t is torch.Tensor:
        st = x.untyped_storage()
        out[st._cdata] = st
    elif t is list or t is tuple:
        for v in x:
            if not isinstance(v, (int, float, bool)):
                _storages(v, out)
    elif t is dict:
        for v in x.values():
            _storages(v, out)
    elif isinstance(x, torch.Tensor):
        _storages(x._local_tensor if spmd.is_dtensor(x) else
                  x.as_subclass(torch.Tensor), out)
    return out


def storages(tree) -> dict:
    """{storage id: bytes} of the tensors of ``tree`` (a DTensor's local
    shard's)."""
    return {k: st.nbytes() for k, st in _storages(tree, {}).items()}


_aten = torch.ops.aten
_BINARY = {_aten.mul.Tensor, _aten.add.Tensor, _aten.sub.Tensor,
           _aten.div.Tensor, _aten.mul.Scalar, _aten.add.Scalar,
           _aten.sub.Scalar, _aten.div.Scalar, _aten.pow.Tensor_Scalar}


# floating elementwise ops whose result is their first argument's shape
# and dtype (the others scalars)
_UNARY = {_aten.exp.default, _aten.neg.default, _aten.rsqrt.default,
          _aten.sqrt.default, _aten.silu.default, _aten.gelu.default,
          _aten.sigmoid.default, _aten.tanh.default, _aten.abs.default,
          _aten.softplus.default, _aten.clamp.default,
          _aten.clamp_min.default, _aten.clamp_max.default,
          _aten.reciprocal.default}


def _broadcast(x: torch.Size, y: torch.Size) -> tuple:
    """``torch.broadcast_shapes`` of two shapes (the common cases first:
    it costs ~0.1 ms a call)."""
    if x == y or not y:
        return x
    if not x:
        return y
    n = max(len(x), len(y))
    x, y = (1,) * (n - len(x)) + tuple(x), (1,) * (n - len(y)) + tuple(y)
    out = []
    for i, j in zip(x, y):
        if i != j and i != 1 and j != 1:
            raise RuntimeError(f"shapes {x} and {y} do not broadcast")
        out.append(j if i == 1 else i)
    return tuple(out)


def _elementwise_meta(func, args, kwargs):
    """The result of a floating elementwise op on a ``meta`` tensor and
    tensors or scalars (contiguous, the broadcast shape, the promoted
    dtype), made here: torch's meta kernels for them run in Python at
    ~0.2 ms an op, most of a step's meta run.  None where it does not
    apply."""
    if func in _UNARY:
        a = args[0]
        if type(a) is torch.Tensor and a.device.type == "meta" and \
                a.dtype.is_floating_point and not any(
                    isinstance(v, torch.Tensor) for v in args[1:]):
            return torch.empty(a.shape, dtype=a.dtype, device="meta")
        return None
    if func is _aten.where.self:
        c, a, b = args
        if all(type(v) is torch.Tensor and v.device.type == "meta"
               for v in args) and a.dtype == b.dtype:
            return torch.empty(_broadcast(_broadcast(c.shape, a.shape),
                                          b.shape),
                               dtype=a.dtype, device="meta")
        return None
    if func not in _BINARY or len(args) != 2 or \
            (kwargs and set(kwargs) != {"alpha"}):
        return None
    a, b = args
    if type(a) is not torch.Tensor or a.device.type != "meta":
        return None
    if type(b) is torch.Tensor:
        if b.device.type != "meta" and b.dim():
            return None
        shape = _broadcast(a.shape, b.shape)
    elif isinstance(b, (int, float)) and not isinstance(b, bool):
        shape = a.shape
    else:
        return None
    dtype = torch.result_type(a, b)
    if not dtype.is_floating_point:
        return None
    return torch.empty(shape, dtype=dtype, device="meta")


def _binary_alike(func, args, kwargs):
    """A binary elementwise op on two DTensors of one spec (the same
    mesh, placements, none partial, and contiguous shape and dtype) run
    on their local shards and placed as they are, which is what DTensor
    does with them: its placement search costs ~0.2 s for each new
    shape on a 3-D mesh.  None where it does not apply."""
    if func not in _BINARY or len(args) != 2:
        return None
    a, b = args
    if not (spmd.is_dtensor(a) and spmd.is_dtensor(b)) or a._spec != b._spec \
            or not a.is_contiguous() \
            or any(p.is_partial() for p in a.placements):
        return None
    from torch.distributed.tensor import DTensor
    la, lb = a._local_tensor, b._local_tensor
    local = _elementwise_meta(func, (la, lb), kwargs)
    if local is None:
        local = func(la, lb, **(kwargs or {}))
    return DTensor(local, a._spec, requires_grad=False)


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages the ops run within the block allocate,
    live (``live``) and at most (``peak``; ``peaks`` by the microbatch
    tag open, None outside one): an op's output whose storage
    none of its inputs holds is new, and its bytes count until the
    storage is freed.  On ``meta`` tensors this is the step's memory
    with nothing allocated.  What a per-weight cache makes at its first
    use (``spmd.tagged(first_use=True)``) is left out: the steady step
    finds it made."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peaks: dict = {}     # the microbatch tag (None: none) -> peak
        self._held: dict = {}     # storage id -> (bytes, weakref to it)

    @property
    def peak(self) -> int:
        return max(self.peaks.values(), default=0)

    def _freed(self, key: int):
        def free(_ref):
            self.live -= self._held.pop(key)[0]
        return free

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = _elementwise_meta(func, args, kwargs)
        if out is None:
            out = _binary_alike(func, args, kwargs)
        if out is None:
            out = func(*args, **(kwargs or {}))
        tags = spmd.current_tags()
        if tags.get("first_use"):
            return out
        new = [kv for kv in _storages(out, {}).items()
               if kv[0] not in self._held]
        if not new:
            return out
        seen = _storages(kwargs, _storages(args, {})) if args or kwargs \
            else {}
        for key, st in new:
            if key in seen:
                continue
            n = st.nbytes()
            self._held[key] = (n, weakref.ref(st, self._freed(key)))
            self.live += n
            phase = tags.get("microbatch")
            if self.live > self.peaks.get(phase, 0):
                self.peaks[phase] = self.live
        return out
