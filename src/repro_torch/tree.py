"""Ordered walks over the port's parameter trees.

A tree is nested dicts, lists and tuples with tensors at the leaves (the
params, the gradients, the optimizer state).  Dict keys are walked in
sorted order, as ``jax.tree`` walks the JAX package's dicts, so a leaf
has the same index in both packages wherever the two trees have the
same nesting."""
from __future__ import annotations

import torch


def leaves(tree) -> list[torch.Tensor]:
    """The leaves in walk order."""
    out: list = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(tree)
    return out


def paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path (``layers/0/attn/A_log``), in walk order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree)
                for q in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def unflatten(tree_like, values):
    """A tree of ``tree_like``'s structure holding ``values`` in walk
    order (all of them, no more)."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def map_(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``, trees of the same structure), in walk order."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def describe(tree) -> str:
    """The structure as a string (keys and nesting, no values): what
    the checkpoint manifest records as its ``treedef``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    return "*"
