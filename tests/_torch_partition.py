"""Helpers of the partitioning tests: the JAX package's spec and shape
trees in the port's layout (one dict per layer), and a stand-in mesh."""
import jax

from repro.models import transformer as JM
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as MESH


class FakeMesh:
    def __init__(self, multi_pod: bool):
        shape, axes = MESH.mesh_layout(multi_pod)
        self.shape = dict(zip(axes, shape))


def is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def unstack_layers(jtree, jcfg, drop_layers_axis: bool):
    """The JAX segments' per-layer trees in plan order (the walk of
    ``interop.params_from_numpy``); a scanned leaf's leading "layers"
    axis dropped (specs) or indexed away (shapes)."""
    out = []
    for (kind, plan, n_groups), seg in zip(JM.segments(jcfg),
                                           jtree["segments"], strict=True):
        if kind == "unroll":
            out.extend(seg if drop_layers_axis else
                       [jax.tree.map(lambda s: s.shape, c) for c in seg])
            continue
        for gi in range(n_groups):
            for li in range(len(plan)):
                cell = seg[f"l{li}"]
                if drop_layers_axis:
                    out.append(jax.tree.map(
                        lambda a: (assert_layers(a), a[1:])[1], cell,
                        is_leaf=is_axes))
                else:
                    out.append(jax.tree.map(lambda s: s.shape[1:], cell))
    return out


def assert_layers(axes):
    assert axes[0] == "layers", axes


def flat_port(specs, tree, path=()):
    """{path: (axes, shape)} over a port spec tree and its tensors."""
    if S.is_axes(specs):
        return {path: (specs, tuple(tree.shape))}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    out = {}
    for k, v in items:
        out.update(flat_port(v, tree[k], path + (k,)))
    return out


def flat_jax(jcfg, jspecs, jshapes):
    """{path: (axes, shape)} in the port's layout from JAX's trees."""
    top = {k: v for k, v in jspecs.items() if k != "segments"}
    top_shapes = {k: jax.tree.map(lambda s: s.shape, jshapes[k])
                  for k in top}
    layers_s = unstack_layers(jspecs, jcfg, True)
    layers_x = unstack_layers(jshapes, jcfg, False)
    out = {}

    def walk(s, x, path):
        if is_axes(s):
            out[path] = (tuple(s), tuple(x))
            return
        for k in s:
            walk(s[k], x[k], path + (k,))
    for k in top:
        walk(top[k], top_shapes[k], (k,))
    for i, (s, x) in enumerate(zip(layers_s, layers_x, strict=True)):
        walk(s, x, ("layers", i))
    return out
