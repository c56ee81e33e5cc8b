"""Convert the JAX package's parameter pytree into the port's params.

The caller hands over the pytree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``), so this module needs neither
jax nor the JAX package.  The JAX layout stacks each repeated layer
period along a leading axis for ``lax.scan`` (``segments(cfg)``); the
port keeps one dict per layer, so the stacked segment is unstacked in
the same walk as the JAX package's ``_iter_layers`` (a period may mix
mixer and FFN kinds under its ``l{i}`` keys, as jamba's period of 8
does: SSD and GQA mixers, dense and MoE FFNs); a leading unrolled
segment (DeepSeek's dense first layer) is already one dict per
layer.  Every leaf converts alike: attention, MLA (q, kv_down,
k_up, v_up, o), MoE leaves (router, the (E, d_in, d_out) expert
stacks, the shared FFN) and Mamba-2 leaves (in_proj, conv_w, conv_b,
A_log, D, dt_bias, norm, out_proj).  A tied head becomes ``embed.w.T`` (a view:
the two share storage).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import check_supported, segments


def _tensors(tree, device, index: int | None = None):
    """Nested dict/list of numpy arrays -> same structure of tensors,
    optionally taking ``[index]`` along the leading (stacked) axis."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device, index) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, index) for v in tree]
    arr = np.asarray(tree)
    if index is not None:
        arr = arr[index]
    if arr.dtype == np.uint32:            # packed words: same bits, int32
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def params_from_numpy(tree: dict, cfg, device="cpu") -> dict:
    """JAX-layout numpy params -> the port's params (see
    ``models/transformer.py`` for the layout)."""
    check_supported(cfg)
    params = {"embed": _tensors(tree["embed"], device),
              "final_norm": _tensors(tree["final_norm"], device)}
    params["head"] = ({"w": params["embed"]["w"].t()} if cfg.tie_embeddings
                      else _tensors(tree["head"], device))
    layers = []
    for (kind, plan, n_groups), seg in zip(segments(cfg), tree["segments"],
                                           strict=True):
        if kind == "unroll":
            layers.extend(_tensors(p, device) for p in seg)
            continue
        for gi in range(n_groups):
            for li in range(len(plan)):
                layers.append(_tensors(seg[f"l{li}"], device, gi))
    params["layers"] = layers
    return params
