"""Analytic FLOP / HBM-byte model per (arch x shape) cell.

The count of the work one step does: the forward's matmul and attention
FLOPs, the executed total with the backward, remat and the optimizer,
the HBM bytes, and the model FLOPs (6 N D for training, 2 N D for
inference, N the active parameters).  A line-for-line port of the JAX
package's ``repro.launch.analytic``, which mirrors the einsums the
layers perform; there it stands in for XLA's cost analysis, which
counts a while-loop body once.  The port has no HLO: the tests and
``chip_smoke.py`` hold the model against ``torch.utils.flop_counter``
instead.

Conventions: a matmul of (m,k)x(k,n) costs 2mkn FLOPs.  Backward costs
2x forward (dgrad+wgrad); per-layer remat recomputes forward once.

``roofline_terms`` divides by one NVIDIA H100 SXM5's data-sheet peaks,
the card ``nvidia-smi`` names "NVIDIA H100 80GB HBM3" at a 700.00 W
power limit; a card set below 700 W runs slower under load.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models.transformer import layer_plan

# hardware constants: NVIDIA H100 SXM5 data sheet (dense, no sparsity),
# for the card nvidia-smi reports as "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989.4e12      # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12           # HBM3 bytes/s per card
LINK_BW = 450e9            # NVLink 4 bytes/s per card, one direction


@dataclass
class CellModel:
    flops_fwd: float          # global forward matmul+attention FLOPs
    flops_total: float        # executed incl. bwd + remat + optimizer
    hbm_bytes: float          # global HBM traffic per step
    model_flops: float        # 6*N(_active)*D (train) / 2*N_active*D (infer)
    params_total: float
    params_active: float
    notes: dict


def _attn_avg_len(cell: ShapeCell, window) -> float:
    t = cell.seq_len
    if cell.kind == "decode":
        return float(min(t, window) if window else t)
    if window and window < t:
        # sum_t min(t, w) / T  ~= w * (1 - w/(2T))
        return window * (1.0 - window / (2.0 * t))
    return (t + 1) / 2.0


def _layer_fwd_flops_per_tok(cfg: ArchConfig, mix: str, f: str,
                             t_eff: float, dense_prefix: bool) -> float:
    d = cfg.d_model
    fl = 0.0
    if mix == "gqa":
        h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        fl += 2 * d * h * dh + 2 * 2 * d * hkv * dh + 2 * h * dh * d
        fl += 2 * 2 * h * dh * t_eff                       # scores + AV
    elif mix == "mla":
        h = cfg.n_heads
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        r = cfg.kv_lora_rank
        fl += 2 * d * h * qk                               # q (or q_lora pair)
        fl += 2 * d * (r + cfg.qk_rope_head_dim)           # kv_down
        fl += 2 * r * h * cfg.qk_nope_head_dim             # k_up
        fl += 2 * r * h * cfg.v_head_dim                   # v_up
        fl += 2 * h * (qk + cfg.v_head_dim) * t_eff        # scores + AV
        fl += 2 * h * cfg.v_head_dim * d                   # o
    elif mix == "ssm":
        din = cfg.ssm_expand * d
        hh = din // cfg.ssm_headdim
        g, n, p = 1, cfg.ssm_state, cfg.ssm_headdim
        conv_ch = din + 2 * g * n
        dproj = 2 * din + 2 * g * n + hh
        fl += 2 * d * dproj + 2 * conv_ch * cfg.ssm_conv
        L = cfg.ssd_chunk
        fl += 2 * L * n                                    # C.B within chunk
        fl += 2 * L * hh * p                               # y_intra
        fl += 2 * 2 * hh * p * n                           # states + y_inter
        fl += 2 * din * d                                  # out_proj
    if f == "dense":
        width = cfg.dense_d_ff if dense_prefix and cfg.dense_d_ff else cfg.d_ff
        nmats = 3 if cfg.act in ("swiglu", "geglu") else 2
        fl += 2 * nmats * d * width
    elif f == "moe":
        width = cfg.moe_d_ff or cfg.d_ff
        nmats = 3 if cfg.act in ("swiglu", "geglu") else 2
        fl += 2 * d * cfg.n_experts                        # router
        fl += 2 * nmats * d * width * cfg.capacity_factor * cfg.top_k
        if cfg.n_shared_experts:
            fl += 2 * nmats * d * width * cfg.n_shared_experts
    return fl


def _named_leaves(tree, key=None):
    """(the leaf's own key, leaf) over a params tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, None)
    else:
        yield key, tree


@functools.lru_cache(maxsize=None)
def _params(cfg: ArchConfig) -> tuple[float, float]:
    """(total, active-per-token) parameter counts (analytic), over the
    ``meta`` params' trainable leaves: a tied head is the embedding and
    counts once.  Cached by config (the dry-run asks per cell)."""
    from repro_torch.models import transformer as M

    shapes = M.trainable(M.abstract_init(cfg), cfg)
    total = active = 0.0
    for key, leaf in _named_leaves(shapes):
        n = float(leaf.numel())
        total += n
        # expert stacks are leaves named gate/up/down of shape (E, din,
        # dout); dense FFN and shared-expert weights sit one level
        # deeper under "w"
        if key in ("gate", "up", "down") and leaf.ndim >= 3:
            frac = (cfg.top_k / cfg.n_experts) if cfg.n_experts else 1.0
            active += n * frac
        else:
            active += n
    return total, active


def cell_model(cfg: ArchConfig, cell: ShapeCell, *, microbatches: int = 8,
               remat: bool = True) -> CellModel:
    plan = layer_plan(cfg)
    t_eff = _attn_avg_len(cell, cfg.sliding_window)
    n_tok = cell.tokens if cell.kind != "decode" else cell.global_batch
    d, v = cfg.d_model, cfg.vocab

    fwd = 0.0
    for i, (mix, f) in enumerate(plan):
        fwd += n_tok * _layer_fwd_flops_per_tok(
            cfg, mix, f, t_eff, dense_prefix=(i < cfg.first_dense))
    # lm head / loss logits
    if cell.kind == "train":
        fwd += 2.0 * n_tok * d * v
    else:
        fwd += 2.0 * cell.global_batch * d * v

    params_total, params_active = _params(cfg)

    if cell.kind == "train":
        layers_fwd = fwd - 2.0 * n_tok * d * v
        flops_total = 3.0 * fwd + (layers_fwd if remat else 0.0) \
            + 10.0 * params_total
        model_flops = 6.0 * params_active * n_tok
    else:
        flops_total = fwd
        model_flops = 2.0 * params_active * n_tok

    # ---- HBM bytes (global) ----
    pbytes = params_total * 2.0
    act_bytes_per_layer = 4.0 * n_tok * d * 2.0
    n_layers = cfg.n_layers
    if cell.kind == "train":
        reads = (3.0 if remat else 2.0) * pbytes * microbatches
        grads = 2.0 * params_total * 4.0 * microbatches      # fp32 accum r+w
        opt = 6.0 * params_total * 4.0                       # p,m,v r+w
        acts = act_bytes_per_layer * n_layers * (2.0 if remat else 3.0)
        hbm = reads + grads + opt + acts
    elif cell.kind == "prefill":
        hbm = pbytes + act_bytes_per_layer * n_layers
        # kv write-back
        hbm += 2.0 * n_tok * cfg.n_kv_heads * cfg.head_dim * 2.0 * \
            sum(1 for m, _ in plan if m == "gqa")
    else:  # decode
        hbm = pbytes  # weights stream once per batched step
        b = cell.global_batch
        for mix, f in plan:
            if mix == "gqa":
                s_eff = min(cell.seq_len, cfg.sliding_window) if \
                    cfg.sliding_window else cell.seq_len
                hbm += 2.0 * b * s_eff * cfg.n_kv_heads * cfg.head_dim * 2.0
            elif mix == "mla":
                hbm += b * cell.seq_len * \
                    (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2.0
            else:
                din = cfg.ssm_expand * d
                hh = din // cfg.ssm_headdim
                hbm += 2.0 * b * hh * cfg.ssm_state * cfg.ssm_headdim * 4.0

    return CellModel(
        flops_fwd=fwd, flops_total=flops_total, hbm_bytes=hbm,
        model_flops=model_flops, params_total=params_total,
        params_active=params_active,
        notes={"t_eff": t_eff, "n_tok": n_tok, "remat": remat,
               "microbatches": microbatches if cell.kind == "train" else 0})


def roofline_terms(cm: CellModel, coll_bytes_executed: float,
                   n_devices: int) -> dict:
    """The three roofline terms, in seconds (per step, per device), at
    the H100's data-sheet peaks (``PEAK_FLOPS``, ``HBM_BW``,
    ``LINK_BW``)."""
    compute_s = cm.flops_total / (n_devices * PEAK_FLOPS)
    memory_s = cm.hbm_bytes / (n_devices * HBM_BW)
    # collective bytes are per device
    collective_s = coll_bytes_executed / LINK_BW
    dominant = max(
        [("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)], key=lambda kv: kv[1])[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "step_s_bound": total,
        "useful_flops_fraction": cm.model_flops / cm.flops_total,
        "roofline_fraction": (cm.model_flops / (n_devices * PEAK_FLOPS)) / total
        if total > 0 else 0.0,
    }
