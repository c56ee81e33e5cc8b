"""Architecture configuration schema + input-shape cells.

One ``ArchConfig`` per architecture lives in
``repro_torch/configs/<id>.py``; ``repro_torch.configs.get_config(name)``
resolves them.  A field-for-field copy of the JAX package's schema, so
a config compares equal across the two packages.  ``reduced()``
derives the small smoke-test variant of the same family.  The shape
cells (``SHAPES``, ``cells_for``) are the ones the analytic model and
the dry-run sweep.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10000.0
    attn_kind: str = "gqa"           # gqa|mla|none
    # ffn
    d_ff: int = 0
    act: str = "swiglu"              # swiglu|geglu|gelu|relu
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # apply MoE every k-th layer
    first_dense: int = 0             # leading dense layers (DeepSeek)
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # routed expert width (if != d_ff)
    dense_d_ff: int = 0              # width of the leading dense layers
    capacity_factor: float = 1.25
    moe_dispatch_groups: int = 1     # >1: shard-local dispatch (see moe.py)
    # mla
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    attn_period: int = 0             # hybrid: 1 attention layer per period
    attn_offset: int = 0             # index within the period that is attn
    # misc
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: x *= sqrt(d_model)
    frontend: str = "none"           # none|audio|vlm
    frontend_prefix: int = 0         # patch/frame prefix length in the seq
    precision: str = "bf16"          # bf16|bnn_train|bnn (OXBNN mode)
    scan_period: int = 1             # layers grouped per scan step
    remat_policy: str = "nothing"    # nothing|dots (save matmul/collective
                                     # outputs: trades memory for not
                                     # re-running TP all-reduces in remat)
    tp_reduce_bf16: bool = False     # bf16 partial sums for TP-sharded
                                     # expert GEMMs: halves the MoE
                                     # all-reduce bytes (numerics note in
                                     # EXPERIMENTS §Perf)
    # attention chunking (flash)
    q_chunk: int = 512
    kv_chunk: int = 1024
    ssd_chunk: int = 256

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell: an SSM or hybrid mixer, or
        a sliding window."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # train|prefill|decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cells_for(cfg: ArchConfig) -> list[ShapeCell]:
    """The shape cells that run for this arch (long_500k only if
    sub-quadratic)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        cells.append(SHAPES["long_500k"])
    return cells


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    kw: dict = dict(
        n_layers=max(2, cfg.scan_period if cfg.scan_period > 1 else 2),
        d_model=64, vocab=128,
    )
    if cfg.attn_period:
        kw["n_layers"] = cfg.attn_period  # one full hybrid period
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)),
                  head_dim=16)
    if cfg.d_ff:
        kw["d_ff"] = 128
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=64,
                  dense_d_ff=128 if cfg.first_dense else 0)
    if cfg.kv_lora_rank:
        kw.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16, q_lora_rank=0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=8, ssm_expand=2)
    if cfg.frontend_prefix:
        kw["frontend_prefix"] = 8
    kw["sliding_window"] = 32 if cfg.sliding_window else None
    kw["q_chunk"], kw["kv_chunk"], kw["ssd_chunk"] = 16, 16, 8
    return cfg.replace(name=cfg.name + "-reduced", **kw)
