"""jamba-1.5-large-398b [arXiv:2403.19887; hf].

72L d_model=8192 64H GQA(kv=8) d_ff=24576 vocab=65536; hybrid
Mamba:attention 7:1 (1 attention layer per period of 8, offset 3 as in
the published block), MoE 16 experts top-2 every 2nd layer.  Mamba
sublayers use the Mamba-2 SSD block (d_state=16 per the Jamba paper) —
noted adaptation: Jamba v1 uses Mamba-1 selective scan; SSD is the
equivalent formulation the JAX package runs.  The paged engine keeps a
recurrent slot per request for the SSD layers and paged K/V blocks for
the attention layers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, vocab=65536,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, act="swiglu",
    n_experts=16, top_k=2, moe_every=2,
    ssm_state=16, ssm_expand=2, ssm_headdim=128, ssm_conv=4,
    attn_period=8, attn_offset=3, scan_period=8,
    norm="rmsnorm",
    # 0 = auto: the data-parallel degree in the JAX package; the one-card
    # port dispatches in one group
    moe_dispatch_groups=0,
)
