"""mixtral-8x7b [arXiv:2401.04088; hf].

32L d_model=4096 32H GQA(kv=8) d_ff=14336 vocab=32000, MoE 8 experts
top-2 every layer, sliding-window attention (4096): the paged engine
runs its block tables as window-sized rings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, vocab=32000,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, act="swiglu", rope_theta=1000000.0,
    n_experts=8, top_k=2, moe_every=1,
    sliding_window=4096, norm="rmsnorm",
    # 0 = auto: the data-parallel degree in the JAX package; the one-card
    # port dispatches in one group
    moe_dispatch_groups=0,
)
