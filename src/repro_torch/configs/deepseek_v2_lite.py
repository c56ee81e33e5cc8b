"""deepseek-v2-lite-16b [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(routed)=1408 vocab=102400, MLA kv_lora=512
(qk_nope=128, qk_rope=64, v_head=128), MoE 64 routed experts top-6 + 2
shared, first layer dense (d_ff=10944).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, vocab=102400,
    n_heads=16, attn_kind="mla",
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, q_lora_rank=0,
    d_ff=0, dense_d_ff=10944, moe_d_ff=1408, act="swiglu",
    n_experts=64, top_k=6, moe_every=1, first_dense=1, n_shared_experts=2,
    norm="rmsnorm",
    # 0 = auto: the data-parallel degree in the JAX package; the one-card
    # port dispatches in one group
    moe_dispatch_groups=0,
)
