"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936, QKV bias, SwiGLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, vocab=151936,
    n_heads=16, n_kv_heads=16, head_dim=64, qkv_bias=True,
    d_ff=2816, act="swiglu", rope_theta=1000000.0,
    norm="rmsnorm", tie_embeddings=True,
)
