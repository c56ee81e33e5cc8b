"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-3B; unverified].

28L d_model=3072 24H GQA(kv=8) d_ff=8192 vocab=128256, SwiGLU, RMSNorm,
RoPE theta 5e5, head_dim 128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, vocab=128256,
    n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, act="swiglu", rope_theta=500000.0,
    norm="rmsnorm", tie_embeddings=True,
)
