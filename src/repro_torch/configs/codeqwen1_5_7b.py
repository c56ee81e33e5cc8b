"""codeqwen1.5-7b — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf].

32L d_model=4096 32H GQA(kv=32 => MHA) d_ff=13440 vocab=92416, SwiGLU,
QKV bias, RoPE theta 1e6, head_dim 128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, vocab=92416,
    n_heads=32, n_kv_heads=32, head_dim=128, qkv_bias=True,
    d_ff=13440, act="swiglu", rope_theta=1000000.0,
    norm="rmsnorm",
)
