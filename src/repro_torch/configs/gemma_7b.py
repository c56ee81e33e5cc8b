"""gemma-7b [arXiv:2403.08295; hf].

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000, GeGLU,
head_dim=256, embeddings scaled by sqrt(d_model), tied head.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, vocab=256000,
    n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, act="geglu", rope_theta=10000.0,
    norm="rmsnorm", tie_embeddings=True, embed_scale=True,
)
