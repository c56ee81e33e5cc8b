"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H GQA(kv=8) d_ff=14336 vocab=131072 (mistral-nemo
style backbone, head_dim=128).  The pixtral-ViT frontend is a STUB in
the JAX package (precomputed patch embeddings prepended to the text
tokens, frontend_prefix of the sequence).  The port refuses the
front-end until it is ported (ROADMAP.md queue 1, item 6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, vocab=131072,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, act="swiglu", rope_theta=1000000.0,
    norm="rmsnorm", frontend="vlm", frontend_prefix=1024,
)
