"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.  The EnCodec /
conditioning frontend is a STUB in the JAX package (precomputed frame
embeddings (B, T, d_model)); the backbone predicts codebook tokens.  The
port runs the same stub (``logits_fn(..., embeds=...)``).
(MusicGen uses learned positions + LayerNorm + GELU; we keep LayerNorm
+ GELU and use RoPE for positions — noted adaptation.)
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, vocab=2048,
    n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, act="gelu", norm="layernorm",
    frontend="audio",
)
