"""bnn-lm-100m — the paper-native config: a ~100M decoder LM whose
projections all run in OXBNN binarized mode (STE training / packed
XNOR-popcount inference)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bnn-lm-100m", family="dense",
    n_layers=12, d_model=768, vocab=32000,
    n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=2048, act="swiglu", norm="rmsnorm", tie_embeddings=True,
    precision="bnn_train",
)
