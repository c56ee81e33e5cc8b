"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=2048, attention-free, no FFN, vocab=50280, ssm_state=128,
expand=2, headdim=64, conv=4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab=50280,
    attn_kind="none", d_ff=0,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    norm="rmsnorm", tie_embeddings=True,
)
