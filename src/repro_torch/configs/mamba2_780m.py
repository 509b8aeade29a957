"""Mamba2-780m [arXiv:2405.21060] — 48L d_model=1536, attention-free SSD
(state-space duality), ssm_state=128, expand 2, headdim 64, vocab 50280."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    ssm_conv=4,
    ssm_ngroups=1,
    tie_embeddings=True,
)
