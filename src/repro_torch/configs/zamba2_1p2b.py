"""Zamba2-1.2B [arXiv:2411.15242; hf] — hybrid: 38 Mamba2 blocks (d_model=2048,
ssm_state=64) with ONE shared full-attention+MLP block (32H MHA kv=32, d_ff=8192)
re-applied every 6 mamba blocks (weight sharing; per-invocation LoRA omitted —
see DESIGN.md §6)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    ssm_conv=4,
    attn_every=6,
    tie_embeddings=True,
)
