"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 48L d_model=2048 32H GQA(kv=4)
MoE 128 experts top-8, per-expert d_ff=768, vocab 151936. Full attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    moe_d_ff=768,
    n_experts=128,
    top_k=8,
    vocab_size=151936,
    rope_theta=1e6,
)
