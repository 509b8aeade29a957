"""Mixtral 8x22B [arXiv:2401.04088; hf] — 56L d_model=6144 48H GQA(kv=8)
MoE 8 experts top-2, per-expert d_ff=16384, vocab 32768, sliding-window attention
(window 4096 per assignment)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,                 # no dense MLP; experts only
    moe_d_ff=16384,
    n_experts=8,
    top_k=2,
    vocab_size=32768,
    window=4096,            # SWA -> sub-quadratic rolling KV cache
    rope_theta=1e6,
)
