"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6] — LM backbone (Yi-34B-like):
60L d_model=7168 56H GQA(kv=8) d_ff=20480 vocab=64000. Anyres vision tiling is a
STUB: input_specs() provides precomputed patch embeddings (up to 5 tiles x 576)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    n_img_tokens=2880,      # 5 anyres tiles x 576 patches
    rope_theta=5e6,
)
