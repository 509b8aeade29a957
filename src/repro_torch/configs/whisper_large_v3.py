"""Whisper large-v3 [arXiv:2212.04356] — encoder-decoder, 32L enc + 32L dec,
d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866. Conv frontend is a STUB:
input_specs() provides precomputed log-mel frame embeddings (1500 frames)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,            # decoder layers
    enc_layers=32,
    enc_frames=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    act="geglu",            # whisper uses plain gelu MLP; geglu is our gated variant
    vocab_size=51866,
)
