"""Architecture registry and the port's hardware configurations.

``get_config(name)`` returns the full-size ModelConfig; ``get_smoke_config(
name)`` returns a reduced same-family config for CPU tests. The ten
``configs/<arch>.py`` data modules and the smoke reductions are the
reference's (``repro.configs``), so a name resolves to the same config, and
a region built from it to the same region name, in both packages.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    HardwareConfig,
    MeshConfig,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    shape_applicable,
)

ARCHS: tuple[str, ...] = (
    "mixtral_8x22b",
    "qwen3_moe_30b_a3b",
    "mamba2_780m",
    "whisper_large_v3",
    "llava_next_34b",
    "minitron_4b",
    "deepseek_coder_33b",
    "gemma_2b",
    "mistral_large_123b",
    "zamba2_1p2b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-780m": "mamba2_780m",
    "whisper-large-v3": "whisper_large_v3",
    "llava-next-34b": "llava_next_34b",
    "minitron-4b": "minitron_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma-2b": "gemma_2b",
    "mistral-large-123b": "mistral_large_123b",
    "zamba2-1.2b": "zamba2_1p2b",
})


def canonical(name: str) -> str:
    """The registry key of an architecture name or alias."""
    key = name.strip().lower()
    if key in ARCHS:
        return key
    if key in _ALIASES:
        return _ALIASES[key]
    key2 = key.replace("-", "_").replace(".", "p")
    if key2 in ARCHS:
        return key2
    raise KeyError(f"unknown architecture {name!r}; known: {sorted(ARCHS)}")


def get_config(name: str) -> ModelConfig:
    """The full-size config of an architecture."""
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced config of the same family: tiny widths/depths/vocab, runnable
    on the CPU."""
    cfg = get_config(name)
    small: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
    )
    if cfg.family == "moe":
        small.update(n_experts=4, top_k=2, moe_d_ff=64)
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32, ssm_expand=2)
    if cfg.family == "hybrid":
        small.update(attn_every=2, n_kv_heads=4)
    if cfg.family == "encdec":
        small.update(enc_layers=2, enc_frames=16)
    if cfg.family == "vlm":
        small.update(n_img_tokens=8)
    if cfg.window:
        small.update(window=16)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
