"""Unified model API: every architecture family exposes the same surface.

PyTorch port of the reference's ``repro.models.model``. ``build(cfg)``
returns a :class:`ModelApi` with

  init(seed, device)             -> params (an ``nn.Module``; see
                                    ``transformer.LM``)
  forward(params, batch)         -> (logits, aux)          train / prefill
  loss(params, batch)            -> (scalar, aux)
  decode_init(params, batch|B)   -> cache
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  input_specs(shape)             -> {name: TensorSpec} (no allocation)
  dummy_batch(shape, generator)  -> {name: tensor}

``build`` serves the dense family. The others (moe, vlm, ssm, hybrid,
encdec) raise ``NotImplementedError`` naming their ROADMAP item; the
sharding specs (``param_spec``, ``cache_spec``) wait for the parallel
layer (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf


class TensorSpec(NamedTuple):
    """A shape and dtype stand-in (the reference's ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def _device_of(params) -> torch.device:
    return next(params.parameters()).device


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable                # (seed, device) -> params
    forward: Callable             # (params, batch, **kw) -> (logits, aux)
    decode_init: Callable         # (params, batch | B) -> cache
    decode_step: Callable         # (params, cache, tokens, pos) -> (logits, cache)

    # ------------------------------------------------------------------
    def loss(self, params, batch, **kw):
        """Mean next-token NLL. Labels = batch['labels']."""
        logits, aux = self.forward(params, batch, **kw)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        nll = L.softmax_xent(logits, labels, batch.get("mask"))
        return nll, dict(aux, nll=nll)

    # ------------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig, *,
                    for_decode: Optional[bool] = None,
                    batch_override: Optional[int] = None) -> dict[str, Any]:
        """TensorSpec stand-ins for a (shape) cell — no allocation."""
        B = batch_override or shape.global_batch
        S = shape.seq_len
        decode = shape.is_decode if for_decode is None else for_decode
        if decode:
            return {"tokens": TensorSpec((B, 1), torch.int32)}
        return {"tokens": TensorSpec((B, S), torch.int32),
                "labels": TensorSpec((B, S), torch.int32)}

    def dummy_batch(self, shape: ShapeConfig,
                    generator: Optional[torch.Generator] = None, *,
                    device="cpu", **kw) -> dict[str, Any]:
        """A concrete random batch matching ``input_specs``: drawn from a CPU
        ``generator`` (default: seeded 0), then moved to ``device``."""
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        out = {}
        for name, spec in self.input_specs(shape, **kw).items():
            if spec.dtype.is_floating_point:
                t = torch.randn(spec.shape, generator=gen).to(spec.dtype)
            else:
                t = torch.randint(0, self.cfg.vocab_size, spec.shape,
                                  generator=gen, dtype=spec.dtype)
            out[name] = t.to(device)
        return out


# ---------------------------------------------------------------------------
# Family adapters
# ---------------------------------------------------------------------------

def _build_lm(cfg: ModelConfig) -> ModelApi:       # dense
    def init(seed: int = 0, device="cuda"):
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
        return tf.init_lm(gen, cfg)

    def decode_init(params, batch):
        B = batch["tokens"].shape[0] if isinstance(batch, dict) else batch
        max_seq = batch.get("max_seq", cfg.window or 32768) \
            if isinstance(batch, dict) else (cfg.window or 32768)
        return tf.lm_decode_init(params, cfg, B, max_seq, _device_of(params))

    return ModelApi(
        cfg=cfg,
        init=init,
        forward=lambda p, b, **kw: tf.lm_forward(p, cfg, b, **kw),
        decode_init=decode_init,
        decode_step=lambda p, c, t, pos: tf.lm_decode_step(p, cfg, c, t, pos),
    )


_WAITING = {
    "moe": "the MoE family (moe.py: qwen3, mixtral)",
    "vlm": "the VLM family (its image embeds)",
    "ssm": "the SSM family (ssm.py)",
    "hybrid": "the hybrid family (hybrid.py)",
    "encdec": "the encoder-decoder family (encdec.py)",
}


def build(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "dense":
        return _build_lm(cfg)
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"{_WAITING[cfg.family]} is not ported; it waits for ROADMAP "
            "queue 1, the rest of item 10 (only the dense family is served)")
    raise ValueError(f"unknown model family {cfg.family!r}")
