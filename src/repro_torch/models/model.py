"""Unified model API: every architecture family exposes the same surface.

PyTorch port of the reference's ``repro.models.model``. ``build(cfg)``
returns a :class:`ModelApi` with

  init(seed, device)             -> params (an ``nn.Module``; see
                                    ``transformer.LM``)
  forward(params, batch, remat=) -> (logits, aux)          train / prefill
  loss(params, batch, **kw)      -> (scalar, aux)
  decode_init(params, batch|B)   -> cache
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  input_specs(shape)             -> {name: TensorSpec} (no allocation)
  dummy_batch(shape, generator)  -> {name: tensor}
  param_spec()                   -> {parameter name: logical axes}
  cache_spec()                   -> the cache's tree of logical axes
  tensor_parallel(name)          -> whether the forward computes on a
                                    rank's shard of the parameter over
                                    ``model`` (the transformer family's
                                    leaves but the MoE's experts; no
                                    leaf of the other families)

``build`` serves every family: the decoder-only LMs (dense, moe, and vlm,
whose precomputed patch embeddings ``img_embeds`` go in front of the
tokens), the Mamba2 LM (ssm), the zamba2 hybrid and whisper's
encoder-decoder (whose ``frames`` are precomputed frame embeddings).

The sharding specs name each axis logically, for ``parallel.sharding`` to
resolve on a mesh. ``param_spec`` is keyed by ``named_parameters`` name:
the reference stacks each per-layer leaf on a leading (L, ...) axis named
None and the port holds one module a layer, so the port's spec of
``layers.i.<leaf>`` is the reference's without that entry (no other axis
moves: the port's weights are laid out as the reference's).
``cache_spec`` is the reference's tree as it is, since the caches keep its
stacked layout.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_mod
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
    param_spec: Callable          # () -> {parameter name: logical axes}
    cache_spec: Callable          # () -> cache tree of logical axes
    tensor_parallel: Callable = lambda name: False   # (name) -> bool

    # ------------------------------------------------------------------
    def loss(self, params, batch, **kw):
        """Mean next-token NLL (+ the MoE aux losses). Labels =
        batch['labels']."""
        logits, aux = self.forward(params, batch, **kw)
        # for a VLM the image tokens are in front: score the text tail only
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        nll = L.softmax_xent(logits, labels, batch.get("mask"),
                             vocab=self.cfg.vocab_size)
        total = nll
        if aux:
            total = total + self.cfg.router_aux_coef * aux.get(
                "moe_lb_loss", 0.0) + 1e-3 * aux.get("moe_z_loss", 0.0)
        return total, dict(aux, nll=nll)

    # ------------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig, *,
                    for_decode: Optional[bool] = None,
                    batch_override: Optional[int] = None) -> dict[str, Any]:
        """TensorSpec stand-ins for a (shape) cell — no allocation."""
        cfg = self.cfg
        B = batch_override or shape.global_batch
        S = shape.seq_len
        decode = shape.is_decode if for_decode is None else for_decode
        if decode:
            return {"tokens": TensorSpec((B, 1), torch.int32)}
        specs = {"tokens": TensorSpec((B, S), torch.int32),
                 "labels": TensorSpec((B, S), torch.int32)}
        if cfg.family == "encdec":
            specs["frames"] = TensorSpec(
                (B, cfg.enc_frames, cfg.d_model), L.cdtype_of(cfg))
        if cfg.family == "vlm":
            specs["img_embeds"] = TensorSpec(
                (B, cfg.n_img_tokens, cfg.d_model), L.cdtype_of(cfg))
        return specs

    def dummy_batch(self, shape: ShapeConfig,
                    generator: Optional[torch.Generator] = None, *,
                    device="cuda", **kw) -> dict[str, Any]:
        """A concrete random batch matching ``input_specs``: drawn from a CPU
        ``generator`` (default: seeded 0), then moved to ``device`` (the
        card unless the caller asks for another, as ``init``; without a
        card "cuda" raises, as ``kernels.region.resolve_device`` does)."""
        if torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for a batch on the CPU")
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

def _seeded(init_fn: Callable, cfg: ModelConfig) -> Callable:
    """``init(seed, device)``: ``init_fn(generator, cfg)`` with a generator
    on ``device`` seeded ``seed``. On the meta device (the dry-run), where
    no generator can be made, the same module tree is built of
    uninitialized meta tensors: every name, shape and dtype as on the
    card (``layers.MetaGenerator``)."""
    def init(seed: int = 0, device="cuda"):
        device = torch.device(device)
        if device.type == "meta":
            return init_fn(L.MetaGenerator(), cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_fn(gen, cfg)
    return init


def _batch_size(batch) -> int:
    """A decode_init batch's size: a batch dict's tokens rows, or an int."""
    return batch["tokens"].shape[0] if isinstance(batch, dict) else batch


def _build_lm(cfg: ModelConfig) -> ModelApi:       # dense / moe / vlm
    def decode_init(params, batch):
        max_seq = batch.get("max_seq", cfg.window or 32768) \
            if isinstance(batch, dict) else (cfg.window or 32768)
        return tf.lm_decode_init(params, cfg, _batch_size(batch), max_seq,
                                 _device_of(params))

    return ModelApi(
        cfg=cfg,
        init=_seeded(tf.init_lm, cfg),
        forward=lambda p, b, **kw: tf.lm_forward(p, cfg, b, **kw),
        decode_init=decode_init,
        decode_step=lambda p, c, t, pos: tf.lm_decode_step(p, cfg, c, t, pos),
        param_spec=lambda: tf.spec_lm(cfg),
        cache_spec=lambda: tf.lm_cache_logical(cfg),
        tensor_parallel=tf.tensor_parallel,
    )


def _build_ssm(cfg: ModelConfig) -> ModelApi:
    def forward(params, batch, *, remat="nothing", **_):
        h = L.embed(params.embed, batch["tokens"], cfg)

        def body(hh, lp):
            return hh + ssm_mod.ssm_block(lp.ssm, cfg,
                                          L.rmsnorm(lp.ln, hh, cfg.norm_eps))

        for lp in params.blocks:
            h = tf.remat_call(remat, partial(body, lp=lp), h, modules=(lp,))
        h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
        return L.unembed(params.embed, h, cfg), {}

    def decode_init(params, batch):
        one = ssm_mod.init_ssm_cache(cfg, _batch_size(batch),
                                     _device_of(params))
        return {"ssm": L.stacked(cfg.n_layers, one)}

    def decode_step(params, cache, tokens, pos):
        del pos  # the SSM state is position-free
        h = L.embed(params.embed, tokens, cfg)
        states, convs = [], []
        for i, lp in enumerate(params.blocks):
            sc = {name: t[i] for name, t in cache["ssm"].items()}
            out, new = ssm_mod.ssm_decode_step(
                lp.ssm, cfg, L.rmsnorm(lp.ln, h, cfg.norm_eps), sc)
            h = h + out
            states.append(new["state"])
            convs.append(new["conv"])
        h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
        return L.unembed(params.embed, h, cfg), {
            "ssm": {"state": torch.stack(states),
                    "conv": torch.stack(convs)}}

    return ModelApi(cfg=cfg, init=_seeded(ssm_mod.init_ssm_lm, cfg),
                    forward=forward, decode_init=decode_init,
                    decode_step=decode_step,
                    param_spec=lambda: ssm_mod.spec_ssm_lm(cfg),
                    cache_spec=lambda: {"ssm": L.stack_spec(
                        ssm_mod.ssm_cache_logical())})


def _build_hybrid(cfg: ModelConfig) -> ModelApi:
    def decode_init(params, batch):
        max_seq = batch.get("max_seq", 4096) if isinstance(batch, dict) \
            else 4096
        return hybrid_mod.hybrid_decode_init(
            params, cfg, _batch_size(batch), max_seq, _device_of(params))

    return ModelApi(
        cfg=cfg,
        init=_seeded(hybrid_mod.init_hybrid, cfg),
        forward=lambda p, b, **kw: hybrid_mod.hybrid_forward(p, cfg, b, **kw),
        decode_init=decode_init,
        decode_step=lambda p, c, t, pos: hybrid_mod.hybrid_decode_step(
            p, cfg, c, t, pos),
        param_spec=lambda: hybrid_mod.spec_hybrid(cfg),
        cache_spec=lambda: hybrid_mod.hybrid_cache_logical(cfg))


def _build_encdec(cfg: ModelConfig) -> ModelApi:
    return ModelApi(
        cfg=cfg,
        init=_seeded(encdec_mod.init_encdec, cfg),
        forward=lambda p, b, **kw: encdec_mod.encdec_forward(p, cfg, b, **kw),
        decode_init=lambda p, b: encdec_mod.encdec_decode_init(p, cfg, b),
        decode_step=lambda p, c, t, pos: encdec_mod.encdec_decode_step(
            p, cfg, c, t, pos),
        param_spec=lambda: encdec_mod.spec_encdec(cfg),
        cache_spec=lambda: encdec_mod.encdec_cache_logical(cfg))


LM_FAMILIES = ("dense", "moe", "vlm")

_BUILDERS = {
    "dense": _build_lm,
    "moe": _build_lm,
    "vlm": _build_lm,
    "ssm": _build_ssm,
    "hybrid": _build_hybrid,
    "encdec": _build_encdec,
}


def build(cfg: ModelConfig) -> ModelApi:
    if cfg.family not in _BUILDERS:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return _BUILDERS[cfg.family](cfg)
