"""Whisper-style encoder-decoder. The conv / log-mel frontend is a stub, as
in the reference: the inputs are precomputed frame embeddings (B, F, D).

PyTorch port of the reference's ``repro.models.encdec``, the scans over
stacked layers unrolled as Python loops. Encoder: bidirectional
self-attention blocks, rope on positions 0..F-1. Decoder: causal
self-attention, cross-attention, MLP. Decode state: the per-layer self KV
cache {"k","v"} (L, B, Kh, max_seq, hd), written in place, and the cross
K/V {"ck","cv"} (L, B, Kh, F, hd) computed once by ``encdec_decode_init``
and only read.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import remat_call


class EncLayer(nn.Module):
    def __init__(self, ln1, attn_p, ln2, mlp):
        super().__init__()
        self.ln1 = ln1
        self.attn = attn_p
        self.ln2 = ln2
        self.mlp = mlp


class DecLayer(nn.Module):
    def __init__(self, ln1, attn_p, lnx, xattn, ln2, mlp):
        super().__init__()
        self.ln1 = ln1
        self.attn = attn_p
        self.lnx = lnx
        self.xattn = xattn
        self.ln2 = ln2
        self.mlp = mlp


class EncDec(nn.Module):
    """The reference's param tree: ``embed``, ``enc_layers``, ``enc_norm``,
    ``dec_layers``, ``final_norm``."""

    def __init__(self, embed, enc_layers, enc_norm, dec_layers, final_norm):
        super().__init__()
        self.embed = embed
        self.enc_layers = nn.ModuleList(enc_layers)
        self.enc_norm = enc_norm
        self.dec_layers = nn.ModuleList(dec_layers)
        self.final_norm = final_norm


def init_enc_layer(gen: torch.Generator, cfg) -> EncLayer:
    dev = gen.device
    return EncLayer(L.init_rmsnorm(cfg.d_model, cfg, dev),
                    attn.init_attention(gen, cfg),
                    L.init_rmsnorm(cfg.d_model, cfg, dev),
                    L.init_mlp(gen, cfg))


def init_dec_layer(gen: torch.Generator, cfg) -> DecLayer:
    dev = gen.device
    return DecLayer(L.init_rmsnorm(cfg.d_model, cfg, dev),
                    attn.init_attention(gen, cfg),
                    L.init_rmsnorm(cfg.d_model, cfg, dev),
                    attn.init_cross_attention(gen, cfg),
                    L.init_rmsnorm(cfg.d_model, cfg, dev),
                    L.init_mlp(gen, cfg))


def spec_enc_layer() -> dict:
    return {"ln1": L.spec_rmsnorm(), "attn": attn.spec_attention(),
            "ln2": L.spec_rmsnorm(), "mlp": L.spec_mlp()}


def spec_dec_layer() -> dict:
    return {"ln1": L.spec_rmsnorm(), "attn": attn.spec_attention(),
            "lnx": L.spec_rmsnorm(), "xattn": attn.spec_attention(),
            "ln2": L.spec_rmsnorm(), "mlp": L.spec_mlp()}


def spec_encdec(cfg) -> dict:
    """{parameter name: logical axes} of ``init_encdec``'s module."""
    return {**L.named_specs({"embed": L.spec_embedding(cfg)}),
            **L.per_layer_specs("enc_layers", cfg.enc_layers,
                                spec_enc_layer()),
            **L.named_specs({"enc_norm": L.spec_rmsnorm()}),
            **L.per_layer_specs("dec_layers", cfg.n_layers,
                                spec_dec_layer()),
            **L.named_specs({"final_norm": L.spec_rmsnorm()})}


def encdec_cache_logical(cfg) -> dict:
    del cfg
    return {"kv": L.stack_spec(attn.cache_logical()),
            "cross": L.stack_spec(
                {"ck": ("cache_batch", "cache_kv_heads", None, None),
                 "cv": ("cache_batch", "cache_kv_heads", None, None)})}


def init_encdec(gen: torch.Generator, cfg) -> EncDec:
    """Every parameter drawn from ``gen`` on its device: the embedding, the
    encoder layers, then the decoder layers."""
    dev = gen.device
    emb = L.init_embedding(gen, cfg)
    enc = [init_enc_layer(gen, cfg) for _ in range(cfg.enc_layers)]
    dec = [init_dec_layer(gen, cfg) for _ in range(cfg.n_layers)]
    return EncDec(emb, enc, L.init_rmsnorm(cfg.d_model, cfg, dev), dec,
                  L.init_rmsnorm(cfg.d_model, cfg, dev))


def encode(params: EncDec, cfg, frames, *, remat="nothing"):
    """frames (B,F,D) stub embeddings -> encoder states (B,F,D); each layer
    checkpointed as ``remat`` says."""
    h = frames.to(L.cdtype_of(cfg))
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def body(hh, lp):
        hh = hh + attn.attn_train(lp.attn, cfg,
                                  L.rmsnorm(lp.ln1, hh, cfg.norm_eps),
                                  positions, causal=False)
        return hh + L.mlp(lp.mlp, L.rmsnorm(lp.ln2, hh, cfg.norm_eps), cfg)

    for lp in params.enc_layers:
        h = remat_call(remat, partial(body, lp=lp), h, modules=(lp,))
    return L.rmsnorm(params.enc_norm, h, cfg.norm_eps)


def decoder_forward(params: EncDec, cfg, tokens, enc_out, *,
                    remat="nothing"):
    h = L.embed(params.embed, tokens, cfg)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def body(hh, lp):
        hh = hh + attn.attn_train(lp.attn, cfg,
                                  L.rmsnorm(lp.ln1, hh, cfg.norm_eps),
                                  positions, causal=True)
        ckv = attn.cross_kv(lp.xattn, cfg, enc_out)
        hh = hh + attn.attn_cross(lp.xattn, cfg,
                                  L.rmsnorm(lp.lnx, hh, cfg.norm_eps), ckv)
        return hh + L.mlp(lp.mlp, L.rmsnorm(lp.ln2, hh, cfg.norm_eps), cfg)

    for lp in params.dec_layers:
        h = remat_call(remat, partial(body, lp=lp), h, modules=(lp,))
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return L.unembed(params.embed, h, cfg)


def encdec_forward(params: EncDec, cfg, batch, *, remat="nothing", **_):
    enc_out = encode(params, cfg, batch["frames"], remat=remat)
    return decoder_forward(params, cfg, batch["tokens"], enc_out,
                           remat=remat), {}


def encdec_decode_init(params: EncDec, cfg, batch) -> dict:
    """Runs the encoder, precomputes every layer's cross K/V and allocates
    the self caches. batch: {"frames": (B,F,D), "max_seq": int}; a batch
    without ``frames`` raises ``KeyError: 'frames'``, as the reference's."""
    frames = batch["frames"]
    max_seq = batch["max_seq"]
    enc_out = encode(params, cfg, frames)
    ckv = [attn.cross_kv(lp.xattn, cfg, enc_out) for lp in params.dec_layers]
    one = attn.init_cache(cfg, frames.shape[0], max_seq, enc_out.device)
    return {"kv": L.stacked(cfg.n_layers, one),
            "cross": {name: torch.stack([c[name] for c in ckv])
                      for name in ("ck", "cv")}}


def encdec_decode_step(params: EncDec, cfg, cache, tokens, pos):
    """tokens (B,1) -> (logits (B,1,V), cache); the self KV written in
    place."""
    h = L.embed(params.embed, tokens, cfg)
    for i, lp in enumerate(params.dec_layers):
        c = {name: t[i] for name, t in cache["kv"].items()}
        a, _ = attn.attn_decode(lp.attn, cfg,
                                L.rmsnorm(lp.ln1, h, cfg.norm_eps), c, pos)
        h = h + a
        ckv = {name: t[i] for name, t in cache["cross"].items()}
        h = h + attn.attn_cross(lp.xattn, cfg,
                                L.rmsnorm(lp.lnx, h, cfg.norm_eps), ckv)
        h = h + L.mlp(lp.mlp, L.rmsnorm(lp.ln2, h, cfg.norm_eps), cfg)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return L.unembed(params.embed, h, cfg), cache
