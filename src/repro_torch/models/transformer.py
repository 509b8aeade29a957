"""Decoder-only LM assembly, dense family.

PyTorch port of the dense branch of the reference's
``repro.models.transformer``: a loop over an ``nn.ModuleList`` of layers in
place of ``lax.scan`` over stacked layer params. Caches keep the
reference's stacked layout — {"kv": {"k","v"}} (L, B, Kh, S, hd), or the
paged {"kv": {"kp","vp"}} (L, P, Kh, page, hd) — and layer i works on the
i-th slice in place (``models/attention.py``), so the same cache object
comes back. The MoE branch raises (ROADMAP queue 1, the rest of item 10).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import layers as L

_MOE = ("the MoE layers (moe.py) are not ported; they wait for qwen3 / "
        "mixtral (ROADMAP queue 1, the rest of item 10)")


class Layer(nn.Module):
    def __init__(self, ln1, attn_p, ln2, mlp):
        super().__init__()
        self.ln1 = ln1
        self.attn = attn_p
        self.ln2 = ln2
        self.mlp = mlp


class LM(nn.Module):
    """The reference's param tree: ``embed``, ``layers`` (one module a layer
    where the reference stacks them on a leading L axis), ``final_norm``."""

    def __init__(self, embed, layers, final_norm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


def init_layer(gen: torch.Generator, cfg) -> Layer:
    dev = gen.device
    return Layer(L.init_rmsnorm(cfg.d_model, cfg, dev),
                 attn.init_attention(gen, cfg),
                 L.init_rmsnorm(cfg.d_model, cfg, dev),
                 L.init_mlp(gen, cfg))


def init_lm(gen: torch.Generator, cfg) -> LM:
    """Every parameter drawn from ``gen`` on its device (embedding first,
    then each layer's attention and MLP in order)."""
    if cfg.n_experts:
        raise NotImplementedError(_MOE)
    emb = L.init_embedding(gen, cfg)
    layers = [init_layer(gen, cfg) for _ in range(cfg.n_layers)]
    return LM(emb, layers, L.init_rmsnorm(cfg.d_model, cfg, gen.device))


def layer_fwd(p: Layer, cfg, h, positions, *, return_cache=False):
    """One transformer block (train/prefill). Returns (h, aux), with
    ``return_cache`` (h, aux, {"k","v"})."""
    a = attn.attn_train(p.attn, cfg, L.rmsnorm(p.ln1, h, cfg.norm_eps),
                        positions, causal=True, window=cfg.window,
                        return_cache=return_cache)
    if return_cache:
        a, kv = a
    h = h + a
    x = L.rmsnorm(p.ln2, h, cfg.norm_eps)
    h = h + L.mlp(p.mlp, x, cfg)
    return (h, {}, kv) if return_cache else (h, {})


def layer_decode(p: Layer, cfg, h, cache, pos, *, page_table=None):
    a, cache = attn.attn_decode(p.attn, cfg,
                                L.rmsnorm(p.ln1, h, cfg.norm_eps), cache,
                                pos, page_table=page_table)
    h = h + a
    x = L.rmsnorm(p.ln2, h, cfg.norm_eps)
    return h + L.mlp(p.mlp, x, cfg), cache


def _embed_inputs(params: LM, cfg, batch):
    """tokens -> h (B,S,D), positions (S,)."""
    if "img_embeds" in batch:
        raise NotImplementedError("the VLM image embeds are not ported "
                                  "(ROADMAP queue 1, the rest of item 10)")
    h = L.embed(params.embed, batch["tokens"], cfg)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    return h, positions


def lm_forward(params: LM, cfg, batch, *, return_cache=False):
    """-> (logits (B,S,V), aux); with ``return_cache`` also the per-layer
    KV {"k","v"} stacked (L, B, Kh, S, hd) (the prefill path)."""
    h, positions = _embed_inputs(params, cfg, batch)
    ks, vs = [], []
    for lp in params.layers:
        if return_cache:
            h, _, kv = layer_fwd(lp, cfg, h, positions, return_cache=True)
            ks.append(kv["k"])
            vs.append(kv["v"])
        else:
            h, _ = layer_fwd(lp, cfg, h, positions)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    logits = L.unembed(params.embed, h, cfg)
    if return_cache:
        return logits, {}, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, {}


def _stacked(cfg, one: dict) -> dict:
    return {name: torch.zeros((cfg.n_layers,) + tuple(t.shape),
                              dtype=t.dtype, device=t.device)
            for name, t in one.items()}


def lm_decode_init(params: LM, cfg, batch_size: int, max_seq: int, device):
    del params
    return {"kv": _stacked(cfg, attn.init_cache(cfg, batch_size, max_seq,
                                                device))}


def lm_prefill(params: LM, cfg, batch, max_seq: int):
    """Full-sequence prefill -> (logits (B,S,V), decode cache padded to
    ``max_seq``)."""
    logits, _aux, kv = lm_forward(params, cfg, batch, return_cache=True)

    def pad(x):  # (L,B,Kh,S,hd) -> (L,B,Kh,max_seq,hd)
        Ln, b, h, S, d = x.shape
        buf = torch.zeros((Ln, b, h, max_seq, d), dtype=x.dtype,
                          device=x.device)
        buf[:, :, :, :S] = x
        return buf

    return logits, {"kv": {"k": pad(kv["k"]), "v": pad(kv["v"])}}


def _layer_cache(cache: dict, i: int) -> dict:
    """Layer i's slice of a stacked cache (views: writes land in place)."""
    return {name: t[i] for name, t in cache["kv"].items()}


def lm_decode_step(params: LM, cfg, cache, tokens, pos):
    """tokens (B,1) -> (logits (B,1,V), cache). pos: scalar or (B,) int."""
    h = L.embed(params.embed, tokens, cfg)
    for i, lp in enumerate(params.layers):
        h, _ = layer_decode(lp, cfg, h, _layer_cache(cache, i), pos)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return L.unembed(params.embed, h, cfg), cache


# ---------------------------------------------------------------------------
# Paged serving path (models/attention.py paged layout)
# ---------------------------------------------------------------------------

def lm_paged_decode_init(params: LM, cfg, n_pages: int, page_size: int,
                         device):
    """Per-layer page pools stacked (L, P, Kh, page, hd). The page table is
    NOT part of the cache: slot->page assignment is a host (engine) decision
    and is passed into each decode step as a plain operand."""
    del params
    return {"kv": _stacked(cfg, attn.init_paged_cache(cfg, n_pages,
                                                      page_size, device))}


def lm_paged_prefill(params: LM, cfg, batch, cache, page_rows):
    """Batched prefill of a whole admission wave, scattered into the pool.

    batch {"tokens": (B, Sp)} — B admitted prompts right-padded to a common
    Sp (a multiple of the page size); page_rows (B, Sp // page) pool page
    ids covering each prompt's padded extent (non-admitted rows point every
    entry at a trash page). Returns (logits (B, Sp, V), cache).
    """
    logits, _aux, kv = lm_forward(params, cfg, batch, return_cache=True)
    for i in range(cfg.n_layers):
        attn.paged_prefill_scatter(_layer_cache(cache, i),
                                   {"k": kv["k"][i], "v": kv["v"][i]},
                                   page_rows)
    return logits, cache


def lm_paged_decode_step(params: LM, cfg, cache, tokens, pos, page_table):
    """tokens (B,1), pos (B,), page_table (B, max_pages) ->
    (logits (B,1,V), cache). Every layer reads the same table."""
    h = L.embed(params.embed, tokens, cfg)
    for i, lp in enumerate(params.layers):
        h, _ = layer_decode(lp, cfg, h, _layer_cache(cache, i), pos,
                            page_table=page_table)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return L.unembed(params.embed, h, cfg), cache
