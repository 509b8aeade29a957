"""Decoder-only LM assembly (dense / MoE / VLM).

PyTorch port of the reference's ``repro.models.transformer``: a loop over
an ``nn.ModuleList`` of layers in place of ``lax.scan`` over stacked layer
params. Caches keep the reference's stacked layout — {"kv": {"k","v"}}
(L, B, Kh, S, hd), with ``kpos`` (L, S) for a sliding window's ring, or the
paged {"kv": {"kp","vp"}} (L, P, Kh, page, hd) — and layer i works on the
i-th slice in place (``models/attention.py``), so the same cache object
comes back. A MoE layer holds ``moe`` (``models/moe.py``) in place of
``mlp``; its aux losses are averaged over the layers, as the reference's
``jnp.mean`` over the scan.

Remat (``remat_call``): ``remat`` names what the backward may SAVE of a
layer, as the reference's ``REMAT_POLICIES`` — "nothing" (the default: the
layer is recomputed, ``torch.utils.checkpoint``), "dots" (a selective
checkpoint that keeps the products' outputs) or "full" (no checkpoint).
``scan_group=g`` checkpoints groups of g layers. Without a gradient to
take (no_grad, or nothing that requires one) a layer runs plain, as
``jax.checkpoint`` is a no-op outside differentiation.

Tensor parallelism over ``model`` (``tensor_parallel``): under a mesh the
embedding, the attention and the dense MLP take this rank's shard of
their vocabulary rows, heads and ``ff`` columns (the mesh step and the
mesh serving gather those leaves over the other axes only). The residual
stream stays whole on every rank: it enters each split block through
``copy_to_model`` (the block's first product, ``layers.py`` and
``attention.py``), and the block's row-parallel output comes back summed
by one all-reduce (``row_parallel``, in f32): two all-reduces a layer
forward. The norms and a whole ``wk``/``wv`` compute replicated, and
their gradients come out whole and equal on every rank. A MoE's experts
keep the replicated path (gathered whole, computed on the whole stream):
expert parallelism is later work. A checkpointed layer's recompute
issues again the all-reduces that come before its last saved tensor
(the attention's, not the MLP's closing one), on every rank in the same
order; it runs in the context of the forward's call, so it sees the
same mesh wherever autograd runs it.
"""
from __future__ import annotations

import contextvars
import itertools
from functools import partial

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


REMAT_POLICIES = ("nothing", "dots", "full")

# the products whose outputs the "dots" policy saves (the reference's
# checkpoint_dots)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.matmul.default,
                   torch.ops.aten.mm.dtype})


def _save_dots(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat: str, fn, *args, modules=()):
    """``fn(*args)``, keeping for the backward what ``remat`` says: a
    checkpoint (non-reentrant) around it for "nothing", a selective one
    saving the products' outputs for "dots", none for "full". ``modules``
    hold the parameters ``fn`` uses; when neither they nor the tensor
    arguments require a gradient, or grad mode is off, ``fn`` runs plain."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; want one of "
                         f"{REMAT_POLICIES}")
    tensors = itertools.chain(
        (a for a in args if isinstance(a, torch.Tensor)),
        *(m.parameters() for m in modules))
    if (remat == "full" or not torch.is_grad_enabled()
            or not any(t.requires_grad for t in tensors)):
        return fn(*args)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = partial(ckpt.create_selective_checkpoint_contexts,
                                   _save_dots)
    # the backward recomputes ``fn`` where autograd runs it: on CUDA, a
    # thread of the engine's own, where the caller's context variables
    # (the active mesh, the batch reduction) are unset; run it in a copy
    # of the caller's, so that the recompute splits and sums as the
    # forward did
    caller = contextvars.copy_context()
    return ckpt.checkpoint(partial(caller.run, fn), *args,
                           use_reentrant=False, preserve_rng_state=False,
                           **kw)


def _is_moe(cfg) -> bool:
    return cfg.n_experts > 0


def tensor_parallel(name: str) -> bool:
    """Whether the forward computes on this rank's shard over ``model`` of
    the parameter ``name`` where its spec splits it there: every leaf but
    a MoE's experts."""
    return ".moe." not in name


class Layer(nn.Module):
    """ln1, attn, ln2, and ``mlp`` (dense) or ``moe`` (MoE)."""

    def __init__(self, ln1, attn_p, ln2, ffn):
        super().__init__()
        self.ln1 = ln1
        self.attn = attn_p
        self.ln2 = ln2
        if isinstance(ffn, moe_mod.MoE):
            self.moe = ffn
        else:
            self.mlp = ffn

    def ffn(self, cfg, x, n_groups: int = 1):
        """The MLP or the MoE block on x -> (y, aux)."""
        if hasattr(self, "moe"):
            return moe_mod.moe_block(self.moe, cfg, x, n_groups=n_groups)
        return L.mlp(self.mlp, x, cfg), {}


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
    ln1 = L.init_rmsnorm(cfg.d_model, cfg, dev)
    a = attn.init_attention(gen, cfg)
    ffn = moe_mod.init_moe(gen, cfg) if _is_moe(cfg) else L.init_mlp(gen, cfg)
    return Layer(ln1, a, L.init_rmsnorm(cfg.d_model, cfg, dev), ffn)


def init_lm(gen: torch.Generator, cfg) -> LM:
    """Every parameter drawn from ``gen`` on its device (embedding first,
    then each layer's attention and MLP or MoE in order), one layer at a
    time."""
    emb = L.init_embedding(gen, cfg)
    layers = [init_layer(gen, cfg) for _ in range(cfg.n_layers)]
    return LM(emb, layers, L.init_rmsnorm(cfg.d_model, cfg, gen.device))


def spec_layer(cfg) -> dict:
    s = {"ln1": L.spec_rmsnorm(), "attn": attn.spec_attention(),
         "ln2": L.spec_rmsnorm()}
    if _is_moe(cfg):
        s["moe"] = moe_mod.spec_moe()
    else:
        s["mlp"] = L.spec_mlp()
    return s


def spec_lm(cfg) -> dict:
    """{parameter name: logical axes} of ``init_lm``'s module."""
    return {**L.named_specs({"embed": L.spec_embedding(cfg)}),
            **L.per_layer_specs("layers", cfg.n_layers, spec_layer(cfg)),
            **L.named_specs({"final_norm": L.spec_rmsnorm()})}


def lm_cache_logical(cfg) -> dict:
    kv = L.stack_spec(attn.cache_logical())
    if cfg.window:  # a ring cache has kpos (S,) a layer
        kv = dict(kv, kpos=(None, "cache_seq"))
    return {"kv": kv}


def lm_paged_cache_logical(cfg) -> dict:
    if cfg.window:
        raise NotImplementedError("paged KV cache needs window=0")
    return {"kv": L.stack_spec(attn.cache_logical(paged=True))}


def layer_fwd(p: Layer, cfg, h, positions, *, n_groups=1,
              return_cache=False):
    """One transformer block (train/prefill). Returns (h, aux), with
    ``return_cache`` (h, aux, {"k","v"})."""
    a = attn.attn_train(p.attn, cfg, L.rmsnorm(p.ln1, h, cfg.norm_eps),
                        positions, causal=True, window=cfg.window,
                        return_cache=return_cache)
    if return_cache:
        a, kv = a
    h = h + a
    y, aux = p.ffn(cfg, L.rmsnorm(p.ln2, h, cfg.norm_eps), n_groups)
    return (h + y, aux, kv) if return_cache else (h + y, aux)


def layer_decode(p: Layer, cfg, h, cache, pos, *, page_table=None):
    a, cache = attn.attn_decode(p.attn, cfg,
                                L.rmsnorm(p.ln1, h, cfg.norm_eps), cache,
                                pos, page_table=page_table)
    h = h + a
    y, _ = p.ffn(cfg, L.rmsnorm(p.ln2, h, cfg.norm_eps))
    return h + y, cache


def _embed_inputs(params: LM, cfg, batch):
    """tokens (+ img_embeds for a VLM, put in front) -> h (B,S,D),
    positions (S,)."""
    h = L.embed(params.embed, batch["tokens"], cfg)
    if cfg.family == "vlm" and "img_embeds" in batch:
        h = torch.cat([batch["img_embeds"].to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    return h, positions


def _mean_aux(auxs: list) -> dict:
    """Each aux loss averaged over the layers."""
    if not auxs or not auxs[0]:
        return {}
    return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def lm_forward(params: LM, cfg, batch, *, remat="nothing", n_groups=1,
               return_cache=False, scan_group=1):
    """-> (logits (B,S,V), aux); aux holds the MoE losses (mean over the
    layers). With ``return_cache`` also the per-layer KV {"k","v"} stacked
    (L, B, Kh, S, hd) (the prefill path).

    ``remat`` per layer (``remat_call``). scan_group=g > 1 checkpoints
    groups of g layers: saved residuals drop g× and recompute grows g× —
    the activation-memory knob for the deepest configs; each group's aux
    is its layers' mean, then the groups' mean is taken."""
    h, positions = _embed_inputs(params, cfg, batch)
    ks, vs, auxs = [], [], []
    if scan_group > 1 and not return_cache:
        if cfg.n_layers % scan_group:
            raise ValueError(f"{cfg.n_layers} layers do not split into "
                             f"groups of {scan_group}")

        def group(hh, lps):
            gaux = []
            for lp in lps:
                hh, aux = layer_fwd(lp, cfg, hh, positions,
                                    n_groups=n_groups)
                gaux.append(aux)
            return hh, ({k: sum(a[k] for a in gaux) / scan_group
                         for k in gaux[0]} if gaux[0] else {})

        for g0 in range(0, cfg.n_layers, scan_group):
            lps = params.layers[g0:g0 + scan_group]
            h, aux = remat_call(remat, partial(group, lps=lps), h,
                                modules=lps)
            auxs.append(aux)
    else:
        for lp in params.layers:
            body = partial(layer_fwd, lp, cfg, positions=positions,
                           n_groups=n_groups, return_cache=return_cache)
            if return_cache:
                h, aux, kv = remat_call(remat, body, h, modules=(lp,))
                ks.append(kv["k"])
                vs.append(kv["v"])
            else:
                h, aux = remat_call(remat, body, h, modules=(lp,))
            auxs.append(aux)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    logits = L.unembed(params.embed, h, cfg)
    if return_cache:
        return (logits, _mean_aux(auxs),
                {"k": torch.stack(ks), "v": torch.stack(vs)})
    return logits, _mean_aux(auxs)


def lm_decode_init(params: LM, cfg, batch_size: int, max_seq: int, device):
    del params
    return {"kv": L.stacked(cfg.n_layers, attn.init_cache(
        cfg, batch_size, max_seq, device))}


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
    return {"kv": L.stacked(cfg.n_layers, attn.init_paged_cache(
        cfg, n_pages, page_size, device))}


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
