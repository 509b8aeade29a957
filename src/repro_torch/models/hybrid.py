"""Zamba2-style hybrid: a stack of Mamba2 blocks with ONE shared
attention + MLP block applied every ``attn_every`` layers (weight sharing).

PyTorch port of the reference's ``repro.models.hybrid``. The reference
scans the layers and runs the shared block under ``lax.cond``; here the
layers are a Python loop and the branch is a Python ``if`` on the layer
index, so the shared block runs before the Mamba block of layers 0,
attn_every, 2·attn_every, ... The attention cache is stacked per
invocation, (n_invocations, B, Kh, max_seq, hd), and invocation
``idx // attn_every`` works on its slice IN PLACE (``models/attention.py``);
the Mamba states come back as new tensors (``models/ssm.py``).
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.transformer import remat_call


def n_invocations(cfg) -> int:
    return -(-cfg.n_layers // cfg.attn_every)


class Shared(nn.Module):
    """The shared block: ln1, attn, ln2, mlp."""

    def __init__(self, ln1, attn_p, ln2, mlp):
        super().__init__()
        self.ln1 = ln1
        self.attn = attn_p
        self.ln2 = ln2
        self.mlp = mlp


class Hybrid(nn.Module):
    """The reference's param tree: ``embed``, ``mamba`` (one ``ssm.Block`` a
    layer), ``shared``, ``final_norm``."""

    def __init__(self, embed, mamba, shared, final_norm):
        super().__init__()
        self.embed = embed
        self.mamba = nn.ModuleList(mamba)
        self.shared = shared
        self.final_norm = final_norm


def init_hybrid(gen: torch.Generator, cfg) -> Hybrid:
    """Every parameter drawn from ``gen`` on its device: the embedding, the
    Mamba blocks in order, then the shared block."""
    dev = gen.device
    emb = L.init_embedding(gen, cfg)
    mamba = [ssm.init_block(gen, cfg) for _ in range(cfg.n_layers)]
    shared = Shared(L.init_rmsnorm(cfg.d_model, cfg, dev),
                    attn.init_attention(gen, cfg),
                    L.init_rmsnorm(cfg.d_model, cfg, dev),
                    L.init_mlp(gen, cfg))
    return Hybrid(emb, mamba, shared, L.init_rmsnorm(cfg.d_model, cfg, dev))


def spec_hybrid(cfg) -> dict:
    """{parameter name: logical axes} of ``init_hybrid``'s module."""
    shared = {"ln1": L.spec_rmsnorm(), "attn": attn.spec_attention(),
              "ln2": L.spec_rmsnorm(), "mlp": L.spec_mlp()}
    return {**L.named_specs({"embed": L.spec_embedding(cfg)}),
            **L.per_layer_specs("mamba", cfg.n_layers, ssm.spec_block()),
            **L.named_specs({"shared": shared,
                             "final_norm": L.spec_rmsnorm()})}


def hybrid_cache_logical(cfg) -> dict:
    del cfg
    return {"ssm": L.stack_spec(ssm.ssm_cache_logical()),
            "kv": L.stack_spec(attn.cache_logical())}


def _shared_block(sp: Shared, cfg, h, positions):
    a = attn.attn_train(sp.attn, cfg, L.rmsnorm(sp.ln1, h, cfg.norm_eps),
                        positions, causal=True)
    h = h + a
    return h + L.mlp(sp.mlp, L.rmsnorm(sp.ln2, h, cfg.norm_eps), cfg)


def hybrid_forward(params: Hybrid, cfg, batch, *, remat="nothing", **_):
    """Each layer (the shared block where it runs, then the Mamba block)
    checkpointed as ``remat`` says, as the reference's scan body."""
    h = L.embed(params.embed, batch["tokens"], cfg)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    sp = params.shared

    def body(hh, idx, lp):
        if idx % cfg.attn_every == 0:
            hh = _shared_block(sp, cfg, hh, positions)
        return hh + ssm.ssm_block(lp.ssm, cfg,
                                  L.rmsnorm(lp.ln, hh, cfg.norm_eps))

    for idx, lp in enumerate(params.mamba):
        h = remat_call(remat, partial(body, idx=idx, lp=lp), h,
                       modules=(lp, sp))
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return L.unembed(params.embed, h, cfg), {}


def hybrid_decode_init(params: Hybrid, cfg, batch_size: int, max_seq: int,
                       device) -> dict:
    """{"ssm": {"state","conv"} stacked (L, ...), "kv": {"k","v"} stacked
    (n_invocations, B, Kh, max_seq, hd)}."""
    del params
    return {"ssm": L.stacked(cfg.n_layers,
                             ssm.init_ssm_cache(cfg, batch_size, device)),
            "kv": L.stacked(n_invocations(cfg),
                            attn.init_cache(cfg, batch_size, max_seq,
                                            device))}


def hybrid_decode_step(params: Hybrid, cfg, cache, tokens, pos):
    """tokens (B,1) -> (logits (B,1,V), cache). The KV stack is written in
    place (and returned); the Mamba states come back as new tensors."""
    h = L.embed(params.embed, tokens, cfg)
    sp = params.shared
    states, convs = [], []
    for idx, lp in enumerate(params.mamba):
        if idx % cfg.attn_every == 0:
            inv = idx // cfg.attn_every
            c = {name: t[inv] for name, t in cache["kv"].items()}
            a, _ = attn.attn_decode(sp.attn, cfg,
                                    L.rmsnorm(sp.ln1, h, cfg.norm_eps), c,
                                    pos)
            h = h + a
            h = h + L.mlp(sp.mlp, L.rmsnorm(sp.ln2, h, cfg.norm_eps), cfg)
        sc = {name: t[idx] for name, t in cache["ssm"].items()}
        out, new_sc = ssm.ssm_decode_step(
            lp.ssm, cfg, L.rmsnorm(lp.ln, h, cfg.norm_eps), sc)
        h = h + out
        states.append(new_sc["state"])
        convs.append(new_sc["conv"])
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return L.unembed(params.embed, h, cfg), {
        "ssm": {"state": torch.stack(states), "conv": torch.stack(convs)},
        "kv": cache["kv"]}
