"""Attention: MHA/GQA/MQA with RoPE, full-attention KV caches (dense and
paged), and q-block-chunked scores.

PyTorch port of the dense paths of the reference's
``repro.models.attention``. Scores and softmax stay in f32 with
``NEG_INF = -1e30``, as in the reference; the products are plain
``torch.matmul``, as the reference leaves them to XLA outside any Pallas
kernel.

Cache layout: k, v are (B, Kh, S, hd). Paged layout (serving): one pool of
fixed-size KV pages shared by every slot — ``kp``/``vp`` are (P, Kh, page,
hd) — plus a per-slot int32 page table (B, max_pages) mapping logical page
j of slot b to a pool page id. Logical position t of slot b lives at
pool[table[b, t // page], :, t % page]. Every table entry must be a valid
pool index; the serving engine points unassigned entries at a dedicated
trash page. Reads gather a slot's pages in logical order, so the paged
softmax sees the same keys, in the same order, as the dense layout and the
two are numerically identical.

Unlike the reference, cache writes are IN PLACE (``index_put_`` into the
cache tensors, which are returned): a decode step writes position ``pos``
of each slot and reads positions <= ``pos``, a prefill writes its pages and
reads none, so calling either twice on the same arguments gives the same
outputs and leaves the cache as after the first call.

Not ported (ROADMAP queue 1): the ring cache of sliding-window configs
(``kpos``) and the flash score path (``attn_impl="flash"``), which raise,
and whisper's cross-attention.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import (_normal, apply_rope, cdtype_of,
                                       dtype_of, param, rope_angles)

NEG_INF = -1e30

_RING = ("sliding-window ring caches (kpos) are not ported; they wait for "
         "mixtral (ROADMAP queue 1, the rest of item 10)")
_FLASH = ("attn_impl='flash' is not ported; it waits for training (ROADMAP "
          "queue 1, the rest of item 10)")


class Attention(nn.Module):
    """wq (D, H, hd), wk / wv (D, Kh, hd), wo (H, hd, D)."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq = param(wq)
        self.wk = param(wk)
        self.wv = param(wv)
        self.wo = param(wo)


def init_attention(gen: torch.Generator, cfg) -> Attention:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    return Attention(_normal(gen, (d, h, hd), d ** -0.5, dt),
                     _normal(gen, (d, kh, hd), d ** -0.5, dt),
                     _normal(gen, (d, kh, hd), d ** -0.5, dt),
                     _normal(gen, (h, hd, d), (h * hd) ** -0.5, dt))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(x.dtype)).unflatten(-1, (h, k))


def _project_qkv(p: Attention, cfg, x, positions):
    """x (B,S,D) -> q (B,H,S,hd) roped, k/v (B,Kh,S,hd) roped."""
    x = x.to(cdtype_of(cfg))
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _repeat_kv(cfg, k: torch.Tensor) -> torch.Tensor:
    """Each KV head repeated n_heads // n_kv_heads times (``jnp.repeat`` on
    axis 1, as an expand and a reshape: no host sync, so a CUDA graph can
    capture it)."""
    if cfg.n_heads == cfg.n_kv_heads:
        return k
    B, kh, S, hd = k.shape
    rep = cfg.n_heads // cfg.n_kv_heads
    return k[:, :, None].expand(B, kh, rep, S, hd).reshape(B, kh * rep, S, hd)


def _softmax_attend(q, k, v, keep, out_dtype):
    """f32 scores of q (B,H,Q,hd) against k (B,H,T,hd), masked by ``keep``
    (broadcastable to (B,H,Q,T)), softmax, times v -> (B,H,Q,hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    s = torch.where(keep, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return (w @ v.float()).to(out_dtype)


def _sdpa_blocked(cfg, q, k, v, mask_fn, q_positions, q_block):
    """Blocked-over-queries softmax attention.

    q (B,H,Sq,hd); k,v (B,H,Sk,hd); mask_fn(qpos (Qb,), kidx (Sk,)) ->
    (Qb,Sk) bool keep-mask. Memory peak is O(Qb * Sk) scores instead of
    O(Sq * Sk).
    """
    Sq = q.shape[2]
    kidx = torch.arange(k.shape[2], dtype=torch.int32, device=q.device)

    def block(qb, qpos):
        return _softmax_attend(qb, k, v, mask_fn(qpos, kidx)[None, None],
                               q.dtype)

    if Sq <= q_block:
        return block(q, q_positions)
    if Sq % q_block:  # non-divisible: largest divisor
        q_block = next(d for d in range(q_block, 0, -1) if Sq % d == 0)
    return torch.cat([block(q[:, :, i:i + q_block],
                            q_positions[i:i + q_block])
                      for i in range(0, Sq, q_block)], dim=2)


def _out_proj(p: Attention, cfg, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out (B,H,S,hd) -> (B,S,D)."""
    h, hd, d = p.wo.shape
    B, _, S, _ = attn_out.shape
    flat = attn_out.transpose(1, 2).reshape(B, S, h * hd)
    return flat @ p.wo.reshape(h * hd, d).to(cdtype_of(cfg))


def attn_train(p: Attention, cfg, x, positions, *, causal=True, window=0,
               return_cache=False, q_block=1024):
    """Full-sequence self-attention (train / prefill).

    positions: (S,) int absolute positions. window>0 = sliding window.
    Returns y (B,S,D), and with ``return_cache`` the roped k and raw v
    (B,Kh,S,hd) for a decode cache.
    """
    if cfg.attn_impl == "flash":
        raise NotImplementedError(_FLASH)
    q, k, v = _project_qkv(p, cfg, x, positions)
    kf, vf = _repeat_kv(cfg, k), _repeat_kv(cfg, v)

    def mask_fn(qpos, kidx):
        kpos = positions[kidx]
        keep = torch.ones((qpos.shape[0], kidx.shape[0]), dtype=torch.bool,
                          device=qpos.device)
        if causal:
            keep &= qpos[:, None] >= kpos[None, :]
        if window:
            keep &= qpos[:, None] - kpos[None, :] < window
        return keep

    out = _sdpa_blocked(cfg, q, kf, vf, mask_fn, positions, q_block)
    y = _out_proj(p, cfg, out)
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def init_cache(cfg, batch: int, max_seq: int, device) -> dict:
    """Allocate a full-attention decode cache {"k","v"} (B, Kh, S, hd)."""
    if cfg.window:
        raise NotImplementedError(_RING)
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cdtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=cdtype_of(cfg), device=device)}


def init_paged_cache(cfg, n_pages: int, page_size: int, device) -> dict:
    """Allocate the shared KV page pool: {"kp","vp"} (P, Kh, page, hd).

    No batch dimension — slots share the pool through a page table (see the
    module docstring). Paged caches support full attention only.
    """
    if cfg.window:
        raise NotImplementedError("paged KV cache needs window=0")
    shape = (n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return {"kp": torch.zeros(shape, dtype=cdtype_of(cfg), device=device),
            "vp": torch.zeros(shape, dtype=cdtype_of(cfg), device=device)}


def paged_prefill_scatter(cache: dict, kv: dict, page_rows) -> dict:
    """Scatter a batched-prefill KV into the page pool, in place.

    kv: {"k","v"} (B, Kh, Sp, hd) from ``attn_train(return_cache=True)``;
    Sp must be a multiple of the page size. page_rows (B, Sp // page) pool
    page ids; duplicate ids are only legal for trash pages (rows of a
    padded, non-admitted batch entry), which are never read.
    """
    kp = cache["kp"]
    _, kh, page, hd = kp.shape
    B, _, Sp, _ = kv["k"].shape
    if Sp % page:
        raise ValueError(f"prefill length {Sp} is not a multiple of the "
                         f"page size {page}")
    npp = Sp // page
    flat = page_rows.reshape(B * npp).long()
    for pool, x in ((kp, kv["k"]), (cache["vp"], kv["v"])):
        xb = x.reshape(B, kh, npp, page, hd).transpose(1, 2)
        pool[flat] = xb.reshape(B * npp, kh, page, hd).to(pool.dtype)
    return cache


def attn_decode(p: Attention, cfg, x, cache: dict, pos, *, page_table=None):
    """One-token decode. x (B,1,D).

    pos: scalar int tensor (all slots aligned) or (B,) per-slot positions.
    Writes the token's k/v at ``pos`` (in place) and attends over positions
    <= pos. Paged cache (has "kp"): per-slot positions plus a (B,
    max_pages) ``page_table`` are required.
    """
    if "kp" in cache:
        if pos.ndim != 1 or page_table is None:
            raise ValueError("paged decode needs pos (B,) and a page_table")
        return _attn_decode_paged(p, cfg, x, cache, pos, page_table)
    if pos.ndim == 1:
        return _attn_decode_vec(p, cfg, x, cache, pos)
    S = cache["k"].shape[2]
    positions = pos.reshape(1).to(torch.int32)
    q, k, v = _project_qkv(p, cfg, x, positions)
    cache["k"].index_copy_(2, positions.long(), k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, positions.long(), v.to(cache["v"].dtype))
    kidx = torch.arange(S, dtype=torch.int32, device=x.device)
    keep = kidx <= pos
    kf, vf = _repeat_kv(cfg, cache["k"]), _repeat_kv(cfg, cache["v"])
    out = _softmax_attend(q, kf, vf, keep[None, None, None, :], x.dtype)
    return _out_proj(p, cfg, out), cache


def _attn_decode_vec(p: Attention, cfg, x, cache: dict, pos):
    """Per-slot-position decode (pos (B,)): slot b writes its token at
    ``pos[b]`` of its own cache row; masking is per slot."""
    positions = pos[:, None].to(torch.int32)                   # (B,1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[2]
    b = torch.arange(pos.shape[0], device=x.device)
    ck[b, :, pos.long()] = k[:, :, 0].to(ck.dtype)
    cv[b, :, pos.long()] = v[:, :, 0].to(cv.dtype)

    kidx = torch.arange(S, dtype=torch.int32, device=x.device)
    keep = kidx[None, :] <= pos[:, None]                       # (B,S)
    kf, vf = _repeat_kv(cfg, ck), _repeat_kv(cfg, cv)
    out = _softmax_attend(q, kf, vf, keep[:, None, None, :], x.dtype)
    return _out_proj(p, cfg, out), cache


def _attn_decode_paged(p: Attention, cfg, x, cache: dict, pos, page_table):
    """Paged per-slot decode: cache {"kp","vp"} (P,Kh,page,hd) pool;
    page_table (B, max_pages) pool page ids; pos (B,) positions.

    Write: slot b's token lands at pool[table[b, pos//page], :, pos%page]
    (active slots own disjoint pages). Read: gather the slot's pages in
    logical order into (B, Kh, max_pages*page, hd) and mask exactly like
    ``_attn_decode_vec`` — same keys, same order, so the two layouts agree
    numerically.
    """
    kp, vp = cache["kp"], cache["vp"]
    _, kh, page, hd = kp.shape
    maxp = page_table.shape[1]
    positions = pos[:, None].to(torch.int32)                   # (B,1)
    q, k, v = _project_qkv(p, cfg, x, positions)

    table = page_table.long()
    pos_l = pos.long()
    pids = torch.gather(table, 1, (pos_l // page)[:, None])[:, 0]
    offs = pos_l % page
    kp[pids, :, offs] = k[:, :, 0].to(kp.dtype)
    vp[pids, :, offs] = v[:, :, 0].to(vp.dtype)

    B = pos.shape[0]
    S = maxp * page
    ks = kp[table].transpose(1, 2).reshape(B, kh, S, hd)
    vs = vp[table].transpose(1, 2).reshape(B, kh, S, hd)

    kidx = torch.arange(S, dtype=torch.int32, device=x.device)
    keep = kidx[None, :] <= pos[:, None]                       # (B,S)
    kf, vf = _repeat_kv(cfg, ks), _repeat_kv(cfg, vs)
    out = _softmax_attend(q, kf, vf, keep[:, None, None, :], x.dtype)
    return _out_proj(p, cfg, out), cache
