"""Attention: MHA/GQA/MQA with RoPE, sliding windows, KV caches (full,
ring and paged), and q-block-chunked scores.

PyTorch port of the dense paths of the reference's
``repro.models.attention``. Scores and softmax stay in f32 with
``NEG_INF = -1e30``, as in the reference; the products are plain
``torch.matmul``, as the reference leaves them to XLA outside any Pallas
kernel.

Cache layout: k, v are (B, Kh, S, hd). Ring caches (sliding window) add
``kpos`` (S,) holding the absolute position stored in each slot (-1 =
empty). Paged layout (serving): one pool of
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

Whisper's cross-attention (``cross_kv``, ``attn_cross``) attends over K/V
precomputed from the encoder's output: no rope on q or on the cross K, no
mask, f32 softmax.

Tensor parallelism over ``model`` (the reference's rules: ``heads`` and
``kv_heads`` to ``model``, as far as they divide): when ``wq`` holds this
rank's shard of the heads (fewer than ``n_heads``; the mesh step and the
mesh serving gather such a leaf over the other axes only), the rank
computes its own query heads. ``wk`` and ``wv`` hold its KV heads where
``n_kv_heads`` divides, else every KV head, and each local query head
reads its global KV head (``_repeat_kv``); a whole ``wk`` and ``wv`` then
take the sum of the ranks' gradients (``copy_to_model``). The input
enters through ``copy_to_model`` and ``wo`` runs row-parallel, its
partial sums added over ``model`` in f32 (``row_parallel``). A decode
cache handed whole over the KV heads (``serve/mesh.py`` gathers it at
use) is read and written at the rank's own KV heads. With whole weights
none of this runs.

``attn_impl="flash"`` selects the reference's XLA-level flash attention on
the train / prefill path: an online softmax over (q_block, kv_block) tiles
with static triangular and window pruning, and a hand-written backward
(``FlashAttention``, a ``torch.autograd.Function``, the reference's
``custom_vjp``) that recomputes each tile from the saved row max and sum,
so no (S, S) score tensor survives the forward. It is plain PyTorch, as the
reference's is plain jnp; the Pallas kernel's counterpart is
``kernels/flash_attention``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import (_normal, apply_rope, cdtype_of,
                                       dtype_of, param, rope_angles)
from repro_torch.parallel import sharding as sh

NEG_INF = -1e30


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


def spec_attention() -> dict:
    return {"wq": ("fsdp", "heads", None), "wk": ("fsdp", "kv_heads", None),
            "wv": ("fsdp", "kv_heads", None), "wo": ("heads", None, "fsdp")}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(x.dtype)).unflatten(-1, (h, k))


def _project_qkv(p: Attention, cfg, x, positions):
    """x (B,S,D) -> q (B,H,S,hd) roped, k/v (B,Kh,S,hd) roped; H and Kh
    this rank's heads when ``p`` holds its shard of them."""
    x = x.to(cdtype_of(cfg))
    wk, wv = p.wk, p.wv
    if p.wq.shape[1] != cfg.n_heads:           # split over model
        x = sh.copy_to_model(x)
        if wk.shape[1] == cfg.n_kv_heads:      # every KV head, each rank
            wk, wv = sh.copy_to_model(wk), sh.copy_to_model(wv)
    q, k, v = _proj(x, p.wq), _proj(x, wk), _proj(x, wv)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _repeat_kv(cfg, k: torch.Tensor, n_q=None) -> torch.Tensor:
    """Each KV head repeated n_heads // n_kv_heads times (``jnp.repeat`` on
    axis 1, as an expand and a reshape: no host sync, so a CUDA graph can
    capture it): the KV head of each of the ``n_q`` query heads (default
    ``n_heads``). Under tensor parallelism the query heads are this
    rank's; ``k`` holds either its own KV heads (then the same repeat) or
    every KV head, and query head j of the rank then reads KV head
    (rank · n_q + j) // rep."""
    rep = cfg.n_heads // cfg.n_kv_heads
    B, kh, S, hd = k.shape
    n_q = cfg.n_heads if n_q is None else n_q
    if kh * rep != n_q:
        first = sh.model_rank() * n_q
        heads = torch.arange(first, first + n_q, device=k.device) // rep
        return k.index_select(1, heads)
    if rep == 1:
        return k
    return k[:, :, None].expand(B, kh, rep, S, hd).reshape(B, kh * rep, S, hd)


def _own_kv(cache_t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The view of a decode cache tensor (.., Kh, S, hd) at this rank's KV
    heads when the cache holds every KV head and ``k`` only the rank's
    (writes through the view land in the cache)."""
    kh = k.shape[1]
    if cache_t.shape[1] == kh:
        return cache_t
    return cache_t.narrow(1, sh.model_rank() * kh, kh)


def _softmax_attend(q, k, v, keep, out_dtype):
    """f32 scores of q (B,H,Q,hd) against k (B,H,T,hd), masked by ``keep``
    (broadcastable to (B,H,Q,T)), softmax, times v -> (B,H,Q,hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    s = torch.where(keep, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return (w @ v.float()).to(out_dtype)


def _divisor_block(block: int, S: int) -> int:
    """``block`` capped at S, else the largest divisor of S below it."""
    block = min(block, S)
    if S % block:
        block = next(d for d in range(block, 0, -1) if S % d == 0)
    return block


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
    q_block = _divisor_block(q_block, Sq)
    return torch.cat([block(q[:, :, i:i + q_block],
                            q_positions[i:i + q_block])
                      for i in range(0, Sq, q_block)], dim=2)


def _flash_blocks(S, q_block, kv_block, causal, window):
    """Static per-q-block kv ranges (the triangular / window pruning):
    (q_block, kv_block, [(q0, lo, hi)]) with kv blocks lo..hi-1 visited."""
    q_block = _divisor_block(q_block, S)
    kv_block = _divisor_block(kv_block, S)
    ranges = []
    for qi in range(S // q_block):
        q0 = qi * q_block
        lo = max(0, (q0 - window + 1)) // kv_block if window else 0
        hi = ((q0 + q_block - 1) // kv_block + 1) if causal \
            else S // kv_block
        ranges.append((q0, lo, hi))
    return q_block, kv_block, ranges


def _tile_mask(q0, k0, q_block, kv_block, causal, window, device):
    """(q_block, kv_block) keep-mask of the tile at rows q0, columns k0."""
    qpos = q0 + torch.arange(q_block, device=device)[:, None]
    kpos = k0 + torch.arange(kv_block, device=device)[None, :]
    keep = torch.ones((q_block, kv_block), dtype=torch.bool, device=device)
    if causal:
        keep &= qpos >= kpos
    if window:
        keep &= qpos - kpos < window
    return keep


def _tile_scores(qb, kt, q0, k0, q_block, kv_block, causal, window):
    """Masked f32 scores of a (pre-scaled f32) q block against a kv tile."""
    s = qb @ kt.float().transpose(-1, -2)
    keep = _tile_mask(q0, k0, q_block, kv_block, causal, window, qb.device)
    return torch.where(keep, s, NEG_INF)


def _flash_fwd_impl(q, k, v, causal, window, q_block, kv_block):
    """Online-softmax forward with STATIC triangular / window pruning: per
    q block only the kv blocks inside the causal prefix (and window) are
    visited; peak score memory is one (q_block, kv_block) tile. Returns
    (out, m, l) — the row max and sum the backward recomputes from."""
    B, H, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    q_block, kv_block, ranges = _flash_blocks(S, q_block, kv_block, causal,
                                              window)
    outs, ms, ls = [], [], []
    for q0, lo, hi in ranges:
        qb = q[:, :, q0:q0 + q_block].float() * scale
        m = torch.full((B, H, q_block, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, q_block, 1), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, H, q_block, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(lo, hi):
            k0 = ki * kv_block
            s = _tile_scores(qb, k[:, :, k0:k0 + kv_block], q0, k0, q_block,
                             kv_block, causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ v[:, :, k0:k0 + kv_block].float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)).to(q.dtype))
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=2), torch.cat(ms, dim=2), torch.cat(ls, dim=2)


def _flash_bwd(q, k, v, out, m, l, do, causal, window, q_block, kv_block):
    """Flash backward: each tile recomputed from the saved (m, l) row stats,
    ``delta = sum(dO · O)``; dq per q block, dk and dv accumulated in f32
    by the kv block."""
    B, H, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    q_block, kv_block, ranges = _flash_blocks(S, q_block, kv_block, causal,
                                              window)
    dof = do.float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dq_blocks = []
    dk = torch.zeros((B, H, k.shape[2], hd), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for q0, lo, hi in ranges:
        rows = slice(q0, q0 + q_block)
        qb = q[:, :, rows].float() * scale
        mb = m[:, :, rows]
        lb = torch.clamp(l[:, :, rows], min=1e-30)
        dob = dof[:, :, rows]
        db = delta[:, :, rows]
        dqb = torch.zeros((B, H, q_block, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(lo, hi):
            k0 = ki * kv_block
            cols = slice(k0, k0 + kv_block)
            kt = k[:, :, cols].float()
            s = _tile_scores(qb, kt, q0, k0, q_block, kv_block, causal,
                             window)
            p = torch.exp(s - mb) / lb
            dv[:, :, cols] += p.transpose(-1, -2) @ dob
            dp = dob @ v[:, :, cols].float().transpose(-1, -2)
            ds = p * (dp - db)                     # d(scaled scores)
            dqb = dqb + (ds @ kt) * scale
            dk[:, :, cols] += ds.transpose(-1, -2) @ qb
        dq_blocks.append(dqb)
    dq = torch.cat(dq_blocks, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``_flash_fwd_impl`` forward, ``_flash_bwd`` backward (the
    reference's ``_sdpa_flash_core`` custom VJP). q, k, v (B,H,S,hd) with
    the KV heads already repeated; causal, window, q_block and kv_block
    are static."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block):
        out, m, l = _flash_fwd_impl(q, k, v, causal, window, q_block,
                                    kv_block)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.static = (causal, window, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, m, l, do, *ctx.static)
        return dq, dk, dv, None, None, None, None


def sdpa_flash(q, k, v, *, causal, window, q_block=1024, kv_block=1024):
    """XLA-level flash attention with its hand-written backward. The
    positions are arange(S), as on the train / prefill path."""
    return FlashAttention.apply(q, k, v, causal, window, q_block, kv_block)


def _out_proj(p: Attention, cfg, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out (B,H,S,hd) -> (B,S,D); this rank's heads' part summed over
    ``model`` when ``p`` holds its shard of them."""
    h, hd, d = p.wo.shape
    B, _, S, _ = attn_out.shape
    flat = attn_out.transpose(1, 2).reshape(B, S, h * hd)
    wo = p.wo.reshape(h * hd, d).to(cdtype_of(cfg))
    return flat @ wo if h == cfg.n_heads else sh.row_parallel(flat, wo)


def attn_train(p: Attention, cfg, x, positions, *, causal=True, window=0,
               return_cache=False, q_block=1024):
    """Full-sequence self-attention (train / prefill).

    positions: (S,) int absolute positions. window>0 = sliding window.
    ``cfg.attn_impl`` selects the score path: "blocked" (q-chunked,
    materializes (q_block, Sk) scores) or "flash" (online softmax, static
    pruning, ``FlashAttention``'s backward). Returns y (B,S,D), and with
    ``return_cache`` the roped k and raw v (B,Kh,S,hd) for a decode cache.
    """
    q, k, v = _project_qkv(p, cfg, x, positions)
    kf, vf = _repeat_kv(cfg, k, q.shape[1]), _repeat_kv(cfg, v, q.shape[1])

    if cfg.attn_impl == "flash":
        out = sdpa_flash(q, kf, vf, causal=causal, window=window,
                         q_block=q_block)
    else:
        def mask_fn(qpos, kidx):
            kpos = positions[kidx]
            keep = torch.ones((qpos.shape[0], kidx.shape[0]),
                              dtype=torch.bool, device=qpos.device)
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
    """Allocate a decode cache {"k","v"} (B, Kh, S, hd). For a sliding
    window the cache is a ring of S = min(max_seq, window) slots, with
    ``kpos`` (S,) of -1."""
    S = min(max_seq, cfg.window) if cfg.window else max_seq
    shape = (batch, cfg.n_kv_heads, S, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=cdtype_of(cfg), device=device),
             "v": torch.zeros(shape, dtype=cdtype_of(cfg), device=device)}
    if cfg.window:
        cache["kpos"] = torch.full((S,), -1, dtype=torch.int32,
                                   device=device)
    return cache


def cache_logical(*, paged: bool = False) -> dict:
    if paged:
        return {"kp": ("cache_pages", "cache_kv_heads", None, None),
                "vp": ("cache_pages", "cache_kv_heads", None, None)}
    return {"k": ("cache_batch", "cache_kv_heads", "cache_seq", None),
            "v": ("cache_batch", "cache_kv_heads", "cache_seq", None)}


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

    pos: scalar int tensor (all slots aligned) or (B,) per-slot positions
    (full cache only). Full cache: writes the token's k/v at ``pos`` (in
    place) and attends over positions <= pos (and inside the window). Ring
    cache (has "kpos"): writes at ``pos % S``, records ``pos`` in ``kpos``
    and masks by the stored positions. Paged cache (has "kp"): per-slot
    positions plus a (B, max_pages) ``page_table`` are required.
    """
    if "kp" in cache:
        if pos.ndim != 1 or page_table is None:
            raise ValueError("paged decode needs pos (B,) and a page_table")
        return _attn_decode_paged(p, cfg, x, cache, pos, page_table)
    is_ring = "kpos" in cache
    if pos.ndim == 1:
        if is_ring:
            raise NotImplementedError("per-slot positions need a full cache")
        return _attn_decode_vec(p, cfg, x, cache, pos)
    S = cache["k"].shape[2]
    positions = pos.reshape(1).to(torch.int32)
    q, k, v = _project_qkv(p, cfg, x, positions)
    ck, cv = _own_kv(cache["k"], k), _own_kv(cache["v"], v)
    slot = positions.long() % S if is_ring else positions.long()
    ck.index_copy_(2, slot, k.to(ck.dtype))
    cv.index_copy_(2, slot, v.to(cv.dtype))
    if is_ring:
        kpos = cache["kpos"]
        kpos.index_copy_(0, slot, positions)
        keep = ((kpos >= 0) & (pos - kpos < (cfg.window or S))
                & (kpos <= pos))
    else:
        kidx = torch.arange(S, dtype=torch.int32, device=x.device)
        keep = kidx <= pos
        if cfg.window:
            keep &= pos - kidx < cfg.window
    kf, vf = _repeat_kv(cfg, ck, q.shape[1]), _repeat_kv(cfg, cv, q.shape[1])
    out = _softmax_attend(q, kf, vf, keep[None, None, None, :], x.dtype)
    return _out_proj(p, cfg, out), cache


def _attn_decode_vec(p: Attention, cfg, x, cache: dict, pos):
    """Per-slot-position decode (pos (B,)): slot b writes its token at
    ``pos[b]`` of its own cache row; masking is per slot."""
    positions = pos[:, None].to(torch.int32)                   # (B,1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    ck, cv = _own_kv(cache["k"], k), _own_kv(cache["v"], v)
    S = ck.shape[2]
    b = torch.arange(pos.shape[0], device=x.device)
    ck[b, :, pos.long()] = k[:, :, 0].to(ck.dtype)
    cv[b, :, pos.long()] = v[:, :, 0].to(cv.dtype)

    kidx = torch.arange(S, dtype=torch.int32, device=x.device)
    keep = kidx[None, :] <= pos[:, None]                       # (B,S)
    if cfg.window:
        keep &= pos[:, None] - kidx[None, :] < cfg.window
    kf, vf = _repeat_kv(cfg, ck, q.shape[1]), _repeat_kv(cfg, cv, q.shape[1])
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


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg) -> Attention:
    return init_attention(gen, cfg)


def cross_kv(p: Attention, cfg, enc_out) -> dict:
    """Cross K/V precomputed from the encoder output (B,F,D) ->
    {"ck","cv"} (B,Kh,F,hd), no rope."""
    x = enc_out.to(cdtype_of(cfg))
    return {"ck": _proj(x, p.wk).transpose(1, 2),
            "cv": _proj(x, p.wv).transpose(1, 2)}


def attn_cross(p: Attention, cfg, x, ckv: dict):
    """x (B,Sq,D) attends over the precomputed cross K/V: no rope on q, no
    mask."""
    q = _proj(x.to(cdtype_of(cfg)), p.wq).transpose(1, 2)
    kf, vf = _repeat_kv(cfg, ckv["ck"]), _repeat_kv(cfg, ckv["cv"])
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = (q.float() * scale) @ kf.float().transpose(-1, -2)
    w = torch.softmax(s, dim=-1)
    out = (w @ vf.float()).to(x.dtype)
    return _out_proj(p, cfg, out)
