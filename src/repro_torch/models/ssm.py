"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060].

PyTorch port of the reference's ``repro.models.ssm``. Chunked SSD for
train / prefill: an intra-chunk quadratic, attention-like term plus an
inter-chunk state recurrence. O(1)-state decode step. All recurrence math
in f32; ``A_log``, ``dt_bias`` and ``D_skip`` are f32 whatever the
parameters' dtype.

Layout: x heads (B, S, nh, hp); B/C (B, S, ng, N); state (B, nh, hp, N).

The inter-chunk recurrence is a loop over the chunks in order,
``s_c = s_{c-1} * decay_c + S_c`` from the initial state. The reference
runs it as a ``jax.lax.associative_scan`` (a tree of the same products,
then the initial state times the cumulative decay): the same sum with its
f32 multiplies in another order, so the two agree to rounding. Every op is
capture-safe (no host read), so a CUDA graph can hold the step.

The decode step is OUT OF PLACE: it returns a new ``state`` and ``conv``
and leaves the cache it was given alone, so calling it twice on the same
arguments gives the same outputs (an SSM state advanced in place would
move on at every replay of a step region).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (RMSNorm, _normal, cdtype_of,
                                       dtype_of, init_embedding,
                                       init_rmsnorm, named_specs, param,
                                       per_layer_specs, rms_scale,
                                       spec_embedding, spec_rmsnorm)


class SSM(nn.Module):
    """The reference's twelve leaves: w_x / w_z (D, di), w_B / w_C
    (D, ng·N), w_dt (D, nh), dt_bias / A_log / D_skip (nh,) f32, conv_w
    (K, ch), conv_b (ch,), norm (di,), w_out (di, D)."""

    def __init__(self, w_x, w_z, w_B, w_C, w_dt, dt_bias, A_log, D_skip,
                 conv_w, conv_b, norm, w_out):
        super().__init__()
        self.w_x = param(w_x)
        self.w_z = param(w_z)
        self.w_B = param(w_B)
        self.w_C = param(w_C)
        self.w_dt = param(w_dt)
        self.dt_bias = param(dt_bias)
        self.A_log = param(A_log)
        self.D_skip = param(D_skip)
        self.conv_w = param(conv_w)
        self.conv_b = param(conv_b)
        self.norm = param(norm)
        self.w_out = param(w_out)


class Block(nn.Module):
    """One Mamba2 layer: ``ln`` then ``ssm``."""

    def __init__(self, ln: RMSNorm, ssm: SSM):
        super().__init__()
        self.ln = ln
        self.ssm = ssm


class SSMLM(nn.Module):
    """The Mamba2 LM's param tree: ``embed``, ``blocks`` (one ``Block`` a
    layer, where the reference stacks them on a leading L axis),
    ``final_norm``."""

    def __init__(self, embed, blocks, final_norm):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm


def init_ssm(gen: torch.Generator, cfg) -> SSM:
    """The seven random leaves drawn from ``gen`` in the reference's order;
    ``A_log`` = log(linspace(1, 16, nh)), ``D_skip`` ones, the biases zero,
    ``norm`` ones."""
    d, di = cfg.d_model, cfg.d_inner
    nh, N, ng = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    dt = dtype_of(cfg)
    dev = gen.device
    conv_ch = di + 2 * ng * N
    f32 = torch.float32
    return SSM(
        w_x=_normal(gen, (d, di), d ** -0.5, dt),
        w_z=_normal(gen, (d, di), d ** -0.5, dt),
        w_B=_normal(gen, (d, ng * N), d ** -0.5, dt),
        w_C=_normal(gen, (d, ng * N), d ** -0.5, dt),
        w_dt=_normal(gen, (d, nh), d ** -0.5, dt),
        dt_bias=torch.zeros((nh,), dtype=f32, device=dev),
        A_log=torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                       device=dev)),
        D_skip=torch.ones((nh,), dtype=f32, device=dev),
        conv_w=_normal(gen, (cfg.ssm_conv, conv_ch), 0.5, dt),
        conv_b=torch.zeros((conv_ch,), dtype=dt, device=dev),
        norm=torch.ones((di,), dtype=dt, device=dev),
        w_out=_normal(gen, (di, d), di ** -0.5, dt))


def spec_ssm() -> dict:
    return {"w_x": ("fsdp", "ssm_inner"), "w_z": ("fsdp", "ssm_inner"),
            "w_B": ("fsdp", None), "w_C": ("fsdp", None),
            "w_dt": ("fsdp", "ssm_heads"), "dt_bias": ("ssm_heads",),
            "A_log": ("ssm_heads",), "D_skip": ("ssm_heads",),
            "conv_w": (None, None), "conv_b": (None,),
            "norm": ("ssm_inner",), "w_out": ("ssm_inner", "fsdp")}


def spec_block() -> dict:
    return {"ln": spec_rmsnorm(), "ssm": spec_ssm()}


def spec_ssm_lm(cfg) -> dict:
    """{parameter name: logical axes} of ``init_ssm_lm``'s module."""
    return {**named_specs({"embed": spec_embedding(cfg)}),
            **per_layer_specs("blocks", cfg.n_layers, spec_block()),
            **named_specs({"final_norm": spec_rmsnorm()})}


def init_block(gen: torch.Generator, cfg) -> Block:
    return Block(init_rmsnorm(cfg.d_model, cfg, gen.device),
                 init_ssm(gen, cfg))


def init_ssm_lm(gen: torch.Generator, cfg) -> SSMLM:
    """Every parameter drawn from ``gen`` on its device: the embedding, then
    the blocks in order."""
    emb = init_embedding(gen, cfg)
    blocks = [init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return SSMLM(emb, blocks, init_rmsnorm(cfg.d_model, cfg, gen.device))


def _causal_conv(xbc, conv_w, conv_b, buf=None):
    """Depthwise causal conv of width K. xbc (B,S,Ch); buf (B,K-1,Ch) the
    history for decode. Returns (silu(y), new_buf). The K shifted products
    are summed in xbc's dtype in the order i = 0..K-1 (the reference's
    Python ``sum``): in bf16 another order is another result."""
    K = conv_w.shape[0]
    S = xbc.shape[1]
    if buf is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = buf.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                  # (B, S+K-1, Ch)
    y = full[:, :S, :] * conv_w[0][None, None, :]      # 0 + it, exactly
    for i in range(1, K):
        y = y + full[:, i:i + S, :] * conv_w[i][None, None, :]
    y = y + conv_b[None, None, :]
    return F.silu(y), full[:, -(K - 1):, :]


def _proj_inputs(p: SSM, cfg, h, conv_buf=None):
    """h (B,S,D) -> x (B,S,nh,hp), B/C (B,S,ng,N), dt (B,S,nh) f32, z
    (B,S,di), new conv buffer."""
    cd = cdtype_of(cfg)
    z = h @ p.w_z.to(cd)
    xc = h @ p.w_x.to(cd)
    Bc = h @ p.w_B.to(cd)
    Cc = h @ p.w_C.to(cd)
    dt = h @ p.w_dt.to(cd)
    xbc = torch.cat([xc, Bc, Cc], dim=-1)
    xbc, new_buf = _causal_conv(xbc, p.conv_w.to(cd), p.conv_b.to(cd),
                                conv_buf)
    di, ngN = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    B, S = xbc.shape[:2]
    nh, hp, ng, N = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups,
                     cfg.ssm_state)
    x = xbc[..., :di].reshape(B, S, nh, hp)
    Bm = xbc[..., di:di + ngN].reshape(B, S, ng, N)
    Cm = xbc[..., di + ngN:].reshape(B, S, ng, N)
    dt = F.softplus(dt.float() + p.dt_bias[None, None, :])
    return x, Bm, Cm, dt, z, new_buf


def _gated_out(p: SSM, cfg, y, z):
    """y (B,S,nh,hp) -> out (B,S,D): gated RMSNorm, then the out-proj."""
    B, S = y.shape[:2]
    cd = cdtype_of(cfg)
    yf = y.reshape(B, S, cfg.d_inner)
    yf = yf * F.silu(z.to(yf.dtype))
    yf = rms_scale(yf.to(cd), p.norm, cfg.norm_eps)
    return yf @ p.w_out.to(cd)


def _heads(t, hpg: int, dim: int):
    """Each group's B or C repeated over its heads (``jnp.repeat``)."""
    return t.repeat_interleave(hpg, dim=dim) if hpg != 1 else t


def ssd_chunked(cfg, x, Bm, Cm, dt, A, init_state=None):
    """Chunked SSD. x (B,S,nh,hp); returns (y (B,S,nh,hp) f32, final
    state (B,nh,hp,N) f32).

    Recurrence (per head h, state S_t of shape (hp,N)):
      S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t ⊗ B_t ;  y_t = S_t · C_t
    (the D-skip is applied by the caller).
    """
    Bb, S, nh, hp = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    f32 = torch.float32
    xc = x.to(f32).reshape(Bb, nc, Q, nh, hp)
    Bc = Bm.to(f32).reshape(Bb, nc, Q, ng, N)
    Cc = Cm.to(f32).reshape(Bb, nc, Q, ng, N)
    dtc = dt.to(f32).reshape(Bb, nc, Q, nh)

    dA = dtc * A[None, None, None, :]               # (B,nc,Q,nh) (negative)
    cum = torch.cumsum(dA, dim=2)                   # inclusive, within chunk
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,nh)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: the masked (i < j) entries have seg > 0 and would
    # overflow to inf
    seg = torch.where(tri[None, None, :, :, None], seg, float("-inf"))
    Lm = torch.exp(seg)

    hpg = nh // ng
    Bh = _heads(Bc, hpg, 3)                         # (B,nc,Q,nh,N)
    Ch = _heads(Cc, hpg, 3)

    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)         # (B,nc,nh,Q,Q)
    M = cb * Lm.permute(0, 1, 4, 2, 3)                      # mask + decay
    xdt = xc * dtc[..., None]                               # (B,nc,Q,nh,hp)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xdt)

    # chunk states: S_c = sum_q exp(cum_last - cum_q) dt_q x_q ⊗ B_q
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,Q,nh)
    Sc = torch.einsum("bcqhn,bcqhp->bchpn", Bh, xdt * decay_end[..., None])

    # inter-chunk recurrence, chunk by chunk (see the module docstring)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,nh)
    state = (torch.zeros((Bb, nh, hp, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + Sc[:, c]
    prev = torch.stack(prev, dim=1)                         # (B,nc,nh,hp,N)

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           Ch * torch.exp(cum)[..., None], prev)
    y = (y_intra + y_inter).reshape(Bb, S, nh, hp)
    return y, state


def ssd_sequential(x, Bm, Cm, dt, A, init_state=None):
    """The plain version of ``ssd_chunked``: the O(S·N) recurrence, one
    position at a time, in f32. -> (y (B,S,nh,hp), final state)."""
    Bb, S, nh, hp = x.shape
    ng, N = Bm.shape[2], Bm.shape[3]
    hpg = nh // ng
    x, dt = x.float(), dt.float()
    Bh, Ch = _heads(Bm.float(), hpg, 2), _heads(Cm.float(), hpg, 2)
    state = (torch.zeros((Bb, nh, hp, N), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])               # (B,nh)
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :]
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state


def ssm_block(p: SSM, cfg, h, init_state=None, return_state=False):
    """The Mamba2 block: proj -> conv -> SSD -> gated norm -> out proj."""
    x, Bm, Cm, dt, z, _ = _proj_inputs(p, cfg, h)
    A = -torch.exp(p.A_log)
    y, state = ssd_chunked(cfg, x, Bm, Cm, dt, A, init_state)
    y = y + x.float() * p.D_skip[None, None, :, None]
    out = _gated_out(p, cfg, y.to(cdtype_of(cfg)), z)
    if return_state:
        return out, state
    return out


def ssm_cache_logical() -> dict:
    return {"state": ("cache_batch", "ssm_heads", None, None),
            "conv": ("cache_batch", None, None)}


def init_ssm_cache(cfg, batch: int, device) -> dict:
    """{"state": (B, nh, hp, N) f32, "conv": (B, K-1, ch)} of zeros."""
    nh, hp, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {"state": torch.zeros((batch, nh, hp, N), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=cdtype_of(cfg), device=device)}


def ssm_decode_step(p: SSM, cfg, h, cache: dict):
    """h (B,1,D) one token; cache {"state","conv"} -> (out (B,1,D), a NEW
    cache; the one given is not written)."""
    x, Bm, Cm, dt, z, new_conv = _proj_inputs(p, cfg, h,
                                              conv_buf=cache["conv"])
    A = -torch.exp(p.A_log)
    x1 = x[:, 0].float()                                    # (B,nh,hp)
    B1 = Bm[:, 0].float()                                   # (B,ng,N)
    C1 = Cm[:, 0].float()
    dt1 = dt[:, 0]                                          # (B,nh)
    hpg = cfg.ssm_nheads // cfg.ssm_ngroups
    Bh = _heads(B1, hpg, 1)
    Ch = _heads(C1, hpg, 1)
    decay = torch.exp(dt1 * A[None, :])                     # (B,nh)
    upd = (dt1[..., None] * x1)[..., None] * Bh[:, :, None, :]  # (B,nh,hp,N)
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + x1 * p.D_skip[None, :, None]
    out = _gated_out(p, cfg, y[:, None].to(cdtype_of(cfg)), z)
    return out, {"state": state, "conv": new_conv}
