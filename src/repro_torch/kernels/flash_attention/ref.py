"""Output oracle of the attention kernel: full-materialization masked
softmax attention in f32 (the reference's ``attention_ref``)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,H,Sq,hd); k,v (B,KH,Sk,hd) -> (B,H,Sq,hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    KH = k.shape[1]
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    keep = torch.ones((Sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        keep &= qpos >= kpos
    if window:
        keep &= qpos - kpos < window
    s = torch.where(keep[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)


# Per-row tolerance of the TF32 kernel against the IEEE f32 plain version:
# |got - want| <= TF32_ROW_TOL * max|want row| + eps(dtype) * |want|, the eps
# term allowing one rounding of a bf16 output. On the H100 the TF32 kernel
# stays within 1.4e-3 of each row's largest value, and the same kernel fed
# bf16-rounded q, k, v lands at 5.7e-3 or more (chip_smoke.py phase 3).
TF32_ROW_TOL = 2e-3


def row_excess(got: torch.Tensor, want: torch.Tensor,
               row_tol: float = TF32_ROW_TOL) -> float:
    """The largest |got - want| over its per-row limit (see TF32_ROW_TOL):
    at most 1 passes. A causal row 0 (one V row) and a long row (an average
    of thousands) each get a limit of their own size."""
    g, w = got.float(), want.float()
    lim = (row_tol * w.abs().amax(-1, keepdim=True)
           + torch.finfo(want.dtype).eps * w.abs())
    tiny = torch.finfo(torch.float32).tiny
    return float(((g - w).abs() / lim.clamp_min(tiny)).max())
