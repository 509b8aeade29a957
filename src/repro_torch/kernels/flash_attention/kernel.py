"""Flash attention (forward) with an instruction-level noise slot.

Online-softmax blocked attention of q (B,H,Sq,hd) over k, v (B,KH,Sk,hd):
GQA (H a multiple of KH), scale 1/sqrt(hd), causal and sliding-window
masks with whole-block skip. Grid (B*H, Sq/bq, Sk/bk), kv innermost; only
LIVE blocks (not entirely above the diagonal, not entirely out of the
window) compute, and each live block adds k noise patterns at
``step = bh*131 + qi*17 + ki``, the vmem source being the noise operand.

``flash_attention(q, k, v, noise, ...)`` bakes k into a static build;
``flash_attention_rt(kq, q, k, v, noise, ...)`` takes k at run time. Both
return ``(out, nacc)``. For tensors on the CPU they take the plain version
``flash_attention_plain``; for CUDA tensors they launch
``csrc/flash_attention.cu`` (f32 or bf16, hd in ``HEAD_DIMS``, blocks of at
most 64, TF32 tensor cores: wgmma fed by a TMA ring at hd 64 and 128,
mma.sync at hd 256) or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import noise_slots as ns
from repro_torch.kernels.noisy_matmul.ref import default_noise_operand

TILE = 64                       # the CUDA kernel's largest bq and bk
HEAD_DIMS = (64, 128, 256)      # the head dims the CUDA kernel is built for
WGMMA_HEAD_DIMS = (64, 128)     # ... by its wgmma design; hd 256 by mma.sync
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30

# csrc/flash_attention.cu's shared-memory layouts, mirrored (f32 in shared
# memory whatever the input type, so the dtype does not enter).
NZ_BYTES = 128 * 132 * 4     # the staged noise operand (mxu, vmem)
KV_DEPTH = 2                 # K and V^T stages in the wgmma kernel's ring


def smem_bytes(hd: int, mode: str) -> int:
    """Dynamic shared memory the CUDA kernel takes at head dim ``hd`` in
    ``mode``; the launch passes it and the kernel refuses a value other
    than its own. hd 64 and 128 (wgmma): ``KV_DEPTH`` K and V^T stages of
    64 x hd f32 (Q passes through the first K stage on its way to
    registers), the noise operand in mxu and vmem, the row-max exchange
    (2 x 2 x 64 f32), a K and a V mbarrier per stage, and slack to align
    the tiles to 1024. hd 256 (mma.sync): Q (hd+4), one K/V buffer (hd+8)
    and S/P (68) row strides over 64 rows, m, l and the correction, the
    noise operand in mxu and vmem."""
    noise = NZ_BYTES if mode in ("mxu", "vmem") else 0
    if hd in WGMMA_HEAD_DIMS:
        return (TILE * hd * 4 * 2 * KV_DEPTH + noise + 1024 + 16 * KV_DEPTH
                + 1024)
    return 4 * (TILE * (hd + 4) + TILE * (hd + 8) + TILE * 68 + 3 * TILE) + noise


def _shapes(q, k, v, bq, bk):
    """(B, H, KH, Sq, Sk, hd, bq, bk) with the blocks shrunk to short
    sequences; raises with the reference's assertion texts inside."""
    B, H, Sq, hd = q.shape
    _, KH, Sk, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, KH, Sk, hd) with q's B and "
                         f"hd; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if H % KH:
        raise ValueError(f"heads must be a multiple of kv_heads: {(H, KH)}")
    bq, bk = min(bq, Sq), min(bk, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"sequence lengths must tile by the blocks: "
                         f"{(Sq, Sk, bq, bk)}")
    return B, H, KH, Sq, Sk, hd, bq, bk


def live_blocks(nq: int, nk: int, bq: int, bk: int, causal: bool,
                window: int, device="cpu") -> torch.Tensor:
    """(nq, nk) bool: which (q block, kv block) pairs compute — the
    reference's block-level skip conditions."""
    q0 = torch.arange(nq, device=device)[:, None] * bq
    k0 = torch.arange(nk, device=device)[None, :] * bk
    live = torch.ones((nq, nk), dtype=torch.bool, device=device)
    if causal:
        live &= k0 <= q0 + bq - 1
    if window:
        live &= q0 - (k0 + bk - 1) < window
    return live


def _noise_live(mode: str, k_noise: int, parts: torch.Tensor,
                noise: torch.Tensor, steps: torch.Tensor) -> None:
    """Add ``k_noise`` patterns into each selected partial (..., 8, 128) in
    place, pattern by pattern as every CTA does; ``steps`` (...) holds each
    partial's grid step (vmem offsets rotate with it)."""
    if mode == "fp":
        c = ns._fp_c(noise, None)
        for _ in range(k_noise):
            parts += c
    elif mode == "mxu":
        for _ in range(k_noise):
            parts += noise[0:8, :] @ noise
    elif mode == "vmem":
        rows = torch.arange(8, device=noise.device)
        m = max(noise.shape[0] - 8, 1)
        for j in range(k_noise):
            off = (steps * 7 + j * 13) % m
            parts += noise[off[..., None] + rows]
    elif mode != "none":
        raise ValueError(f"unknown kernel noise mode {mode!r}; one of "
                         f"{ns.MODES}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          noise: torch.Tensor, *, causal: bool = True,
                          window: int = 0, bq: int = TILE, bk: int = TILE,
                          mode: str = "none", k_noise: int = 0):
    """Plain PyTorch version of the kernel's arithmetic, in IEEE f32: the
    online softmax block by block over kv (every q block at once), one
    noise partial per (bh, qi) — the kernel's CTA — holding k patterns per
    live block in kv order, the partials reduced in the card's order."""
    flash_attention_plain.launches += 1
    B, H, KH, Sq, Sk, hd, bq, bk = _shapes(q, k, v, bq, bk)
    dev, f32 = q.device, torch.float32
    BH, nq, nk, G = B * H, Sq // bq, Sk // bk, H // KH
    scale = 1.0 / math.sqrt(hd)
    qf = (q.to(f32) * scale).reshape(BH, nq, bq, hd)
    kf = k.to(f32).repeat_interleave(G, dim=1).reshape(BH, nk, bk, hd)
    vf = v.to(f32).repeat_interleave(G, dim=1).reshape(BH, nk, bk, hd)
    m = torch.full((BH, nq, bq, 1), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((BH, nq, bq, 1), dtype=f32, device=dev)
    acc = torch.zeros((BH, nq, bq, hd), dtype=f32, device=dev)
    parts = ns.new_partials(BH * nq, dev).reshape(BH, nq, *ns.NOISE_SHAPE)
    live = live_blocks(nq, nk, bq, bk, causal, window, dev)
    qpos = torch.arange(Sq, device=dev).reshape(nq, bq, 1)
    bh_steps = torch.arange(BH, device=dev)[:, None] * 131
    for ki in range(nk):
        idx = live[:, ki].nonzero().flatten()
        if not len(idx):
            continue
        s = qf[:, idx] @ kf[:, ki, None].transpose(-1, -2)   # (BH, nl, bq, bk)
        kpos = ki * bk + torch.arange(bk, device=dev)
        keep = torch.ones((len(idx), bq, bk), dtype=torch.bool, device=dev)
        if causal:
            keep &= qpos[idx] >= kpos
        if window:
            keep &= qpos[idx] - kpos < window
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        m_prev = m[:, idx]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m_prev - m_new)
        l[:, idx] = corr * l[:, idx] + p.sum(dim=-1, keepdim=True)
        acc[:, idx] = acc[:, idx] * corr + p @ vf[:, ki, None]
        m[:, idx] = m_new
        if mode != "none" and k_noise:
            sel = parts[:, idx]
            _noise_live(mode, k_noise, sel, noise, bh_steps + idx * 17 + ki)
            parts[:, idx] = sel
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return (out.reshape(B, H, Sq, hd).to(q.dtype),
            ns.reduce_partials(parts.reshape(BH * nq, *ns.NOISE_SHAPE)))


flash_attention_plain.launches = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         noise: torch.Tensor, *, causal: bool, window: int,
                         bq: int, bk: int, mode: str, k_noise: int,
                         static: bool):
    """Launch ``csrc/flash_attention.cu`` (static-k build of this variant,
    or the runtime-k library)."""
    B, H, KH, Sq, Sk, hd, bq, bk = _shapes(q, k, v, bq, bk)
    if q.dtype not in DTYPE_IDS or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"the CUDA attention takes float32 or bfloat16 "
                         f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA attention is built for head dims "
                         f"{HEAD_DIMS}; got {hd}")
    if bq > TILE or bk > TILE:
        raise ValueError(f"the CUDA attention takes blocks of at most {TILE}; "
                         f"got bq={bq}, bk={bk}")
    if not (q.is_cuda and q.device == k.device == v.device == noise.device):
        raise ValueError("q, k, v and noise must lie on one CUDA device")
    if noise.dtype != torch.float32 or tuple(noise.shape) != ns.NOISE_REF_SHAPE:
        raise ValueError(f"noise must be a float32 {ns.NOISE_REF_SHAPE}")
    q, k, v, noise = (t.contiguous() for t in (q, k, v, noise))
    out = torch.empty_like(q)
    # the wgmma kernel's K and V^T, rounded to TF32, per 64-row kv block
    n_kv = B * KH * (Sk // bk) * TILE * hd if hd in WGMMA_HEAD_DIMS else 0
    kp = torch.empty(n_kv, dtype=torch.float32, device=q.device)
    vt = torch.empty(n_kv, dtype=torch.float32, device=q.device)
    stream = _build.stream_handle(q.device.index)
    partials, scratch, nacc = ns.card_buffers(B * H * (Sq // bq), q.device,
                                              stream)
    dtype_id = DTYPE_IDS[q.dtype]
    _build.launch("flash_attention", "attention",
                  (q, k, v, noise, out, kp, vt, partials, scratch, nacc),
                  (B, H, KH, Sq, Sk, hd, bq, bk, int(bool(causal)),
                   int(window), dtype_id, smem_bytes(hd, mode)),
                  mode_id=ns.MODE_IDS[mode], k=k_noise, static=static,
                  defines=(("REPRO_STATIC_HD", hd),
                           ("REPRO_STATIC_BF16", dtype_id)), stream=stream)
    flash_attention_cuda.launches += 1
    return out, nacc


flash_attention_cuda.launches = 0


def _check_mode(mode: str) -> None:
    if mode not in ns.MODES:
        raise ValueError(f"unknown kernel noise mode {mode!r}; one of {ns.MODES}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    noise=None, *, causal: bool = True, window: int = 0,
                    bq: int = TILE, bk: int = TILE, mode: str = "none",
                    k_noise: int = 0):
    """q (B,H,Sq,hd); k,v (B,KH,Sk,hd) -> (out (B,H,Sq,hd), nacc (8,128)).
    Static k."""
    _check_mode(mode)
    if noise is None:
        noise = default_noise_operand(q.device)
    kw = dict(causal=causal, window=window, bq=bq, bk=bk, mode=mode,
              k_noise=int(k_noise))
    if _build.on_card(q):
        return flash_attention_cuda(q, k, v, noise, static=True, **kw)
    return flash_attention_plain(q, k, v, noise, **kw)


def flash_attention_rt(kq: int, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, noise=None, *, causal: bool = True,
                       window: int = 0, bq: int = TILE, bk: int = TILE,
                       mode: str = "fp"):
    """Runtime-k twin of ``flash_attention`` (``kq``: the noise quantity,
    clipped to [0, K_MAX]; named to avoid clashing with the key tensor
    ``k``); bitwise equal to it at the same k."""
    _check_mode(mode)
    if noise is None:
        noise = default_noise_operand(q.device)
    if _build.on_card(q):
        return flash_attention_cuda(q, k, v, noise, causal=causal,
                                    window=window, bq=bq, bk=bk, mode=mode,
                                    k_noise=int(kq), static=False)
    return flash_attention_plain(q, k, v, noise, causal=causal, window=window,
                                 bq=bq, bk=bk, mode=mode,
                                 k_noise=ns.clip_k(kq))
