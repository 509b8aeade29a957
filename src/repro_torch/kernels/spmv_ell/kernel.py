"""ELL-format sparse matrix-vector product with a noise slot — the paper's
SPMXV case-study kernel (§6) in the reference's ELL layout.

``spmv_ell(vals, cols, x, mode=..., k_noise=...)`` bakes k into a static
build; ``spmv_ell_rt(k, vals, cols, x, mode=...)`` takes k at run time.
Both return ``(y, nacc)``. For tensors on the CPU they take the plain version
``spmv_ell_plain``; for CUDA tensors they launch ``csrc/spmv_ell.cu`` or
raise.

Noise: the kernel has no noise operand. fp derives its addend from the
current vals block (its first 8 rows of column 0), vmem re-reads the vals
block at rotating offsets; step = the block index.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import noise_slots as ns

# CTAs per call the CUDA kernel aims for: each walks a run of 128-row blocks.
# At L=16 the ring's 48 KiB of shared memory a CTA fits 4 CTAs on each of
# the 132 SMs, so all 512 are resident at once (csrc/spmv_ell.cu).
TARGET_CTAS = 512
# rows up to this width take the bulk-copy ring kernel (two stages or more
# fit its shared memory: csrc/spmv_ell.cu ring_stages), wider ones
# spmv_kernel's register path
RING_MAX_L = 112


def _shapes(vals: torch.Tensor, x: torch.Tensor, br: int):
    R, L = vals.shape
    br = min(br, R)
    if R % br:
        raise ValueError(f"rows {R} must tile by the {br}-row block")
    if br < 8:
        raise ValueError("noise patterns read 8-row groups of the block")
    return R, L, br, R // br


def blocks_per_cta(nb: int) -> int:
    """Blocks each CTA walks (a contiguous run, in order)."""
    return -(-nb // TARGET_CTAS)


def spmv_ell_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
                   br: int = 128, mode: str = "none", k_noise: int = 0):
    """Plain PyTorch version of the kernel's arithmetic: y for all rows; one
    noise partial per CTA, holding the patterns of its run of blocks in
    order (step = block index); the partials reduced in the card's order."""
    spmv_ell_plain.launches += 1
    R, L, br, nb = _shapes(vals, x, br)
    y = (vals.to(torch.float32) * x[cols.long()].to(torch.float32)
         ).sum(dim=1).to(x.dtype)
    bpc = blocks_per_cta(nb)
    parts = ns.new_partials(-(-nb // bpc), vals.device)
    if mode != "none" and k_noise:
        for i in range(nb):
            ns.emit_noise(mode, k_noise, parts[i // bpc], None,
                          src=vals[i * br:(i + 1) * br], step=i)
    return y, ns.reduce_partials(parts)


spmv_ell_plain.launches = 0


def spmv_ell_cuda(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
                  br: int, mode: str, k_noise: int, static: bool):
    """Launch ``csrc/spmv_ell.cu`` (static-k build or runtime-k library):
    one launch, the partials reduced in the kernel's epilogue with the
    current stream's workspace."""
    R, L, br, nb = _shapes(vals, x, br)
    if br != 128 or L % 8:
        raise ValueError("the CUDA spmv takes 128-row blocks and a row width "
                         f"that is a multiple of 8; got br={br}, L={L}")
    if not (vals.dtype == x.dtype == torch.float32 and cols.dtype == torch.int32):
        raise ValueError("the CUDA spmv takes float32 vals/x and int32 cols")
    if not (vals.is_cuda and cols.device == vals.device == x.device):
        raise ValueError("vals, cols and x must lie on one CUDA device")
    vals, cols, x = vals.contiguous(), cols.contiguous(), x.contiguous()
    bpc = blocks_per_cta(nb)
    dev = vals.device
    stream = _build.stream_handle(dev.index)
    ws = ns.workspace(-(-nb // bpc), dev, stream)
    y = torch.empty(R, dtype=torch.float32, device=dev)
    nacc = ns.new_nacc(dev)
    _build.launch("spmv_ell", "spmv",
                  (vals, cols, x, y, ws.partials, ws.chunk_sums, ws.counters,
                   nacc), (R, L, bpc),
                  mode_id=ns.MODE_IDS[mode], k=k_noise, static=static,
                  stream=stream)
    spmv_ell_cuda.launches += 1
    return y, nacc


spmv_ell_cuda.launches = 0


def _check_mode(mode: str) -> None:
    if mode not in ("none", "fp", "vmem"):
        raise ValueError(f"spmv_ell supports noise modes none/fp/vmem, not "
                         f"{mode!r} (it has no noise operand, hence no mxu)")


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             br: int = 128, mode: str = "none", k_noise: int = 0):
    """vals, cols (R, L); x (N,) -> (y (R,), nacc (8,128)). Static k."""
    _check_mode(mode)
    if _build.on_card(vals):
        return spmv_ell_cuda(vals, cols, x, br=br, mode=mode,
                             k_noise=int(k_noise), static=True)
    return spmv_ell_plain(vals, cols, x, br=br, mode=mode,
                          k_noise=int(k_noise))


def spmv_ell_rt(k: int, vals: torch.Tensor, cols: torch.Tensor,
                x: torch.Tensor, *, br: int = 128, mode: str = "fp"):
    """Runtime-k twin of ``spmv_ell`` (k clipped to [0, K_MAX]); bitwise
    equal to it at the same k."""
    _check_mode(mode)
    if _build.on_card(vals):
        return spmv_ell_cuda(vals, cols, x, br=br, mode=mode, k_noise=int(k),
                             static=False)
    return spmv_ell_plain(vals, cols, x, br=br, mode=mode,
                          k_noise=ns.clip_k(k))
