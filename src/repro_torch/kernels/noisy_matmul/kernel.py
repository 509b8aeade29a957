"""Tiled matmul with instruction-level noise slots (the paper's Fig. 4).

Grid (M/bm, N/bn, K/bk), K innermost; one noise slot after each tile's
product at ``step = i*131 + j*17 + kk``, the vmem source being the A tile.
``matmul(a, b, noise, mode=..., k_noise=...)`` bakes k into a static build;
``matmul_rt(k, a, b, noise, mode=...)`` takes k at run time. Both return
``(out, nacc)``. For tensors on the CPU they take the plain version
``matmul_plain``; for CUDA tensors they launch ``csrc/noisy_matmul.cu``
(f32, 128-wide tiles, TF32 wgmma fed by a TMA ring) or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import noise_slots as ns

TILE = 128   # the CUDA kernel's bm = bn = bk

# csrc/noisy_matmul.cu's shared-memory layout, mirrored: a ring of stages,
# each a 32-wide K slice of A and of B^T (128 x 32 f32 each), the staged
# noise operand in mxu mode (128 rows of REPRO_NZ_STRIDE floats), a full
# and an empty mbarrier per stage, and slack to align the ring to 1024.
SLICE_BYTES = TILE * 32 * 4
NZ_BYTES = 128 * 132 * 4


def ring_depth(mode: str) -> int:
    """Stages in the kernel's ring: mxu gives two of six to the noise."""
    return 4 if mode == "mxu" else 6


def smem_bytes(mode: str) -> int:
    """Dynamic shared memory the CUDA kernel takes in ``mode``; the launch
    passes it and the kernel refuses a value other than its own."""
    depth = ring_depth(mode)
    return (depth * 2 * SLICE_BYTES + (NZ_BYTES if mode == "mxu" else 0)
            + 2 * depth * 8 + 1024)


def _shapes(a, b, bm, bn, bk):
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"{(M, N, K)} does not tile by {(bm, bn, bk)}")
    return M, N, K, bm, bn, bk


def matmul_plain(a: torch.Tensor, b: torch.Tensor, noise: torch.Tensor, *,
                 mode: str = "none", k_noise: int = 0, bm: int = TILE,
                 bn: int = TILE, bk: int = TILE):
    """Plain PyTorch version of the kernel's arithmetic: a @ b in f32; one
    noise partial per output tile (i, j) — the kernel's CTA — holding the
    patterns of its K steps in order; the partials reduced in the card's
    order."""
    matmul_plain.launches += 1
    M, N, K, bm, bn, bk = _shapes(a, b, bm, bn, bk)
    out = (a.to(torch.float32) @ b.to(torch.float32)).to(a.dtype)
    nj = N // bn
    parts = ns.new_partials((M // bm) * nj, a.device)
    if mode != "none" and k_noise:
        for i in range(M // bm):
            for j in range(nj):
                for kk in range(K // bk):
                    ns.emit_noise(mode, k_noise, parts[i * nj + j], noise,
                                  src=a[i * bm:(i + 1) * bm,
                                        kk * bk:(kk + 1) * bk],
                                  step=i * 131 + j * 17 + kk)
    return out, ns.reduce_partials(parts)


matmul_plain.launches = 0


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, noise: torch.Tensor, *,
                mode: str, k_noise: int, bm: int, bn: int, bk: int,
                static: bool):
    """Launch ``csrc/noisy_matmul.cu`` (static-k build or runtime-k
    library)."""
    M, N, K, bm, bn, bk = _shapes(a, b, bm, bn, bk)
    if (bm, bn, bk) != (TILE,) * 3:
        raise ValueError(f"the CUDA matmul takes {TILE}-wide tiles; got "
                         f"{(bm, bn, bk)}")
    if not (a.dtype == b.dtype == noise.dtype == torch.float32):
        raise ValueError("the CUDA matmul takes float32 operands")
    if not (a.is_cuda and a.device == b.device == noise.device):
        raise ValueError("a, b and noise must lie on one CUDA device")
    if tuple(noise.shape) != ns.NOISE_REF_SHAPE:
        raise ValueError(f"noise must be {ns.NOISE_REF_SHAPE}")
    a, b, noise = a.contiguous(), b.contiguous(), noise.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    bt = torch.empty((N, K), dtype=torch.float32, device=a.device)  # B^T
    stream = _build.stream_handle(a.device.index)
    partials, scratch, nacc = ns.card_buffers((M // TILE) * (N // TILE),
                                              a.device, stream)
    _build.launch("noisy_matmul", "matmul",
                  (a, b, noise, out, bt, partials, scratch, nacc),
                  (M, N, K, smem_bytes(mode)),
                  mode_id=ns.MODE_IDS[mode], k=k_noise, static=static,
                  stream=stream)
    matmul_cuda.launches += 1
    return out, nacc


matmul_cuda.launches = 0


def _check_mode(mode: str) -> None:
    if mode not in ns.MODES:
        raise ValueError(f"unknown kernel noise mode {mode!r}; one of {ns.MODES}")


def matmul(a: torch.Tensor, b: torch.Tensor, noise: torch.Tensor, *,
           mode: str = "none", k_noise: int = 0, bm: int = TILE,
           bn: int = TILE, bk: int = TILE):
    """a (M,K) @ b (K,N) -> (out (M,N), nacc (8,128) f32). Static k."""
    _check_mode(mode)
    if _build.on_card(a):
        return matmul_cuda(a, b, noise, mode=mode, k_noise=int(k_noise),
                           bm=bm, bn=bn, bk=bk, static=True)
    return matmul_plain(a, b, noise, mode=mode, k_noise=int(k_noise),
                        bm=bm, bn=bn, bk=bk)


def matmul_rt(k: int, a: torch.Tensor, b: torch.Tensor, noise: torch.Tensor,
              *, mode: str = "fp", bm: int = TILE, bn: int = TILE,
              bk: int = TILE):
    """Runtime-k twin of ``matmul`` (k clipped to [0, K_MAX]); bitwise equal
    to it at the same k."""
    _check_mode(mode)
    if _build.on_card(a):
        return matmul_cuda(a, b, noise, mode=mode, k_noise=int(k), bm=bm,
                           bn=bn, bk=bk, static=False)
    return matmul_plain(a, b, noise, mode=mode, k_noise=ns.clip_k(k),
                        bm=bm, bn=bn, bk=bk)
