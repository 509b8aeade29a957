"""Oracles for ELL SPMV and the ELL matrix generator of the SPMXV case study
(band matrix with swap probability q, paper §6).

The noise oracles are closed-form and vectorised (index arithmetic on
tensors, summed in f64): at the main path's size (2^21 rows, k up to 320)
the reference's Python loops over blocks × k would take minutes inside the
payload check. ``tests/test_torch_kernels.py`` holds them equal to the
reference's loop oracles.
"""
from __future__ import annotations

import numpy as np
import torch


def spmv_ell_ref(vals: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_l vals[r,l] * x[cols[r,l]] (padded entries have vals=0)."""
    g = x[cols.long()]
    return (vals.to(torch.float32) * g.to(torch.float32)).sum(dim=1).to(x.dtype)


def fp_noise_ell_ref(vals: torch.Tensor, k_noise: int,
                     br: int = 128) -> torch.Tensor:
    """Exact nacc oracle for spmv_ell mode='fp'.

    Block i's addend is its first 8 rows' first column broadcast across
    lanes, so nacc = k * sum_i broadcast(vals[i*br : i*br+8, 0])."""
    R, L = vals.shape
    br = min(br, R)
    nb = R // br
    c = vals[:nb * br].reshape(nb, br, L)[:, 0:8, 0].double().sum(dim=0)
    return (k_noise * c)[:, None].expand(8, 128).to(torch.float32).contiguous()


def vmem_noise_ell_ref(vals: torch.Tensor, k_noise: int,
                       br: int = 128) -> torch.Tensor:
    """Exact nacc oracle for spmv_ell mode='vmem': block i re-reads its own
    (8, min(L,128)) row groups at offsets (i*7 + j*13) % max(br-8, 1) for
    j < k. Counted per (block, offset), then summed as one contraction."""
    R, L = vals.shape
    br = min(br, R)
    nb = R // br
    w = min(L, 128)
    m = max(br - 8, 1)
    dev = vals.device
    out = torch.zeros((8, 128), dtype=torch.float64, device=dev)
    if k_noise == 0:
        return out.to(torch.float32)
    blk = torch.arange(nb, device=dev, dtype=torch.int64)[:, None]
    pat = torch.arange(k_noise, device=dev, dtype=torch.int64)[None, :]
    off = (blk * 7 + pat * 13) % m
    counts = torch.bincount((blk * m + off).flatten(),
                            minlength=nb * m).reshape(nb, m).double()
    blocks = vals[:nb * br].reshape(nb, br, L)[:, :, 0:w].double()
    for p in range(8):
        out[p, 0:w] = torch.einsum("io,iow->w", counts, blocks[:, p:p + m, :])
    return out.to(torch.float32)


def make_band_ell(n: int, nnz_per_row: int, q: float, seed: int = 0,
                  dtype=np.float32):
    """Banded sparse matrix in ELL with the paper's swap-probability q, as
    numpy arrays (vals, cols).

    Line for line the reference's generator, so both packages build the same
    matrix from the same seed. At q=0 the nonzeros of row r sit at columns
    r-w..r+w (stride-1 vector access, prefetch friendly). Each nonzero is
    swapped with probability q to a uniformly random column.
    """
    rng = np.random.RandomState(seed)
    w = nnz_per_row // 2
    base = np.arange(n)[:, None] + (np.arange(nnz_per_row)[None, :] - w)
    cols = np.clip(base, 0, n - 1).astype(np.int32)
    swap = rng.random_sample(cols.shape) < q
    cols[swap] = rng.randint(0, n, size=int(swap.sum()), dtype=np.int32)
    vals = rng.random_sample(cols.shape).astype(dtype) * 0.1
    return vals, cols
