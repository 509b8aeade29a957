"""Oracles for the probe kernel: the exact accumulated value per mode,
computed in closed form (vectorised over steps × patterns, summed in f64)."""
from __future__ import annotations

import torch

from repro_torch.kernels.noise_slots import NOISE_SHAPE, round_tf32


def probe_ref(noise: torch.Tensor, *, mode: str, k_noise: int, n_steps: int,
              tf32: bool = False) -> torch.Tensor:
    """nacc after ``n_steps`` grid steps of ``k_noise`` patterns each.

    ``tf32``: round the mxu operands to TF32 first, as the card's tensor
    cores do (the oracle the payload check holds a CUDA build against)."""
    nf = noise.to(torch.float32)
    if mode == "none" or k_noise == 0:
        return torch.zeros(NOISE_SHAPE, dtype=torch.float32, device=noise.device)
    if mode == "fp":
        return k_noise * n_steps * nf[0:8, :]
    if mode == "mxu":
        op = round_tf32(nf) if tf32 else nf
        one = op[0:8, :].double() @ op.double()
        return (k_noise * n_steps * one).to(torch.float32)
    if mode == "vmem":
        rows = noise.shape[0]
        m = max(rows - 8, 1)
        dev = noise.device
        steps = torch.arange(n_steps, device=dev, dtype=torch.int64)[:, None]
        pats = torch.arange(k_noise, device=dev, dtype=torch.int64)[None, :]
        counts = torch.bincount(((steps * 7 + pats * 13) % m).flatten(),
                                minlength=m).double()
        rows_idx = (torch.arange(m, device=dev)[:, None]
                    + torch.arange(8, device=dev)[None, :])
        windows = nf.double()[rows_idx][:, :, 0:128]          # (m, 8, 128)
        return torch.einsum("o,opw->pw", counts, windows).to(torch.float32)
    raise ValueError(mode)
