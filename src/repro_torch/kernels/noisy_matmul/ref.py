"""Oracles and the default noise operand for the noisy matmul kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.noise_slots import NOISE_REF_SHAPE


def default_noise_operand(device="cpu", dtype=torch.float32) -> torch.Tensor:
    """The (128,128) noise operand every kernel region uses: arange * 1e-6
    in f32, the reference's ``default_noise_operand``."""
    n = NOISE_REF_SHAPE[0] * NOISE_REF_SHAPE[1]
    return (torch.arange(n, dtype=torch.float32, device=device)
            .reshape(NOISE_REF_SHAPE) * 1e-6).to(dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32, cast back to a's dtype."""
    return (a.to(torch.float32) @ b.to(torch.float32)).to(a.dtype)


def fp_noise_ref(noise: torch.Tensor, k_noise: int,
                 n_grid_steps: int) -> torch.Tensor:
    """nacc oracle for mode='fp'."""
    return k_noise * n_grid_steps * noise[0:8, :].to(torch.float32)
