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


# Per-row tolerance of the TF32 kernel's output against the IEEE f32 plain
# version, for ``flash_attention.ref.row_excess``: |got - want| <= 1.5e-3 of
# each row's largest value. The kernel reads A's f32 bits as TF32 (the
# tensor cores drop the low 13 bits) and B rounded to TF32; with standard
# normal operands that stays within 0.48 of this limit at n = 512 and 4096
# on the H100, and the same kernel fed a and b rounded to bf16 lands at
# 2.36 or more (chip_smoke.py phase 3 holds both).
TF32_ROW_TOL = 1.5e-3
