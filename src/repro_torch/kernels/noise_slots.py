"""Kernel-level noise slots — instruction-granularity injection inside the
port's CUDA kernels, and their plain PyTorch versions.

Every noisy kernel writes a dedicated (8,128) f32 ``nacc`` accumulator,
disjoint from its real outputs (the paper's R_n ∩ R_s = ∅). Its exact value
is predictable, so the accumulator is both the DCE-proof sink of the noise
and the payload oracle.

Modes (same names and arithmetic as the reference package):
  fp    — k (8,128) f32 vector adds on the accumulator
  mxu   — k (8,128)·(128,128) products of the noise operand (tensor cores
          on the card: TF32 ``mma.sync``, see ``csrc/noise_slots.cuh``)
  vmem  — k re-reads of (8,w) blocks of the kernel's own input block at
          rotating offsets (shared memory on the card)

``emit_noise`` takes k as a static Python int and ``emit_noise_rt`` clips
a runtime k to [0, K_MAX]; pattern j of both computes the same arithmetic
in the same order, so the two are bitwise identical for any k ≤ K_MAX. On
the card the same contract holds between the runtime-k shared library and
the static-k builds (``kernels/_build.py``).

On the card every CTA adds its patterns into its own (8,128) partial and
the partials are summed in a fixed order (``reduce_partials`` below is that
order in plain PyTorch): in the kernel's own epilogue for the probe and
spmv (one launch a call), by ``nacc_reduce`` launches after the kernel for
the matmul and attention. The partials, the chunk sums and the epilogue's
counters are a ``Workspace`` kept per (device, stream). The plain versions
of the kernels follow the same decomposition, one pattern at a time, so the
card's fp and vmem accumulators can be held against them tightly; against
the reference, which adds every grid step into one accumulator, they
differ only by the order of f32 additions.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

NOISE_SHAPE = (8, 128)          # one VREG row group
NOISE_REF_SHAPE = (128, 128)    # MXU-aligned noise operand

MODES = ("none", "fp", "mxu", "vmem")
MODE_IDS = {m: i for i, m in enumerate(MODES)}   # the CUDA sources' enum

# Upper bound on the runtime noise quantity a single grid step may emit; every
# controller sweep schedule stays below it (max scheduled k: 320).
K_MAX = 512


def clip_k(k) -> int:
    """The runtime noise quantity as the kernels use it: clipped to
    [0, K_MAX]."""
    return max(0, min(int(k), K_MAX))


def _fp_c(noise: Optional[torch.Tensor],
          src: Optional[torch.Tensor]) -> torch.Tensor:
    """The (8,128) addend of one fp pattern.

    With a dedicated noise operand: its first row group. Without one (the
    spmv kernel), the addend is the source block's first 8 rows of column 0,
    broadcast across lanes: a compile-time-constant addend would let a
    compiler strength-reduce the k-add chain to one ``nacc += k*c``.

    ``REPRO_NOISE_SABOTAGE=const`` deliberately reintroduces that constant
    addend (the reference's audit fail-fast switch). Never set it in a
    measuring run.
    """
    if os.environ.get("REPRO_NOISE_SABOTAGE") == "const":
        dev = (noise if noise is not None else src).device
        return torch.full(NOISE_SHAPE, 1.0, dtype=torch.float32, device=dev)
    if noise is not None:
        return noise[0:8, :]
    if src is None:
        raise ValueError("fp noise needs a noise operand or a source block to "
                         "derive its addend from")
    return src[0:8, 0:1].to(torch.float32).expand(NOISE_SHAPE)


def _pattern(mode: str, j: int, nacc: torch.Tensor,
             noise: Optional[torch.Tensor], src: Optional[torch.Tensor],
             step: int, c: Optional[torch.Tensor]) -> None:
    if mode == "fp":
        nacc += c
    elif mode == "mxu":
        nacc += noise[0:8, :] @ noise
    elif mode == "vmem":
        blk = src if src is not None else noise
        rows = blk.shape[0]
        w = min(blk.shape[1], NOISE_SHAPE[1])
        off = (step * 7 + j * 13) % max(rows - 8, 1)
        nacc[:, 0:w] += blk[off:off + 8, 0:w].to(nacc.dtype)
    else:
        raise ValueError(f"unknown kernel noise mode {mode!r}; one of {MODES}")


def emit_noise(mode: str, k: int, nacc: torch.Tensor,
               noise: Optional[torch.Tensor], src: Optional[torch.Tensor] = None,
               step: int = 0) -> None:
    """Add ``k`` patterns of ``mode`` into ``nacc`` in place (k static).

    ``step``: the grid-step index that rotates vmem offsets."""
    if mode not in MODES:
        raise ValueError(f"unknown kernel noise mode {mode!r}; one of {MODES}")
    if mode == "none" or k == 0:
        return
    c = _fp_c(noise, src) if mode == "fp" else None
    for j in range(k):
        _pattern(mode, j, nacc, noise, src, step, c)


def emit_noise_rt(mode: str, k: int, nacc: torch.Tensor,
                  noise: Optional[torch.Tensor],
                  src: Optional[torch.Tensor] = None, step: int = 0) -> None:
    """``emit_noise`` with a runtime ``k``, clipped to [0, K_MAX]: pattern j
    is the arithmetic of static pattern j, so both are bitwise identical."""
    emit_noise(mode, clip_k(k), nacc, noise, src, step)


REDUCE_CHUNK = 32    # partials per chunk sum of the card's reduction


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(parts.shape[1:], dtype=parts.dtype, device=parts.device)
    for p in parts:
        acc = acc + p
    return acc


def reduce_partials(parts: torch.Tensor) -> torch.Tensor:
    """nacc from per-CTA partials (P, 8, 128), in the card's order: chunks of
    ``REDUCE_CHUNK`` partials summed in order, then the chunk sums in
    order."""
    chunks = [_sum_in_order(parts[i:i + REDUCE_CHUNK])
              for i in range(0, parts.shape[0], REDUCE_CHUNK)]
    if len(chunks) == 1:
        return chunks[0]
    return _sum_in_order(torch.stack(chunks))


def new_partials(n: int, device) -> torch.Tensor:
    """``n`` zeroed (8,128) f32 partials."""
    return torch.zeros((n, *NOISE_SHAPE), dtype=torch.float32, device=device)


def n_chunks(n_cta: int) -> int:
    return -(-n_cta // REDUCE_CHUNK)


class Workspace:
    """Scratch of the card's cross-CTA reduction for one (device, stream):
    ``partials`` (n_cta, 8, 128) f32, ``chunk_sums`` (n_chunks, 8, 128) f32
    and ``counters`` (1 + n_chunks,) int32 for the ticket epilogue of
    ``csrc/noise_slots.cuh`` (``reduce_fused``). The counters are zeroed
    here, on the stream, and every launch leaves them at 0."""

    __slots__ = ("n_cta", "partials", "chunk_sums", "counters")

    def __init__(self, n_cta: int, device: torch.device):
        self.n_cta = n_cta
        self.partials = torch.empty((n_cta, *NOISE_SHAPE),
                                    dtype=torch.float32, device=device)
        self.chunk_sums = torch.empty((n_chunks(n_cta), *NOISE_SHAPE),
                                      dtype=torch.float32, device=device)
        self.counters = torch.zeros(1 + n_chunks(n_cta), dtype=torch.int32,
                                    device=device)


# (device, raw stream handle) -> Workspace. Keyed by stream: two streams
# sharing counters would mix their tickets. Launches on one stream run in
# order, so one workspace serves them all, and a workspace replaced by a
# larger one is freed to the stream it was allocated on.
WORKSPACES: dict = {}


def workspace(n_cta: int, device: torch.device, stream: int) -> Workspace:
    """The workspace of ``stream`` on ``device`` (the stream current when it
    is used), grown to hold ``n_cta`` partials; never shrunk."""
    ws = WORKSPACES.get((device, stream))
    if ws is None or ws.n_cta < n_cta:
        ws = WORKSPACES[(device, stream)] = Workspace(n_cta, device)
    return ws


def new_nacc(device) -> torch.Tensor:
    """A fresh (8,128) f32 ``nacc`` output: callers keep it, so it is never
    workspace."""
    return torch.empty(NOISE_SHAPE, dtype=torch.float32, device=device)


def card_buffers(n_cta: int, device, stream: int):
    """What one matmul or attention launch writes besides its outputs: the
    CTAs' partials and ``nacc_reduce``'s chunk sums (views of the stream's
    workspace), and a fresh ``nacc``."""
    ws = workspace(n_cta, device, stream)
    return ws.partials, ws.chunk_sums, new_nacc(device)


def expected_fp_noise(noise: torch.Tensor, k: int, n_steps: int
                      ) -> torch.Tensor:
    """Oracle for mode='fp': nacc = k * n_steps * noise[0:8, :]."""
    return k * n_steps * noise[0:8, :].to(torch.float32)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round f32 values to TF32 (10 mantissa bits, ties away from zero) as
    ``cvt.rna.tf32.f32`` does before a tensor-core product — what the mxu
    oracle applies to its operands when it is held against the card."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
