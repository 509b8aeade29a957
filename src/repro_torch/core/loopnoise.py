"""Loop-body noise emitters — the direct analogue of the paper's LLVM pass.

The paper injects assembly patterns INTO the target loop body so the
processor can overlap them with the loop's own instructions. On the H100
each validation loop is one CUDA kernel (``csrc/loop_regions.cu``) whose
loop body holds a noise slot; the device functions of
``csrc/loop_noise.cuh`` emit the k patterns there, with k a run-time
argument. This module holds the modes' plain PyTorch emitters: the
arithmetic the card's patterns do, the reference (``repro.core.loopnoise``)
in PyTorch.

Protocol, as the reference's:

  init(generator)        -> carry dict of small noise buffers (disjoint from
                            the kernel's state: the paper's R_n ∩ R_s = ∅)
  emit(carry, k, i)      -> new carry after k patterns; ``i`` is the loop
                            induction variable (varies offsets, so patterns
                            cannot be hoisted or merged)
  emit_rt(carry, k, i)   -> the same patterns with k a run-time ``int`` (in
                            PyTorch both are plain ints: the same function)
  finalize(carry)        -> scalar aux (the DCE-proof sink)

``init`` draws from a ``torch.Generator``; the reference draws from
``jax.random``, whose bits PyTorch cannot give, so tests hand both packages
the same carry (``convert.carry_to_torch``).

Offsets are the reference's traced int32 arithmetic: products wrap at 32
bits, then a floor modulo (jnp's ``%``) picks the row. ``_wrap32`` and
Python's ``%`` reproduce that for ints and int64 tensors alike; C's ``%``
on an int64 product would pick other rows, and a negative offset would
read outside the buffer.

``i`` may be an int or an int64 tensor of loop indices, and the carries'
leaves may carry leading batch dimensions (one carry per thread group):
``kernels/loop_regions/ref.py`` runs the card's grouping that way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

VEC = 8          # noise vector width (one AVX2 f32 register; 8 lanes of a warp)
N_CHAINS = 4     # independent accumulator chains, patterns round-robin over them

L1_ROWS = 512            # 512*8*4 B = 16 KiB: L1-resident
MEM_ROWS = 1 << 21       # the reference's 64 MiB buffer (sized for a CPU's LLC)
CHASE_LEN = 1 << 20      # the reference's 4 MiB chase table
# On the card the H100's 50 MB L2 would hold the reference's buffers, so the
# regions built for CUDA tensors take 256 MiB ones (``noise_size``)
CARD_MEM_ROWS = 1 << 23  # 8M rows * 32 B = 256 MiB
CARD_CHASE_LEN = 1 << 26  # 64M int32 = 256 MiB

FMA_MUL = 0.999999       # fp_fma's multiplier, as f32

# the CUDA sources' enum (csrc/loop_noise.cuh)
MODE_IDS = {"none": 0, "fp_add": 1, "fp_fma": 2, "l1_ld": 3, "mem_ld": 4,
            "chase": 5}


@dataclasses.dataclass(frozen=True)
class LoopNoise:
    """One loop-level noise mode: its emitters and what it stresses."""
    name: str
    target: str                       # compute | l1 | memory | latency
    init: Callable[..., Any]
    emit: Callable[[Any, int, Any], Any]
    finalize: Callable[[Any], torch.Tensor]
    payload_op: str = "add"           # dominant op of one pattern
    emit_rt: Optional[Callable[[Any, int, Any], Any]] = None
    description: str = ""


def noise_size(mode: str, device) -> Optional[int]:
    """Rows (mem_ld) or table length (chase) of a carry built for
    ``device``: the card's 256 MiB buffers on CUDA, the reference's sizes
    on the CPU; None for the modes with small buffers."""
    card = torch.device(device).type == "cuda"
    if mode == "mem_ld":
        return CARD_MEM_ROWS if card else MEM_ROWS
    if mode == "chase":
        return CARD_CHASE_LEN if card else CHASE_LEN
    return None


def _wrap32(x):
    """Two's-complement wrap to int32 of an int or an int64 tensor."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def l1_offset(i, j: int):
    """Row of l1_ld pattern j at iteration i: (i*7 + j*13) % L1_ROWS in
    int32."""
    return _wrap32(_wrap32(i * 7) + j * 13) % L1_ROWS


def mem_offset(i, k: int, j: int, rows: int):
    """Row of mem_ld pattern j at iteration i: ((i*max(k,1) + j) * 40503) %
    rows in int32."""
    return _wrap32(_wrap32(_wrap32(i * max(k, 1)) + j) * 40_503) % rows


def _zeros_like_accs(shape=(VEC,), device="cpu"):
    return tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                 for _ in range(N_CHAINS))


def _take_rows(buf: torch.Tensor, off) -> torch.Tensor:
    """buf[off] for an int offset or a tensor of offsets."""
    if isinstance(off, torch.Tensor):
        return buf[off.long()]
    return buf[int(off)]


# ---------------------------------------------------------------------------
# fp_add — chained vector adds, round-robin over N_CHAINS accumulators
# ---------------------------------------------------------------------------

def _fp_init(generator=None, device="cpu", size=None):
    c = torch.randn(VEC, generator=generator, dtype=torch.float32) * 1e-6
    return {"c": c.to(device), "accs": _zeros_like_accs(device=device)}


def _fp_emit(carry, k, i):
    accs = list(carry["accs"])
    for j in range(k):
        accs[j % N_CHAINS] = accs[j % N_CHAINS] + carry["c"]
    return dict(carry, accs=tuple(accs))


def _fp_finalize(carry):
    return sum(a.sum(dim=-1) for a in carry["accs"])


# ---------------------------------------------------------------------------
# fp_fma — multiply-add patterns, acc = fma(acc, 0.999999, c), rounded once
# as the card's FFMA does
# ---------------------------------------------------------------------------

def fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 fused multiply-add a*b + c (the card's
    ``__fmaf_rn``). a*b is exact in f64; the f64 sum's rounding error is
    recovered exactly (TwoSum) and breaks the one case where rounding the
    f64 sum to f32 differs from rounding the exact value: a sum that lies
    exactly halfway between two floats."""
    b64 = float(torch.tensor(b, dtype=torch.float32))
    p = a.double() * b64
    c64 = c.double()
    s = p + c64
    bp = s - c64
    e = (p - bp) + (c64 - (s - bp))
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.full_like(r, math.inf),
                         torch.full_like(r, -math.inf))
    nb = torch.nextafter(r, toward)
    tie = (d != 0) & ((nb.double() - s) == d)
    fix = tie & (e != 0) & ((e > 0) == (d > 0))
    return torch.where(fix, nb, r)


def _fma_emit(carry, k, i):
    accs = list(carry["accs"])
    for j in range(k):
        accs[j % N_CHAINS] = fma_f32(accs[j % N_CHAINS], FMA_MUL, carry["c"])
    return dict(carry, accs=tuple(accs))


# ---------------------------------------------------------------------------
# l1_ld — reads of a 16 KiB buffer at rotating offsets (paper: l1_ld64)
# ---------------------------------------------------------------------------

def _l1_init(generator=None, device="cpu", size=None):
    buf = torch.randn(L1_ROWS, VEC, generator=generator, dtype=torch.float32)
    return {"buf": buf.to(device), "accs": _zeros_like_accs(device=device)}


def _l1_emit(carry, k, i):
    buf = carry["buf"]
    accs = list(carry["accs"])
    for j in range(k):
        accs[j % N_CHAINS] = accs[j % N_CHAINS] + _take_rows(buf, l1_offset(i, j))
    return dict(carry, accs=tuple(accs))


# ---------------------------------------------------------------------------
# mem_ld — strided reads of a buffer far larger than the last-level cache
# ---------------------------------------------------------------------------

def _mem_init(generator=None, device="cpu", size=None):
    rows = MEM_ROWS if size is None else int(size)
    buf = (torch.arange(rows * VEC, dtype=torch.int64, device=device)
           .to(torch.float32).reshape(rows, VEC) * 1e-9)
    return {"buf": buf, "accs": _zeros_like_accs(device=device)}


def _mem_emit(carry, k, i):
    buf = carry["buf"]
    rows = buf.shape[0]
    accs = list(carry["accs"])
    for j in range(k):
        off = mem_offset(i, k, j, rows)
        accs[j % N_CHAINS] = accs[j % N_CHAINS] + _take_rows(buf, off)
    return dict(carry, accs=tuple(accs))


# ---------------------------------------------------------------------------
# chase — serially dependent loads (lat_mem_rd's own access pattern)
# ---------------------------------------------------------------------------

def chase_table(perm: torch.Tensor) -> torch.Tensor:
    """The cyclic successor table of a permutation: table[perm[t]] =
    perm[t+1], closing the cycle."""
    table = torch.empty_like(perm)
    table[perm[:-1]] = perm[1:]
    table[perm[-1]] = perm[0]
    return table


def _chase_init(generator=None, device="cpu", size=None):
    length = CHASE_LEN if size is None else int(size)
    perm = torch.randperm(length, generator=generator, dtype=torch.int64)
    table = chase_table(perm).to(torch.int32)
    return {"table": table.to(device),
            "idx": perm[0].to(torch.int32).to(device)}


def _chase_emit(carry, k, i):
    table, idx = carry["table"], carry["idx"]
    for _ in range(k):
        idx = table[idx.long()]
    return dict(carry, idx=idx)


def _chase_finalize(carry):
    return carry["idx"].to(torch.float32)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def make_loop_modes() -> dict[str, LoopNoise]:
    """The five loop-level modes, by name (the reference's registry)."""
    return {
        "fp_add": LoopNoise(
            "fp_add", "compute", _fp_init, _fp_emit, _fp_finalize, "add",
            emit_rt=_fp_emit,
            description="round-robin chained vector adds (paper: fp_add64)"),
        "fp_fma": LoopNoise(
            "fp_fma", "compute", _fp_init, _fma_emit, _fp_finalize, "add",
            emit_rt=_fma_emit,
            description="round-robin chained FMAs — saturates FMA ports faster"),
        "l1_ld": LoopNoise(
            "l1_ld", "l1", _l1_init, _l1_emit, _fp_finalize, "dynamic-slice",
            emit_rt=_l1_emit,
            description="rotating reads of a 16 KiB resident buffer "
                        "(paper: l1_ld64)"),
        "mem_ld": LoopNoise(
            "mem_ld", "memory", _mem_init, _mem_emit, _fp_finalize,
            "dynamic-slice", emit_rt=_mem_emit,
            description="strided reads of a buffer far larger than the "
                        "last-level cache (paper: memory_ld64)"),
        "chase": LoopNoise(
            "chase", "latency", _chase_init, _chase_emit, _chase_finalize,
            "dynamic-slice", emit_rt=_chase_emit,
            description="serially dependent pointer chase (latency probe)"),
    }


# Paper-facing aliases.
PAPER_LOOP_ALIASES = {
    "fp_add64": "fp_add",
    "l1_ld64": "l1_ld",
    "memory_ld64": "mem_ld",
}


_CARRIES: dict = {}


def loop_carry(mode: str, device="cpu") -> dict:
    """The carry of ``mode`` for regions on ``device``: drawn once per
    process from a generator seeded with 0 and shared by every region (the
    kernels read carries, never write them); the card's mem_ld and chase
    buffers are 256 MiB each (``noise_size``)."""
    dev = torch.device(device)
    key = (mode, str(dev))
    if key not in _CARRIES:
        gen = torch.Generator().manual_seed(0)
        _CARRIES[key] = make_loop_modes()[mode].init(
            gen, dev, noise_size(mode, dev))
    return _CARRIES[key]


def noisy_loop(body, n_iter: int, init_carry, noise: LoopNoise, k: int,
               generator: Optional[torch.Generator] = None):
    """Run ``body(i, carry) -> carry`` for ``n_iter`` iterations with ``k``
    noise patterns of ``noise`` emitted per iteration, in plain PyTorch.

    Returns (final_carry, noise_aux): the generic injection site; the
    validation regions emit in their own CUDA loop bodies instead."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    nc = noise.init(generator)
    carry = init_carry
    for i in range(n_iter):
        carry = body(i, carry)
        nc = noise.emit(nc, k, i)
    return carry, noise.finalize(nc)
