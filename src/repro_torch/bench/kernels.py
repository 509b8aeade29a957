"""The paper's validation kernels (its Sec. 4 and Fig. 4) as loop regions
on the card, each a CUDA kernel whose loop body holds the noise slot
(``kernels/loop_regions``), with the reference's names, parameters,
defaults and ``body_size``s (``repro.bench.kernels``):

  stream_region     STREAM triad       — memory-bandwidth-bound
  lat_mem_rd_region LMBench lat_mem_rd — memory-latency-bound (pointer chase)
  haccmk_region     Coral HACCmk       — FP32-throughput-bound force kernel
  spmxv_region      EPI SPMXV (ELL) with swap probability q (the paper's
                    Sec. 6)
  matmul_region     Fig. 4 rank-1 loops, naive ("-O0": the output row
                    through memory every step) or register-blocked ("-O3")

and the paper's DECAN loops (``kernels/decan_loops``) as ``DecanTarget``s:

  table3_target     a Table 3 scenario (token / stream / scatter_dep)
  livermore_target  Fig. 6's Livermore loop

Every region returns a ``RegionTarget`` ready for
``Controller.characterize()``; a DECAN target's ``region()`` is one. ``device``: "cuda" (the default; raises
without a card) or "cpu" (the plain PyTorch versions).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.convert import to_torch
from repro_torch.core.controller import RegionTarget, loop_region
from repro_torch.core.decan import DecanTarget
from repro_torch.core.loopnoise import chase_table
from repro_torch.kernels.decan_loops import kernel as dk
from repro_torch.kernels.decan_loops import ref as dref
from repro_torch.kernels.loop_regions import kernel as lk
from repro_torch.kernels.loop_regions import ref as lref
from repro_torch.kernels.region import resolve_device
from repro_torch.kernels.spmv_ell.ref import make_band_ell


def _loop_sass(kernel: str, unroll: int = 1) -> tuple:
    """The loop region's SASS site: ``kernel`` of the loop_regions.cu static
    builds, whose innermost loop runs ``unroll`` iterations a pass."""
    return ("loop_regions", ((kernel, ""),), unroll)


def _maker(run, plain_run, **kw):
    """``make_fn`` for ``loop_region``: the wrapper ``run`` (kernel or, for
    CPU tensors, plain version) or, with ``plain``, the plain version."""
    def make(noise, k, static=True, plain=False):
        mode = "none" if noise is None else noise.name

        def fn(*args):
            carry = args[-1] if noise is not None else None
            base = args[:-1] if noise is not None else args
            if plain:
                out = plain_run(*base, mode=mode, k=k, carry=carry, **kw)
            else:
                out = run(*base, mode=mode, k=k, carry=carry, static=static,
                          **kw)
            return out if noise is not None else out[0]
        return fn
    return make


# ---------------------------------------------------------------------------
# STREAM triad: c[i] = a[i] + s*b[i] over buffers far larger than the cache
# ---------------------------------------------------------------------------

def stream_region(n: int = 1 << 23, chunk: int = 512, *,
                  device="cuda") -> RegionTarget:
    """a = 1, b = 2, c = 0 (the reference's); a warp per chunk on the
    card."""
    dev = resolve_device(device)
    a = torch.ones(n, dtype=torch.float32, device=dev)
    b = torch.full((n,), 2.0, dtype=torch.float32, device=dev)
    c = torch.zeros(n, dtype=torch.float32, device=dev)
    return loop_region("stream_triad",
                       _maker(lk.stream_triad, lref.stream_triad_plain,
                              chunk=chunk),
                       lambda: (a, b, c), body_size=5, n_iter=n // chunk,
                       device=dev, sass=_loop_sass("stream_kernel"))


# ---------------------------------------------------------------------------
# lat_mem_rd: serially dependent pointer chase (the kernel IS a latency probe)
# ---------------------------------------------------------------------------

def lat_mem_rd_region(table_len: int = 1 << 21, hops_per_iter: int = 8,
                      n_iter: int = 4096, seed: int = 1, *,
                      device="cuda") -> RegionTarget:
    """The reference's table: the cycle of ``RandomState(seed)``'s
    permutation, started at its first element."""
    dev = resolve_device(device)
    perm = np.random.RandomState(seed).permutation(table_len).astype(np.int32)
    table = chase_table(torch.from_numpy(perm)).to(dev)
    idx0 = torch.tensor([int(perm[0])], dtype=torch.int32, device=dev)
    return loop_region("lat_mem_rd",
                       _maker(lk.lat_mem_rd, lref.lat_mem_rd_plain,
                              n_iter=n_iter, hops=hops_per_iter),
                       lambda: (table, idx0), body_size=hops_per_iter,
                       n_iter=n_iter, device=dev,
                       sass=_loop_sass("lat_kernel"))


# ---------------------------------------------------------------------------
# HACCmk: short-range force kernel — six independent accumulator chains per
# lane keep the FP32 pipes busy (the paper's compute-bound reference)
# ---------------------------------------------------------------------------

def haccmk_region(n_iter: int = 120_000, width: int = 8, *,
                  device="cuda") -> RegionTarget:
    """x = linspace(0.1, 0.9, width); a thread per lane on the card."""
    dev = resolve_device(device)
    x = to_torch((np.linspace(0.1, 0.9, width).astype(np.float32),), dev)[0]
    return loop_region("haccmk",
                       _maker(lk.haccmk, lref.haccmk_plain, n_iter=n_iter),
                       lambda: (x,), body_size=5 * lref.HACC_CHAINS,
                       n_iter=n_iter, device=dev,
                       sass=_loop_sass("haccmk_kernel"))


# ---------------------------------------------------------------------------
# SPMXV (the paper's Sec. 6): ELL spmv, swap probability q controls gather
# locality
# ---------------------------------------------------------------------------

def spmxv_region(n: int = 1 << 20, nnz_per_row: int = 16, q: float = 0.0,
                 rows_per_iter: int = 64, seed: int = 0, name: str = "", *,
                 device="cuda") -> RegionTarget:
    """The reference's band matrix and x (``make_band_ell``, RandomState
    seed + 1); a warp per ``rows_per_iter`` rows on the card."""
    dev = resolve_device(device)
    vals, cols = make_band_ell(n, nnz_per_row, q, seed=seed)
    x = np.random.RandomState(seed + 1).standard_normal(n).astype(np.float32)
    vals, cols, x = to_torch((vals, cols, x), dev)
    y = torch.zeros(n, dtype=torch.float32, device=dev)
    return loop_region(name or f"spmxv_q{q}",
                       _maker(lk.spmxv, lref.spmxv_plain,
                              rows_per_iter=rows_per_iter),
                       lambda: (vals, cols, x, y), body_size=6,
                       n_iter=n // rows_per_iter, device=dev,
                       sass=_loop_sass("spmxv_kernel"))


# ---------------------------------------------------------------------------
# Fig. 4: dense rank-1 loops, naive vs register-blocked
# ---------------------------------------------------------------------------

def matmul_region(n: int = 192, optimized: bool = False, *,
                  device="cuda") -> RegionTarget:
    """Both variants run k-step rank-1 updates. "-O0" (no mem2reg): ONE
    output row round-trips through memory every k-step, loads and stores
    dominate. "-O3" (register blocking): each loaded b-row feeds EIGHT
    register-resident accumulator rows; on the card bound by FP32 issue
    (16 unfused FADD/FMUL an iteration), with its loads in flight and its
    |body| derived per iteration of an unrolled trip (``MM_O3_UNROLL``).
    a and b come from ``RandomState(0)`` / ``(1)`` (the reference draws
    them from ``PRNGKey(0)`` / ``(1)``, whose bits PyTorch cannot give)."""
    dev = resolve_device(device)
    a, b = to_torch(tuple(np.random.RandomState(seed).standard_normal((n, n))
                          .astype(np.float32) for seed in (0, 1)), dev)
    if optimized:
        n_iter = 16 * n
        return loop_region("matmul_O3",
                           _maker(lk.matmul_o3, lref.matmul_o3_plain,
                                  n_iter=n_iter),
                           lambda: (a, b), body_size=2 * lref.ROWS_O3 + 1,
                           n_iter=n_iter, device=dev,
                           sass=_loop_sass("mm_o3_kernel",
                                           lref.MM_O3_UNROLL))
    n_iter = 32 * n // lref.UNROLL_O0
    out = torch.zeros((1, n), dtype=torch.float32, device=dev)
    return loop_region("matmul_O0",
                       _maker(lk.matmul_o0, lref.matmul_o0_plain,
                              n_iter=n_iter),
                       lambda: (a, b, out), body_size=5 * lref.UNROLL_O0,
                       n_iter=n_iter, device=dev,
                       sass=_loop_sass("mm_o0_kernel"))


# ---------------------------------------------------------------------------
# The paper's DECAN loops (its Table 3 and Fig. 6): decremental targets whose
# reference variant is also a loop region with a noise slot
# ---------------------------------------------------------------------------

def _variants(run, kw):
    """``DecanTarget.build``: the variant keeping FP and/or LS, without
    noise, as a callable returning the loop's output (``run`` the wrapper,
    on the run-time library, or the plain version)."""
    def build(fp: bool, ls: bool):
        def fn(*args):
            return run(*args, fp=fp, ls=ls, **kw)[0]
        return fn
    return build


def _seeded(seed: int, n: int, dev) -> tuple:
    """a, b, c standard normal and x0 uniform in [0.1, 0.9) from
    ``default_rng(seed)``: inputs under which a load from a wrong address
    changes the output."""
    rng = np.random.default_rng(seed)
    arrays = tuple(rng.standard_normal(n, dtype=np.float32) for _ in range(3))
    x0 = rng.uniform(0.1, 0.9, 8).astype(np.float32)
    return to_torch((*arrays, x0), dev)


def table3_target(name: str, kind: str, depth: int, n_iter: int, *,
                  n: int = 1 << 22, width: Optional[int] = None,
                  seed: Optional[int] = None, device="cuda") -> DecanTarget:
    """One Table 3 scenario (``benchmarks/table3_decan.py:_kernel``): a = 1,
    b = 2, c = 0, x0 = linspace(0.1, 0.9, 8), the reference's inputs, or
    with ``seed`` seeded random ones (``_seeded``; the checks').
    ``width``: lanes (8 a copy of the reference's loop; stream: default
    one copy a grid-stride warp)."""
    dev = resolve_device(device)
    if seed is None:
        a = torch.ones(n, dtype=torch.float32, device=dev)
        b = torch.full((n,), 2.0, dtype=torch.float32, device=dev)
        c = torch.zeros(n, dtype=torch.float32, device=dev)
        x0 = to_torch((np.linspace(0.1, 0.9, 8).astype(np.float32),), dev)[0]
    else:
        a, b, c, x0 = _seeded(seed, n, dev)
    kw = {"kind": kind, "depth": depth, "n_iter": n_iter, "width": width}
    return DecanTarget(name, _variants(dk.table3, kw), lambda: (a, b, c, x0),
                       build_noisy=_maker(dk.table3, dref.table3_plain, **kw),
                       n_iter=n_iter, device=dev,
                       build_plain=_variants(dref.table3_plain, kw),
                       sass=("decan_loops", (
                           ("t3_kernel", f"ILi{dref.KINDS[kind]}ELb1ELb1E"),)))


def livermore_target(n_iter: int, *, n: int = 1 << 18, width: int = 8,
                     seed: Optional[int] = None,
                     device="cuda") -> DecanTarget:
    """Fig. 6's Livermore loop (``benchmarks/fig6_overlap.py:_livermore``)
    on a buffer of ones, the reference's, or with ``seed`` a standard
    normal one from ``default_rng(seed)``; named as the reference's. It
    states no |body|: the derived one is the clean SASS's innermost loop,
    an unrolled trip, over its ``LIV_UNROLL`` iterations."""
    dev = resolve_device(device)
    if seed is None:
        buf = torch.ones(n, dtype=torch.float32, device=dev)
    else:
        buf = _seeded(seed, n, dev)[0]
    kw = {"n_iter": n_iter, "width": width}
    return DecanTarget("livermore_1351", _variants(dk.livermore, kw),
                       lambda: (buf,),
                       build_noisy=_maker(dk.livermore, dref.livermore_plain,
                                          **kw),
                       n_iter=n_iter, device=dev,
                       build_plain=_variants(dref.livermore_plain, kw),
                       sass=("decan_loops", (("liv_kernel", "ILb1ELb1E"),),
                             dref.LIV_UNROLL))
