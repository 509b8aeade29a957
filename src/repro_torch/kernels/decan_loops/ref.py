"""Plain PyTorch versions of the DECAN loop kernels (``csrc/decan_loops.cu``).

Each computes what its kernel computes, in the kernel's grouping and order,
so that on the card the output and the aux can be held against it bit for
bit (one rounding per operation, as the kernels' __fmul_rn / __fadd_rn):

* ``width`` lanes in groups of 8; each group is one copy of the reference's
  8-lane loop. Stream scenarios: a group a warp, the warps walking the
  iterations grid-stride; the others: every group runs every iteration,
  scatter_dep's group g on the address stream of iterations i + g*n_iter;
* a thread's value ((a0+a1)+a2)+a3 + ((x0+x1)+x2)+x3 (Livermore: its 12
  chains in order, then its load accumulator; stream: lanes 0..7 of each
  warp only), summed by the kernels' block trees and last block
  (``loop_regions.ref.reduce_threads``), then added to sum(cb[:8]);
* the noise carries as the loop regions keep them
  (``loop_regions.ref._warp_aux`` / ``_uniform_aux``).

With one group (width 8) a plain version is the reference's loop
(``benchmarks/table3_decan.py:_kernel``, ``fig6_overlap.py:_livermore``):
its output differs from the reference's only by the order of the final f32
sums.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.loopnoise import _wrap32
from repro_torch.kernels.loop_regions.ref import (THREADS, _uniform_aux,
                                                  _warp_aux, n_warps,
                                                  reduce_threads)

KINDS = {"token": 0, "stream": 1, "scatter_dep": 2}
CHUNK = 512          # the triad chunk of an iteration
WINDOW = 4096        # token's L1-resident window
N_CH = 4             # chains and accumulators
LIV_CHUNK = 64
LIV_CHAINS = 12


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def default_width(kind: str, n_iter: int) -> int:
    """A stream scenario's lanes: 8 for each of ``n_warps(n_iter)`` warps,
    the loop regions' grid-stride constant."""
    if kind != "stream":
        raise ValueError(f"{kind} needs an explicit width")
    return 8 * n_warps(n_iter)


def groups_of(width: int) -> int:
    if width < 8 or width % 8:
        raise ValueError(f"width must be a positive multiple of 8; got {width}")
    return width // 8


def chains(x: torch.Tensor, depth: int) -> torch.Tensor:
    """``depth`` steps of y = y + (y*y)*1e-9, elementwise."""
    c = _f32(1e-9, x)
    for _ in range(depth):
        x = x + (x * x) * c
    return x


def _sum4(v: torch.Tensor) -> torch.Tensor:
    return ((v[0] + v[1]) + v[2]) + v[3]


def first8(v: torch.Tensor) -> torch.Tensor:
    """sum(v[:8]) from 0, in order."""
    s = torch.zeros((), dtype=torch.float32, device=v.device)
    for e in range(8):
        s = s + v[e]
    return s


def _floor_mod(v, m: int):
    return v % m     # Python's and torch's % are floor modulo


def triad_chunks(a, b, cout, n_iter: int) -> torch.Tensor:
    """The stream scenarios' LS part: cout[off:off+CHUNK] = a + 3 b at every
    iteration's offset (i*CHUNK) % (n-CHUNK), int32-wrapped; returns
    cout."""
    n = a.shape[0]
    it = torch.arange(n_iter, dtype=torch.int64, device=a.device)
    offs = _floor_mod(_wrap32(it * CHUNK), n - CHUNK)
    idx = (offs[:, None] + torch.arange(CHUNK, device=a.device)).reshape(-1)
    cout[idx] = a[idx] + b[idx] * _f32(3.0, b)
    return cout


def table3_plain(a, b, c, x0, *, kind: str, depth: int, n_iter: int,
                 fp: bool = True, ls: bool = True,
                 width: Optional[int] = None, mode: str = "none", k: int = 0,
                 carry: Optional[dict] = None,
                 cout: Optional[torch.Tensor] = None):
    """Table 3's scenario loop over ``width`` lanes -> (out, aux).
    ``cout``: the stream scenarios' triad buffer, written as the kernel
    writes it (without it the triad's first 8 values alone are
    computed)."""
    table3_plain.launches += 1
    if kind not in KINDS:
        raise ValueError(f"unknown Table 3 kind {kind!r}; one of "
                         f"{sorted(KINDS)}")
    dev = a.device
    n = a.shape[0]
    width = default_width(kind, n_iter) if width is None else width
    G = groups_of(width)
    xs0 = torch.stack([x0 + _f32(float(j), x0) for j in range(N_CH)])  # (4, 8)
    if kind == "stream":
        xs = xs0[:, None, :].expand(N_CH, G, 8).clone()
        base = torch.arange(G, device=dev)
        for r in range(-(-n_iter // G)):
            active = (base + r * G) < n_iter
            if fp:
                xs = torch.where(active[None, :, None], chains(xs, depth), xs)
        values = torch.zeros((G, 32), dtype=torch.float32, device=dev)
        values[:, :8] = _sum4(torch.zeros_like(xs)) + _sum4(xs)   # acc = 0
        total = reduce_threads(values.reshape(-1))
        aux = _warp_aux(mode, carry, k, n_iter, dev, warps=G)
        if ls and cout is not None:
            triad_chunks(a, b, cout, n_iter)
        if not (ls and n_iter > 0):
            cb = c[:8]
        elif cout is not None:
            cb = cout[:8]
        else:       # iteration 0 writes the first chunk
            cb = a[:8] + b[:8] * _f32(3.0, b)
    else:
        # token: every group the same (computed once); scatter_dep: each
        # group its own address stream
        P = 1 if kind == "token" else G
        lanes = torch.arange(8, device=dev)
        acc = torch.zeros((N_CH, P, 8), dtype=torch.float32, device=dev)
        xs = xs0[:, None, :].expand(N_CH, P, 8).clone()
        gs = torch.arange(P, dtype=torch.int64, device=dev)
        c12 = _f32(1e-12, a)
        for i in range(n_iter):
            if ls and kind == "token":
                for j in range(2):
                    off = _floor_mod(_wrap32(_wrap32(i * 2 + j) * 16), WINDOW)
                    acc[j] = acc[j] + a[off:off + 8]
            elif ls:
                ig = _wrap32(i + _wrap32(gs * n_iter))
                for j in range(N_CH):
                    off = _floor_mod(_wrap32(_wrap32(ig * 4 + j) * 40_503),
                                     n - 8)
                    acc[j] = acc[j] + a[off[:, None] + lanes[None, :]]
            if fp:
                if kind == "scatter_dep" and ls:
                    xs = acc * c12 + xs
                xs = chains(xs, depth)
        values = (_sum4(acc) + _sum4(xs)).expand(G, 8) if P == 1 \
            else _sum4(acc) + _sum4(xs)
        total = reduce_threads(values.reshape(-1))
        aux = _uniform_aux(mode, carry, k, n_iter, width, dev)
        cb = c[:8]
    return first8(cb) + total, aux


def livermore_plain(buf, *, n_iter: int, width: int, fp: bool = True,
                    ls: bool = True, mode: str = "none", k: int = 0,
                    carry: Optional[dict] = None):
    """Fig. 6's Livermore loop over ``width`` lanes -> (out, aux). Every
    group runs the same loop, so one group is computed and repeated."""
    livermore_plain.launches += 1
    dev = buf.device
    n = buf.shape[0]
    G = groups_of(width)
    ch = torch.arange(LIV_CHAINS, dtype=torch.float32, device=dev)[:, None] \
        .expand(LIV_CHAINS, 8).clone()
    acc = torch.zeros(8, dtype=torch.float32, device=dev)
    c7 = _f32(1e-7, buf)
    for i in range(n_iter):
        if ls:
            off = _floor_mod(_wrap32(i * LIV_CHUNK), n - LIV_CHUNK)
            acc = acc + buf[off:off + 8]
        if fp:
            ch = ch + c7
    per_lane = ch[0]
    for j in range(1, LIV_CHAINS):
        per_lane = per_lane + ch[j]
    per_lane = per_lane + acc
    total = reduce_threads(per_lane.expand(G, 8).reshape(-1), THREADS)
    return total, _uniform_aux(mode, carry, k, n_iter, width, dev)


for _fn in (table3_plain, livermore_plain):
    _fn.launches = 0
