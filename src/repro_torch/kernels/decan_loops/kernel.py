"""The DECAN loops of the paper's Table 3 and Fig. 6 as CUDA kernels
(``csrc/decan_loops.cu``): the FP / LS removal variants compiled apart,
and a loop-body noise slot in the reference variant.

Each wrapper returns ``(out, aux)``: the loop's output and the noise
carry's sum (0.0 without noise). For tensors on the CPU it takes the plain
version (``ref.py``); for CUDA tensors it launches the kernel or raises.
``fp``/``ls``: the variant (both: the reference); the removal variants run
without noise. ``static``: the static-k build of (mode, k), unrolled (the
payload check and the SASS census); else the run-time library, k clipped to
[0, K_MAX]; without noise the run-time library serves every call.
``width``: lanes, 8 for each copy of the reference's 8-lane loop (stream
scenarios: one copy a warp, ``ref.default_width`` by default).

A call is one launch: the kernel sums its blocks in its own epilogue, with
the block sums and its ticket counter in the stream's ``noise_slots``
workspace. ``*_cuda.launches`` counts the calls that launched.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decan_loops import ref
from repro_torch.kernels.loop_regions import kernel as lk
from repro_torch.kernels.loop_regions.kernel import _check, _check_mode, _k

def _launch(entry, dev, tensors, ints, mode, carry, k, static, n_blocks):
    """Launch ``repro_<entry>_{static,rt}`` of ``csrc/decan_loops.cu``
    (without noise: the run-time library); returns res (2,): [out, aux]."""
    return lk._launch(entry, dev, tensors, ints, mode, carry, k,
                      static and mode != "none", n_blocks,
                      source="decan_loops")


def _variant(fp: bool, ls: bool, mode: str) -> None:
    if not (fp or ls):
        raise ValueError("a DECAN variant keeps FP, LS or both")
    if mode != "none" and not (fp and ls):
        raise ValueError("the removal variants run without noise")


def _blocks(threads: int) -> int:
    return max(1, -(-threads // ref.THREADS))


# ---------------------------------------------------------------------------
# Table 3's scenario loop
# ---------------------------------------------------------------------------

def table3_cuda(a, b, c, x0, *, kind, depth, n_iter, fp, ls, width, mode, k,
                carry, static, cout=None):
    """Launch t3_kernel: a warp per iteration (stream) or every lane group
    through every iteration (token, scatter_dep)."""
    dev = _check((a, b, c, x0), (torch.float32,) * 4)
    n = a.shape[0]
    if b.shape[0] != n or c.shape[0] != n or x0.shape != (8,):
        raise ValueError("table3: a, b, c must be one length and x0 (8,)")
    if kind == "stream" and (n < 2 * ref.CHUNK or n % 4):
        raise ValueError("table3 stream: n must be a multiple of 4 and at "
                         f"least {2 * ref.CHUNK}")
    if n < ref.WINDOW + 8:
        raise ValueError(f"table3: n must be at least {ref.WINDOW + 8}")
    groups = ref.groups_of(width)
    threads = 32 * groups if kind == "stream" else width
    # the triad writes a buffer nobody reads (the dead buffer of the LS
    # part) unless the caller passes one to check
    if kind == "stream" and ls:
        if cout is None:
            cout = torch.empty_like(a)
        elif cout.shape != a.shape or cout.dtype != a.dtype \
                or cout.device != a.device:
            raise ValueError("table3: cout must be like a")
    else:
        cout = a
    res = _launch("t3", dev, (a, b, c, x0, cout),
                  (n, n_iter, depth, groups, width, ref.KINDS[kind], int(fp),
                   int(ls)), mode, carry, k, static, _blocks(threads))
    table3_cuda.launches += 1
    return res[0], res[1]


def table3(a, b, c, x0, *, kind: str, depth: int, n_iter: int,
           fp: bool = True, ls: bool = True, width: Optional[int] = None,
           mode: str = "none", k: int = 0, carry: Optional[dict] = None,
           static: bool = True, cout: Optional[torch.Tensor] = None):
    """Table 3's loop (``kind`` token | stream | scatter_dep, ``depth``
    chain steps an iteration) over ``width`` lanes -> (out, aux).
    ``cout``: the stream scenarios' triad buffer (default: a fresh one
    nobody reads), written in place."""
    _check_mode(mode)
    _variant(fp, ls, mode)
    if kind not in ref.KINDS:
        raise ValueError(f"unknown Table 3 kind {kind!r}; one of "
                         f"{sorted(ref.KINDS)}")
    width = ref.default_width(kind, n_iter) if width is None else width
    if _build.on_card(a):
        return table3_cuda(a, b, c, x0, kind=kind, depth=depth, n_iter=n_iter,
                           fp=fp, ls=ls, width=width, mode=mode,
                           k=_k(k, static), carry=carry, static=static,
                           cout=cout)
    return ref.table3_plain(a, b, c, x0, kind=kind, depth=depth,
                            n_iter=n_iter, fp=fp, ls=ls, width=width,
                            mode=mode, k=_k(k, static), carry=carry,
                            cout=cout)


# ---------------------------------------------------------------------------
# Fig. 6's Livermore loop
# ---------------------------------------------------------------------------

def livermore_cuda(buf, *, n_iter, width, fp, ls, mode, k, carry, static):
    """Launch liv_kernel: every lane group through every iteration."""
    dev = _check((buf,), (torch.float32,))
    n = buf.shape[0]
    if n <= 2 * ref.LIV_CHUNK or n_iter * ref.LIV_CHUNK >= 2 ** 31:
        raise ValueError(f"livermore: the buffer must exceed "
                         f"{2 * ref.LIV_CHUNK} and n_iter * {ref.LIV_CHUNK} "
                         "stay below 2^31 (the kernel steps its offset)")
    ref.groups_of(width)
    res = _launch("liv", dev, (buf,), (n, n_iter, width, int(fp), int(ls)),
                  mode, carry, k, static, _blocks(width))
    livermore_cuda.launches += 1
    return res[0], res[1]


def livermore(buf, *, n_iter: int, width: int, fp: bool = True,
              ls: bool = True, mode: str = "none", k: int = 0,
              carry: Optional[dict] = None, static: bool = True):
    """12 add chains and one 8-wide load an iteration over ``width`` lanes
    -> (out, aux)."""
    _check_mode(mode)
    _variant(fp, ls, mode)
    if _build.on_card(buf):
        return livermore_cuda(buf, n_iter=n_iter, width=width, fp=fp, ls=ls,
                              mode=mode, k=_k(k, static), carry=carry,
                              static=static)
    return ref.livermore_plain(buf, n_iter=n_iter, width=width, fp=fp, ls=ls,
                               mode=mode, k=_k(k, static), carry=carry)


for _fn in (table3_cuda, livermore_cuda):
    _fn.launches = 0

# kernel name -> (CUDA launcher, plain version): the counters chip_smoke.py
# and the studies' stats read
DECAN_KERNELS = {
    "decan_table3": (table3_cuda, ref.table3_plain),
    "decan_livermore": (livermore_cuda, ref.livermore_plain),
}
