"""The validation loops of ``repro.bench.kernels`` as CUDA kernels with a
loop-body noise slot (``csrc/loop_regions.cu``, ``csrc/loop_noise.cuh``).

Each wrapper returns ``(out, aux)``: the region's output and the noise
carry's sum (0.0 without noise). For tensors on the CPU it takes the plain
version (``ref.py``); for CUDA tensors it launches the kernel or raises.
``static``: the static-k build of (mode, k), fully unrolled (the payload
check and the SASS census); else the run-time library, k clipped to
[0, K_MAX]. ``carry``: the mode's noise carry (``core.loopnoise``), on the
tensors' device.

A call is one launch: the kernel sums its blocks in its own epilogue, with
the block sums and its ticket counter in the stream's ``noise_slots``
workspace. Each wrapper's ``launches`` counts the calls that launched.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.loopnoise import MODE_IDS
from repro_torch.kernels import _build
from repro_torch.kernels import noise_slots as ns
from repro_torch.kernels.loop_regions import ref
from repro_torch.kernels.noise_slots import clip_k

_DUMMIES: dict = {}


def _dummies(device: torch.device):
    """A float and an int32 placeholder for the noise operands a mode does
    not read (the kernel never dereferences them)."""
    key = str(device)
    if key not in _DUMMIES:
        _DUMMIES[key] = (torch.zeros(1, dtype=torch.float32, device=device),
                         torch.zeros(1, dtype=torch.int32, device=device))
    return _DUMMIES[key]


# (mode, device) -> (carry, operands) of the carry converted last: the
# regions share one carry per mode and device (``loop_carry``), so a sweep
# converts it once; another carry replaces it
_OPERANDS: dict = {}


def noise_operands(mode: str, carry: Optional[dict], device) -> tuple:
    """(nf, nacc0, ntab, nidx0, rows_mask): the carry as the kernels take
    it (csrc/loop_noise.cuh ``NoiseArgs``)."""
    if mode == "none":
        fdummy, idummy = _dummies(device)
        return fdummy, fdummy, idummy, idummy, 0
    if carry is None:
        raise ValueError(f"noise mode {mode!r} needs its carry")
    key = (mode, str(device))
    hit = _OPERANDS.get(key)
    if hit is None or hit[0] is not carry:
        hit = _OPERANDS[key] = (carry, _operands(mode, carry, device))
    return hit[1]


def _operands(mode: str, carry: dict, device) -> tuple:
    fdummy, idummy = _dummies(device)
    if mode == "chase":
        table, idx = carry["table"], carry["idx"]
        if table.dtype != torch.int32 or table.device != device:
            raise ValueError("the chase table must be int32 on the region's "
                             "device")
        return (fdummy, fdummy, table.contiguous(),
                idx.reshape(1).to(torch.int32), 0)
    nacc0 = torch.stack(list(carry["accs"])).to(torch.float32).contiguous()
    src = carry["c"] if mode in ("fp_add", "fp_fma") else carry["buf"]
    if src.dtype != torch.float32 or src.device != device:
        raise ValueError(f"{mode} carry must be float32 on the region's "
                         "device")
    rows_mask = 0
    if mode == "mem_ld":
        rows = src.shape[0]
        if rows & (rows - 1):
            raise ValueError(f"mem_ld rows must be a power of two; got {rows}")
        rows_mask = rows - 1
    return src.contiguous(), nacc0, idummy, idummy, rows_mask


def _check(tensors, dtypes) -> torch.device:
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise ValueError(f"expected {dt}, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError("region tensors must be contiguous on one "
                             "CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("region tensors must be 16-byte aligned")
    return dev


_WS_FLOATS = ns.NOISE_SHAPE[0] * ns.NOISE_SHAPE[1]   # a workspace partial


def _launch(entry, dev, tensors, ints, mode, carry, k, static, n_blocks,
            scratch: int = 0, source: str = "loop_regions"):
    """Launch ``repro_<entry>_{static,rt}`` of ``csrc/<source>.cu``; returns
    res (2,): [out, aux]. The block sums (2 floats a block), ``scratch``
    floats more (passed after ``tensors``) and the ticket counter are the
    stream's workspace."""
    nf, nacc0, ntab, nidx0, rows_mask = noise_operands(mode, carry, dev)
    stream = _build.stream_handle(dev.index)
    used = 2 * n_blocks + scratch
    ws = ns.workspace(-(-used // _WS_FLOATS), dev, stream)
    flat = ws.partials.view(-1)
    if scratch:
        tensors = (*tensors, flat[2 * n_blocks:used])
    res = torch.empty(2, dtype=torch.float32, device=dev)
    _build.launch(source, entry,
                  (*tensors, nf, nacc0, ntab, nidx0, flat, ws.counters, res),
                  (*ints, rows_mask), mode_id=MODE_IDS[mode], k=int(k),
                  static=static, stream=stream)
    return res


def _blocks(n: int, per: int) -> int:
    return max(1, -(-n // per))


def _check_mode(mode: str) -> None:
    if mode not in MODE_IDS:
        raise ValueError(f"unknown loop noise mode {mode!r}; one of "
                         f"{sorted(MODE_IDS)}")


def _k(k, static: bool) -> int:
    return int(k) if static else clip_k(k)


# ---------------------------------------------------------------------------
# stream_triad
# ---------------------------------------------------------------------------

def stream_triad_cuda(a, b, c, *, chunk, mode, k, carry, static):
    """Launch stream_kernel: a warp per chunk of ``chunk`` elements."""
    dev = _check((a, b, c), (torch.float32,) * 3)
    n_iter = a.shape[0] // chunk
    w = ref.n_warps(n_iter)
    out = torch.empty_like(c)
    m = n_iter * chunk
    if m < c.shape[0]:
        out[m:] = c[m:]
    res = _launch("stream", dev, (a, b, out), (n_iter, chunk, w), mode,
                  carry, k, static, _blocks(w, ref.WARPS_PER_BLOCK))
    stream_triad_cuda.launches += 1
    return out, res[1]


def stream_triad(a, b, c, *, chunk: int = 512, mode: str = "none", k: int = 0,
                 carry: Optional[dict] = None, static: bool = True):
    """c = a + 3 b in chunks of ``chunk`` (the tail past the last whole
    chunk is c as given) -> (c, aux)."""
    _check_mode(mode)
    if _build.on_card(a):
        return stream_triad_cuda(a, b, c, chunk=chunk, mode=mode,
                                 k=_k(k, static), carry=carry, static=static)
    return ref.stream_triad_plain(a, b, c, chunk=chunk, mode=mode,
                                  k=_k(k, static), carry=carry)


# ---------------------------------------------------------------------------
# lat_mem_rd
# ---------------------------------------------------------------------------

def lat_mem_rd_cuda(table, idx0, *, n_iter, hops, mode, k, carry, static):
    """Launch lat_kernel: one warp walks the chain."""
    dev = _check((table, idx0), (torch.int32, torch.int32))
    res = _launch("lat", dev, (table, idx0), (n_iter, hops), mode, carry, k,
                  static, 1)
    lat_mem_rd_cuda.launches += 1
    return res[0], res[1]


def lat_mem_rd(table, idx0, *, n_iter: int, hops: int = 8, mode: str = "none",
               k: int = 0, carry: Optional[dict] = None, static: bool = True):
    """The chase's index after n_iter * hops dependent loads, as a float ->
    (out, aux)."""
    _check_mode(mode)
    idx0 = idx0.reshape(1)
    if _build.on_card(table):
        return lat_mem_rd_cuda(table, idx0, n_iter=n_iter, hops=hops,
                               mode=mode, k=_k(k, static), carry=carry,
                               static=static)
    return ref.lat_mem_rd_plain(table, idx0, n_iter=n_iter, hops=hops,
                                mode=mode, k=_k(k, static), carry=carry)


# ---------------------------------------------------------------------------
# haccmk
# ---------------------------------------------------------------------------

def haccmk_cuda(x, *, n_iter, mode, k, carry, static):
    """Launch haccmk_kernel: a thread per lane of ``x``."""
    dev = _check((x,), (torch.float32,))
    width = x.shape[0]
    res = _launch("haccmk", dev, (x,), (width, n_iter), mode, carry, k,
                  static, _blocks(width, ref.THREADS))
    haccmk_cuda.launches += 1
    return res[0], res[1]


def haccmk(x, *, n_iter: int, mode: str = "none", k: int = 0,
           carry: Optional[dict] = None, static: bool = True):
    """Six HACC polynomial chains per lane of x for n_iter iterations ->
    (sum of the chains, aux)."""
    _check_mode(mode)
    if _build.on_card(x):
        return haccmk_cuda(x, n_iter=n_iter, mode=mode, k=_k(k, static),
                           carry=carry, static=static)
    return ref.haccmk_plain(x, n_iter=n_iter, mode=mode, k=_k(k, static),
                            carry=carry)


# ---------------------------------------------------------------------------
# spmxv
# ---------------------------------------------------------------------------

def spmxv_cuda(vals, cols, x, y, *, rows_per_iter, mode, k, carry, static):
    """Launch spmxv_kernel: a warp per block of ``rows_per_iter`` rows."""
    dev = _check((vals, cols, x, y), (torch.float32, torch.int32,
                                      torch.float32, torch.float32))
    R, L = vals.shape
    n_iter = R // rows_per_iter
    w = ref.n_warps(n_iter)
    out = torch.empty_like(y)
    m = n_iter * rows_per_iter
    if m < y.shape[0]:
        out[m:] = y[m:]
    res = _launch("spmxv", dev, (vals, cols, x, out),
                  (n_iter, rows_per_iter, L, w), mode, carry, k, static,
                  _blocks(w, ref.WARPS_PER_BLOCK))
    spmxv_cuda.launches += 1
    return out, res[1]


def spmxv(vals, cols, x, y, *, rows_per_iter: int = 64, mode: str = "none",
          k: int = 0, carry: Optional[dict] = None, static: bool = True):
    """ELL y = A x, ``rows_per_iter`` rows an iteration (rows past the last
    whole block are y as given) -> (y, aux)."""
    _check_mode(mode)
    if _build.on_card(vals):
        return spmxv_cuda(vals, cols, x, y, rows_per_iter=rows_per_iter,
                          mode=mode, k=_k(k, static), carry=carry,
                          static=static)
    return ref.spmxv_plain(vals, cols, x, y, rows_per_iter=rows_per_iter,
                           mode=mode, k=_k(k, static), carry=carry)


# ---------------------------------------------------------------------------
# matmul_O0 / matmul_O3
# ---------------------------------------------------------------------------

def matmul_o0_cuda(a, b, out0, *, n_iter, mode, k, carry, static):
    """Launch mm_o0_kernel: a thread per column of the one output row."""
    dev = _check((a, b, out0), (torch.float32,) * 3)
    n = a.shape[0]
    # the output row's round trips go through n workspace floats
    res = _launch("mm_o0", dev, (a, b, out0), (n, n_iter), mode, carry, k,
                  static, _blocks(n, ref.THREADS), scratch=n)
    matmul_o0_cuda.launches += 1
    return res[0], res[1]


def matmul_o0(a, b, out0, *, n_iter: int, mode: str = "none", k: int = 0,
              carry: Optional[dict] = None, static: bool = True):
    """The naive ("-O0") rank-1 loop: one output row through memory ->
    (its sum, aux)."""
    _check_mode(mode)
    if _build.on_card(a):
        return matmul_o0_cuda(a, b, out0, n_iter=n_iter, mode=mode,
                              k=_k(k, static), carry=carry, static=static)
    return ref.matmul_o0_plain(a, b, out0, n_iter=n_iter, mode=mode,
                               k=_k(k, static), carry=carry)


def _check_o3(n: int) -> None:
    """n the kernel takes: its 8 rows, and a[:8, :n] in its shared stage
    ((n + MM_O3_AHEAD) x 32 bytes)."""
    if not ref.ROWS_O3 <= n <= ref.MM_O3_MAX_N:
        raise ValueError(f"matmul_O3 takes {ref.ROWS_O3} <= n <= "
                         f"{ref.MM_O3_MAX_N} (MM_O3_MAX_N: a[:8, :n] staged "
                         f"in shared memory); got n={n}")


def matmul_o3_cuda(a, b, *, n_iter, mode, k, carry, static):
    """Launch mm_o3_kernel: a thread per column, eight rows in registers,
    blocks of ``MM_O3_THREADS``."""
    dev = _check((a, b), (torch.float32,) * 2)
    n = a.shape[0]
    _check_o3(n)
    res = _launch("mm_o3", dev, (a, b), (n, n_iter), mode, carry, k, static,
                  _blocks(n, ref.MM_O3_THREADS))
    matmul_o3_cuda.launches += 1
    return res[0], res[1]


def matmul_o3(a, b, *, n_iter: int, mode: str = "none", k: int = 0,
              carry: Optional[dict] = None, static: bool = True):
    """The register-blocked ("-O3") rank-1 loop -> (sum of the eight rows,
    aux). n past the kernel's shared stage (``MM_O3_MAX_N``) is refused on
    either device."""
    _check_mode(mode)
    _check_o3(a.shape[0])
    if _build.on_card(a):
        return matmul_o3_cuda(a, b, n_iter=n_iter, mode=mode, k=_k(k, static),
                              carry=carry, static=static)
    return ref.matmul_o3_plain(a, b, n_iter=n_iter, mode=mode,
                               k=_k(k, static), carry=carry)


for _fn in (stream_triad_cuda, lat_mem_rd_cuda, haccmk_cuda, spmxv_cuda,
            matmul_o0_cuda, matmul_o3_cuda):
    _fn.launches = 0

# region name -> (CUDA launcher, plain version): the counters chip_smoke.py
# and the fleet's worker stats read
REGION_KERNELS = {
    "stream_triad": (stream_triad_cuda, ref.stream_triad_plain),
    "lat_mem_rd": (lat_mem_rd_cuda, ref.lat_mem_rd_plain),
    "haccmk": (haccmk_cuda, ref.haccmk_plain),
    "spmxv": (spmxv_cuda, ref.spmxv_plain),
    "matmul_O0": (matmul_o0_cuda, ref.matmul_o0_plain),
    "matmul_O3": (matmul_o3_cuda, ref.matmul_o3_plain),
}
