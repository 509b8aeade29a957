"""The graph-level noise modes (``core/noise.py``) as CUDA kernels
(``csrc/graph_noise.cu``): one launch a call, k a run-time argument or,
with ``static``, unrolled in a build of its own (the reference's
trace-per-k ``apply``).

Each wrapper takes the mode's state tensors and returns the aux and the new
state; the inputs are left as they were. For tensors on the CPU it takes
the plain version (``ref.py``); for CUDA tensors it launches the kernel or
raises. ``plain``: the plain version on any device (what the kernel is
held against). ``*_cuda.launches`` counts the calls that launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import noise_slots as ns
from repro_torch.kernels.graph_noise import ref
from repro_torch.kernels.loop_regions.kernel import _check, _k

# the CUDA source's mode ids (csrc/graph_noise.cu GMODE_*)
MODE_IDS = {"fp_add32": 1, "mxu_fma128": 2, "vmem_ld": 3, "hbm_stream": 4,
            "hbm_latency": 5}
# mode -> the kernel its static builds launch: what a step region's noise
# is in SASS (ici_allreduce's no-mesh branch runs fp_add32's kernel; the
# other ICI modes' no-mesh branch is a library sum, no kernel of this file)
GRAPH_SITES = {"fp_add32": ("gfp_kernel", MODE_IDS["fp_add32"]),
               "mxu_fma128": ("gmxu_kernel", MODE_IDS["mxu_fma128"]),
               "vmem_ld": ("gvmem_kernel", MODE_IDS["vmem_ld"]),
               "hbm_stream": ("gstream_kernel", MODE_IDS["hbm_stream"]),
               "hbm_latency": ("gchase_kernel", MODE_IDS["hbm_latency"]),
               "ici_allreduce": ("gfp_kernel", MODE_IDS["fp_add32"])}
MXU_DIM = 128            # the card's mxu kernel: 128 x 128 bf16
MAX_VMEM_ROWS = 448      # vmem_ld's buffer staged in shared memory

_WS_FLOATS = ns.NOISE_SHAPE[0] * ns.NOISE_SHAPE[1]


def _launch(entry, mode, dev, tensors, ints, k, static, n_blocks=0):
    """Launch ``repro_<entry>_{static,rt}``. With ``n_blocks`` the kernel
    may sum its blocks through a ticket: their sums and its ticket counter
    are the stream's workspace, passed after ``tensors`` with ``res`` (2
    floats, the aux in [1]); returns res."""
    stream = _build.stream_handle(dev.index)
    res = None
    if n_blocks:
        ws = ns.workspace(-(-2 * n_blocks // _WS_FLOATS), dev, stream)
        res = torch.empty(2, dtype=torch.float32, device=dev)
        tensors = (*tensors, ws.partials.view(-1), ws.counters, res)
    _build.launch("graph_noise", entry, tensors, ints, mode_id=MODE_IDS[mode],
                  k=k, static=static, stream=stream)
    return res


def _blocks(n: int) -> int:
    return max(1, -(-n // ref.THREADS))


def fp_cluster(E: int) -> bool:
    """Does gfp_kernel launch its blocks as one cluster and add their sums
    in rank 0 (``ref.CLUSTER_MAX`` blocks at most: every E of the default
    noise scale, and the ici modes' E = 128)? A larger grid sums them
    through the ticket of ``reduce_blocks``."""
    return _blocks(E) <= ref.CLUSTER_MAX


# ---------------------------------------------------------------------------
# fp_add32 (and the ici modes' no-mesh fallback)
# ---------------------------------------------------------------------------

def fp_add32_cuda(c, accs, *, k, static, ici):
    """Launch gfp_kernel: a thread an element, its blocks one cluster where
    ``fp_cluster(E)``."""
    dev = _check((c, *accs), (torch.float32,) * 5)
    E = c.numel()
    if ici:
        E = accs[0].numel()     # c is v; its first E elements are the addend
    elif any(a.numel() != E for a in accs):
        raise ValueError("fp_add32: c and the accumulators differ in shape")
    out = torch.empty((4, *accs[0].shape), dtype=torch.float32, device=dev)
    res = _launch("gfp", "fp_add32", dev, (c, *accs, out),
                  (E, int(ici), int(fp_cluster(E))), k, static, _blocks(E))
    fp_add32_cuda.launches += 1
    aux = res[1]
    return aux, tuple(out[j] for j in range(4))


def fp_add32(c, accs, *, k: int, static: bool, ici: bool = False,
             plain: bool = False):
    """k adds of c round robin into the four accumulators -> (aux, new
    accs); aux 0 at static k = 0. ``ici``: the addend is c[:E] * 1e-3 (c
    being the ici state's v, E the accumulators' size)."""
    k = _k(k, static)
    if not plain and _build.on_card(c):
        return fp_add32_cuda(c, tuple(accs), k=k, static=static, ici=ici)
    if ici:
        c = c.reshape(-1)[:accs[0].numel()].reshape(accs[0].shape)
    return ref.fp_add32_plain(c, tuple(accs), k=k, lit0=static and k == 0,
                              ici=ici)


# ---------------------------------------------------------------------------
# vmem_ld
# ---------------------------------------------------------------------------

def vmem_ld_cuda(buf, accs, *, k, static):
    """Launch gvmem_kernel: four blocks as one cluster, a thread an element
    of the (8,128) accumulators; the rows of buf that the k patterns read
    staged in shared memory by one bulk copy, each thread's offset stepped
    (``ref.vmem_offsets``) and ``ref.VMEM_RING`` of its loads in flight."""
    dev = _check((buf, *accs), (torch.float32,) * 5)
    rows = buf.shape[0]
    if buf.shape[1:] != (128,) or not 8 <= rows <= MAX_VMEM_ROWS:
        raise ValueError(f"vmem_ld: buf must be (8..{MAX_VMEM_ROWS}, 128); "
                         f"got {tuple(buf.shape)}")
    if any(tuple(a.shape) != (8, 128) for a in accs):
        raise ValueError("vmem_ld: the accumulators must be (8, 128)")
    out = torch.empty((4, 8, 128), dtype=torch.float32, device=dev)
    res = torch.empty(2, dtype=torch.float32, device=dev)
    _launch("gvmem", "vmem_ld", dev, (buf, *accs, out, res), (rows,), k,
            static)
    vmem_ld_cuda.launches += 1
    return res[1], tuple(out[j] for j in range(4))


def vmem_ld(buf, accs, *, k: int, static: bool, plain: bool = False):
    """k re-reads of (8,128) slices of buf round robin into the four
    accumulators -> (aux, new accs); aux 0 at static k = 0."""
    k = _k(k, static)
    if not plain and _build.on_card(buf):
        return vmem_ld_cuda(buf, tuple(accs), k=k, static=static)
    return ref.vmem_ld_plain(buf, tuple(accs), k=k, lit0=static and k == 0)


# ---------------------------------------------------------------------------
# hbm_stream
# ---------------------------------------------------------------------------

def hbm_stream_cuda(buf, acc, *, k, tile_rows, static):
    """Launch gstream_kernel: a thread an element of the tile. Bound by
    device-memory bandwidth (tile_rows x 512 bytes a pattern from a buffer
    beyond the L2), which wants ~2 MB in flight: each thread keeps a ring
    of ``ref.STREAM_RING`` loads in flight, the load of pattern j + R issued
    where pattern j is added, its tile index stepped, not taken modulo."""
    dev = _check((buf, acc), (torch.float32,) * 2)
    if tuple(acc.shape) != (tile_rows, 128) or buf.shape[0] < tile_rows:
        raise ValueError("hbm_stream: acc must be (tile_rows, 128) and buf "
                         "at least one tile")
    E = acc.numel()
    n_tiles = max(buf.shape[0] // tile_rows, 1)
    out = torch.empty_like(acc)
    res = _launch("gstream", "hbm_stream", dev, (buf, acc, out),
                  (E, n_tiles), k, static, _blocks(E))
    hbm_stream_cuda.launches += 1
    return res[1], out


def hbm_stream(buf, acc, *, k: int, tile_rows: int, static: bool,
               plain: bool = False):
    """k tile reads of buf at (j*197) % n_tiles added into acc -> (aux =
    sum(acc), new acc)."""
    k = _k(k, static)
    if not plain and _build.on_card(buf):
        return hbm_stream_cuda(buf, acc, k=k, tile_rows=tile_rows,
                               static=static)
    return ref.hbm_stream_plain(buf, acc, k=k, tile_rows=tile_rows)


# ---------------------------------------------------------------------------
# mxu_fma128
# ---------------------------------------------------------------------------

def mxu_fma128_cuda(m, c, *, k, static):
    """Launch gmxu_kernel: one block on one SM. Bound by that SM's bf16
    tensor-core rate (1,024 clocks a 128^3 pattern): each pattern needs the
    last, but the rows are independent chains, so each of two warpgroups
    keeps 64 rows of m in registers and runs its pattern as 8 wgmma with
    A from those registers and c, staged once, from shared memory; the
    rounded product is the next pattern's A as it lies."""
    dev = _check((m, c), (torch.bfloat16,) * 2)
    if tuple(m.shape) != (MXU_DIM, MXU_DIM) or m.shape != c.shape:
        raise ValueError(f"mxu_fma128 on the card takes {MXU_DIM}x{MXU_DIM} "
                         f"bf16 operands; got {tuple(m.shape)}")
    out = torch.empty_like(m)
    res = torch.empty(2, dtype=torch.float32, device=dev)
    _launch("gmxu", "mxu_fma128", dev, (m, c, out, res), (), k, static)
    mxu_fma128_cuda.launches += 1
    return res[1], out


def mxu_fma128(m, c, *, k: int, static: bool, plain: bool = False):
    """k chained products m = bf16(m @ c) -> (aux = sum(m) in f32, new m)."""
    k = _k(k, static)
    if not plain and _build.on_card(m):
        return mxu_fma128_cuda(m, c, k=k, static=static)
    return ref.mxu_fma128_plain(m, c, k=k)


# ---------------------------------------------------------------------------
# hbm_latency
# ---------------------------------------------------------------------------

def hbm_latency_cuda(table, idx, acc, *, k, static):
    """Launch gchase_kernel: one thread walks the chain."""
    dev = _check((table, idx, acc), (torch.int32,) * 3)
    idx_out = torch.empty((), dtype=torch.int32, device=dev)
    acc_out = torch.empty((), dtype=torch.int32, device=dev)
    _launch("gchase", "hbm_latency", dev,
            (table, idx, acc, idx_out, acc_out), (), k, static)
    hbm_latency_cuda.launches += 1
    return acc_out, idx_out, acc_out


def hbm_latency(table, idx, acc, *, k: int, static: bool,
                plain: bool = False):
    """k dependent hops idx = table[idx], acc += idx (int32) ->
    (aux = acc, idx, acc)."""
    k = _k(k, static)
    if not plain and _build.on_card(table):
        return hbm_latency_cuda(table, idx, acc, k=k, static=static)
    return ref.hbm_latency_plain(table, idx, acc, k=k)


for _fn in (fp_add32_cuda, vmem_ld_cuda, hbm_stream_cuda, mxu_fma128_cuda,
            hbm_latency_cuda):
    _fn.launches = 0

# kernel name -> (CUDA launcher, plain version): the counters chip_smoke.py
# reads
GRAPH_KERNELS = {
    "graph_fp_add32": (fp_add32_cuda, ref.fp_add32_plain),
    "graph_mxu_fma128": (mxu_fma128_cuda, ref.mxu_fma128_plain),
    "graph_vmem_ld": (vmem_ld_cuda, ref.vmem_ld_plain),
    "graph_hbm_stream": (hbm_stream_cuda, ref.hbm_stream_plain),
    "graph_hbm_latency": (hbm_latency_cuda, ref.hbm_latency_plain),
}
