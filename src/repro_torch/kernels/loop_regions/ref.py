"""Plain PyTorch versions of the loop-region kernels (``csrc/loop_regions.cu``).

Each ``*_plain`` function computes what its kernel computes, in the
kernel's grouping and order, so that on the card the kernel's aux and its
scalar outputs can be held against it bit for bit:

* the region's own arithmetic, one rounding per operation (the kernels use
  ``__fadd_rn`` / ``__fmul_rn``, no contraction);
* one noise carry per thread group: a warp per iteration, walked
  grid-stride by ``n_warps(n_iter)`` warps (STREAM, SPMXV), or one group
  for regions whose every thread runs every iteration (lat_mem_rd, HACCmk,
  the matmuls). Every thread holds lane ``thread % 8`` of its group's carry
  and contributes ((a0 + a1) + a2) + a3 (chase: its index as a float);
* the thread values summed as the kernels sum them: a tree over each block
  of 256 threads (32 for lat_mem_rd), then ``final_reduce`` over the block
  sums, as the last block to finish does in the kernel's epilogue.

Against the reference (``repro.bench.kernels``) the outputs differ only by
the order of f32 additions where the reference reduces (SPMXV rows,
HACCmk's and the matmuls' final sums), and not at all for STREAM and
lat_mem_rd.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.loopnoise import VEC, make_loop_modes

THREADS = 256              # a block of the region kernels
WARPS_PER_BLOCK = THREADS // 32
# warps that walk the iterations of STREAM and SPMXV: 32 an SM of the H100's
# 132, a constant so that the grouping (and the aux) is the same everywhere
N_WARPS_MAX = 132 * 32
UNROLL_O0 = 8              # matmul_O0's k-steps an iteration
ROWS_O3 = 8                # matmul_O3's register-blocked output rows
HACC_CHAINS = 6

_MODES = make_loop_modes()


def n_warps(n_iter: int) -> int:
    """Warps that walk ``n_iter`` independent iterations."""
    return max(1, min(n_iter, N_WARPS_MAX))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# the kernels' summation order
# ---------------------------------------------------------------------------

def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum the last dimension (a power of two) as ``block_tree_sum`` does:
    v[t] += v[t + s] for s = n/2, n/4, ..., 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def final_reduce(parts: torch.Tensor, block: int) -> torch.Tensor:
    """The block sums ``parts`` summed by the last of the kernel's blocks
    (``reduce_blocks``, ``block`` threads): thread t adds parts t,
    t+block, ... in order, then a tree over the ``block`` sums."""
    n = parts.shape[0]
    m = -(-n // block)
    padded = torch.zeros(m * block, dtype=torch.float32, device=parts.device)
    padded[:n] = parts
    rows = padded.reshape(m, block)
    s = torch.zeros(block, dtype=torch.float32, device=parts.device)
    for r in range(m):
        s = s + rows[r]
    return tree_sum(s)


def reduce_threads(values: torch.Tensor, block: int = THREADS) -> torch.Tensor:
    """The scalar a region kernel makes of one value a thread: threads in
    order, padded with 0.0 (idle threads) to whole blocks of ``block``."""
    n = values.shape[0]
    blocks = max(1, -(-n // block))
    padded = torch.zeros(blocks * block, dtype=torch.float32,
                         device=values.device)
    padded[:n] = values
    return final_reduce(tree_sum(padded.reshape(blocks, block)), block)


# ---------------------------------------------------------------------------
# noise carries per thread group
# ---------------------------------------------------------------------------

def _grouped(carry: dict, groups: int) -> dict:
    """The carry with one copy of its changing leaves per group."""
    out = dict(carry)
    if "accs" in carry:
        out["accs"] = tuple(a.expand(groups, VEC).clone() for a in carry["accs"])
    if "idx" in carry:
        out["idx"] = carry["idx"].reshape(1).expand(groups).clone()
    return out


def _select(active: torch.Tensor, new: dict, old: dict) -> dict:
    out = dict(new)
    if "accs" in new:
        out["accs"] = tuple(torch.where(active[:, None], a, b)
                            for a, b in zip(new["accs"], old["accs"]))
    if "idx" in new:
        out["idx"] = torch.where(active, new["idx"], old["idx"])
    return out


def lane_values(mode: str, carry: dict) -> torch.Tensor:
    """(groups, 8): what the thread holding each lane contributes."""
    if mode == "chase":
        return carry["idx"].to(torch.float32)[:, None].expand(-1, VEC)
    a0, a1, a2, a3 = carry["accs"]
    return ((a0 + a1) + a2) + a3


def run_noise(mode: str, carry: dict, k: int, groups: int,
              schedule) -> torch.Tensor:
    """Emit k patterns per iteration for ``groups`` carries;
    ``schedule`` yields (i, active): the iteration index of every group
    (an int64 tensor, or an int that all groups share) and which groups
    run it (None: all). Returns ``lane_values`` of the final carries."""
    noise = _MODES[mode]
    cur = _grouped(carry, groups)
    for i, active in schedule:
        new = noise.emit(cur, k, i)
        cur = new if active is None else _select(active, new, cur)
    return lane_values(mode, cur)


def _strided_schedule(n_iter: int, warps: int, device):
    base = torch.arange(warps, dtype=torch.int64, device=device)
    for r in range(-(-n_iter // warps)):
        i = base + r * warps
        yield i, (None if (r + 1) * warps <= n_iter else i < n_iter)


def _serial_schedule(n_iter: int):
    # a plain int: the patterns' offsets are host arithmetic and their rows
    # views, not a device tensor and kernels an iteration
    for i in range(n_iter):
        yield i, None


def _warp_aux(mode, carry, k, n_iter, device, warps=None) -> torch.Tensor:
    """aux of a region whose warps (default ``n_warps(n_iter)``) walk the
    iterations grid-stride."""
    if mode == "none":
        return torch.zeros((), dtype=torch.float32, device=device)
    w = n_warps(n_iter) if warps is None else warps
    lanes = run_noise(mode, carry, k, w, _strided_schedule(n_iter, w, device))
    per_thread = lanes[:, torch.arange(32, device=device) % VEC].reshape(-1)
    return reduce_threads(per_thread)


def _uniform_aux(mode, carry, k, n_iter, n_threads, device,
                 block: int = THREADS) -> torch.Tensor:
    """aux of a region whose ``n_threads`` threads all run every
    iteration (one carry, lane = thread % 8)."""
    if mode == "none":
        return torch.zeros((), dtype=torch.float32, device=device)
    lanes = run_noise(mode, carry, k, 1, _serial_schedule(n_iter))[0]
    per_thread = lanes[torch.arange(n_threads, device=device) % VEC]
    return reduce_threads(per_thread, block)


# ---------------------------------------------------------------------------
# the regions
# ---------------------------------------------------------------------------

def stream_triad_plain(a, b, c, *, chunk: int, mode: str = "none",
                       k: int = 0, carry: Optional[dict] = None):
    """c[:n_iter*chunk] = a + 3 b (the rest of c as given); aux."""
    stream_triad_plain.launches += 1
    n_iter = a.shape[0] // chunk
    m = n_iter * chunk
    out = c.clone()
    out[:m] = a[:m] + b[:m] * _f32(3.0, b)
    return out, _warp_aux(mode, carry, k, n_iter, a.device)


def lat_mem_rd_plain(table, idx0, *, n_iter: int, hops: int,
                     mode: str = "none", k: int = 0,
                     carry: Optional[dict] = None):
    """The chain's index after n_iter * hops hops, as a float; aux."""
    lat_mem_rd_plain.launches += 1
    idx = idx0.reshape(()).long()
    for _ in range(n_iter * hops):
        idx = table[idx].long()
    first = torch.zeros(32, dtype=torch.float32, device=table.device)
    first[0] = idx.to(torch.float32)
    out = reduce_threads(first, 32)
    return out, _uniform_aux(mode, carry, k, n_iter, 32, table.device, 32)


def haccmk_plain(x, *, n_iter: int, mode: str = "none", k: int = 0,
                 carry: Optional[dict] = None):
    """Sum over lanes and chains of the HACC polynomial chains; aux."""
    haccmk_plain.launches += 1
    c0125, c025, c05, c1em6 = (_f32(v, x) for v in (0.125, 0.25, 0.5, 1e-6))
    acc = torch.stack([x + _f32(float(j), x) for j in range(HACC_CHAINS)])
    for _ in range(n_iter):
        r2 = acc * acc
        f = c025 + r2 * c0125
        f = c05 + r2 * f
        f = acc * f
        acc = acc + f * c1em6
    per_thread = acc[0]
    for j in range(1, HACC_CHAINS):
        per_thread = per_thread + acc[j]
    out = reduce_threads(per_thread)
    return out, _uniform_aux(mode, carry, k, n_iter, x.shape[0], x.device)


def spmxv_plain(vals, cols, x, y, *, rows_per_iter: int, mode: str = "none",
                k: int = 0, carry: Optional[dict] = None):
    """y[:n_iter*rows_per_iter] = A x row by row, terms added in column
    order (the rest of y as given); aux."""
    spmxv_plain.launches += 1
    n_iter = vals.shape[0] // rows_per_iter
    m = n_iter * rows_per_iter
    g = x[cols[:m].long()]
    s = torch.zeros(m, dtype=torch.float32, device=x.device)
    for l in range(vals.shape[1]):
        s = s + vals[:m, l] * g[:, l]
    out = y.clone()
    out[:m] = s
    return out, _warp_aux(mode, carry, k, n_iter, x.device)


def matmul_o0_plain(a, b, out0, *, n_iter: int, mode: str = "none",
                    k: int = 0, carry: Optional[dict] = None):
    """Sum of the one output row after n_iter iterations of 8 rank-1
    steps; aux."""
    matmul_o0_plain.launches += 1
    n = a.shape[0]
    o = out0.reshape(-1).clone()
    for i in range(n_iter):
        kk = (i * UNROLL_O0) % n
        for u in range(UNROLL_O0):
            ku = min(kk + u, n - 1)
            o = o + a[0, ku] * b[ku]
    return reduce_threads(o), _uniform_aux(mode, carry, k, n_iter, n, a.device)


def matmul_o3_plain(a, b, *, n_iter: int, mode: str = "none", k: int = 0,
                    carry: Optional[dict] = None):
    """Sum of the eight register-blocked output rows after n_iter rank-1
    steps; aux."""
    matmul_o3_plain.launches += 1
    n = a.shape[0]
    acc = torch.zeros((ROWS_O3, n), dtype=torch.float32, device=a.device)
    for i in range(n_iter):
        kk = i % n
        acc = acc + a[:ROWS_O3, kk:kk + 1] * b[kk][None, :]
    per_thread = acc[0]
    for r in range(1, ROWS_O3):
        per_thread = per_thread + acc[r]
    return (reduce_threads(per_thread),
            _uniform_aux(mode, carry, k, n_iter, n, a.device))


for _fn in (stream_triad_plain, lat_mem_rd_plain, haccmk_plain, spmxv_plain,
            matmul_o0_plain, matmul_o3_plain):
    _fn.launches = 0
