"""Plain PyTorch versions of the graph-level noise kernels
(``csrc/graph_noise.cu``).

Each computes what its kernel computes, in the kernel's order, so that on
the card the new state and the aux can be held against it bit for bit:

* the state: pattern j of k into chain j % 4 (fp_add32, vmem_ld), one
  rounding per add, the reference's arithmetic (``repro.core.noise``);
* the f32 aux: one value a thread (a thread an element: the chains' sum
  ((a0 + a1) + a2) + a3, or the element), summed as the kernel's epilogue
  sums them (``loop_regions.ref.reduce_threads``: a tree over each block of
  256 threads, then the block sums in order); the one-block kernel (mxu)
  has thread t add elements t, t + 256, ... in order, then the tree.

Against the reference the states are bitwise equal; the aux differs only
by the order of f32 additions (the reference's ``jnp.sum``).
"""
from __future__ import annotations

import torch

from repro_torch.core.loopnoise import _wrap32
from repro_torch.kernels.loop_regions.ref import reduce_threads, tree_sum

THREADS = 256        # a block of the graph-noise kernels
N_CHAINS = 4
ICI_SCALE = 1e-3     # the ici modes' no-mesh fallback: c = v[:128] * 1e-3


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def chains_aux(accs) -> torch.Tensor:
    """The kernels' aux of four chains: per element ((a0 + a1) + a2) + a3,
    then the blocks' trees and the block sums."""
    a0, a1, a2, a3 = accs
    return reduce_threads((((a0 + a1) + a2) + a3).reshape(-1), THREADS)


def one_block_sum(v: torch.Tensor) -> torch.Tensor:
    """sum(v) as one block of 256 threads sums it: thread t adds v[t],
    v[t + 256], ... in order, then the block tree."""
    v = v.reshape(-1).to(torch.float32)
    rows = max(1, -(-v.shape[0] // THREADS))
    padded = torch.zeros(rows * THREADS, dtype=torch.float32, device=v.device)
    padded[:v.shape[0]] = v
    s = torch.zeros(THREADS, dtype=torch.float32, device=v.device)
    for r in padded.reshape(rows, THREADS):
        s = s + r
    return tree_sum(s)


def fp_add32_plain(c, accs, *, k: int, lit0: bool = False,
                   ici: bool = False):
    """k adds of c round robin into the four accumulators -> (aux, new
    accs). ``lit0``: the aux is 0 (the static k = 0 build); ``ici``: c is
    scaled by 1e-3 first (the ici modes' no-mesh fallback)."""
    fp_add32_plain.launches += 1
    ce = c * _f32(ICI_SCALE, c) if ici else c
    new = [a.clone() for a in accs]
    for j in range(k):
        new[j % N_CHAINS] = new[j % N_CHAINS] + ce
    aux = (torch.zeros((), dtype=torch.float32, device=c.device) if lit0
           else chains_aux(new))
    return aux, tuple(new)


def vmem_ld_plain(buf, accs, *, k: int, lit0: bool = False):
    """k re-reads of (8,128) slices of buf at (j*13) % max(rows-8, 1), round
    robin into the four accumulators -> (aux, new accs)."""
    vmem_ld_plain.launches += 1
    m = max(buf.shape[0] - 8, 1)
    new = [a.clone() for a in accs]
    for j in range(k):
        off = (j * 13) % m
        new[j % N_CHAINS] = new[j % N_CHAINS] + buf[off:off + 8]
    aux = (torch.zeros((), dtype=torch.float32, device=buf.device) if lit0
           else chains_aux(new))
    return aux, tuple(new)


def hbm_stream_plain(buf, acc, *, k: int, tile_rows: int):
    """k tile reads at (j*197) % n_tiles added into acc -> (aux, new acc)."""
    hbm_stream_plain.launches += 1
    n_tiles = max(buf.shape[0] // tile_rows, 1)
    for j in range(k):
        t = (j * 197) % n_tiles
        acc = acc + buf[t * tile_rows:(t + 1) * tile_rows]
    return reduce_threads(acc.reshape(-1), THREADS), acc.clone()


def mxu_fma128_plain(m, c, *, k: int):
    """k chained products m = bf16(m @ c), accumulated in f32 -> (aux, new
    m). With c the identity every product is exact, so the card's
    tensor-core order gives the same bits."""
    mxu_fma128_plain.launches += 1
    cf = c.to(torch.float32)
    for _ in range(k):
        m = (m.to(torch.float32) @ cf).to(torch.bfloat16)
    return one_block_sum(m), m.clone()


def hbm_latency_plain(table, idx, acc, *, k: int):
    """k dependent hops idx = table[idx], acc += idx in int32 ->
    (aux = acc, idx, acc)."""
    hbm_latency_plain.launches += 1
    i = int(idx)
    a = int(acc)
    for _ in range(k):
        i = int(table[i])
        a = _wrap32(a + i)
    dev = table.device
    new_acc = torch.tensor(a, dtype=torch.int32, device=dev)
    return new_acc, torch.tensor(i, dtype=torch.int32, device=dev), new_acc


for _fn in (fp_add32_plain, vmem_ld_plain, hbm_stream_plain,
            mxu_fma128_plain, hbm_latency_plain):
    _fn.launches = 0
