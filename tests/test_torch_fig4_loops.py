"""Fig. 4's -O3 loop matmul (``mm_o3_kernel``, ``csrc/loop_regions.cu``)
on the CPU, through its plain version and a model of the kernel's
schedule, against the reference (``repro.bench.kernels.matmul_region``):

* the block, trip, ring, row and stage constants of ``ref.py`` are the
  kernel's;
* the kernel's schedule (trips of ``MM_O3_UNROLL`` iterations, a ring of
  ``MM_O3_RING`` b loads in flight, a's stage read ``MM_O3_AHEAD``
  iterations ahead, the wrap checked once a trip, one iteration at a time
  across it) adds a[:8, i % n] * b[i % n][j] at every
  iteration i in order, each b row loaded ``MM_O3_RING`` iterations before
  the add that takes it, and emits the noise once an iteration in order;
* ``matmul_o3_plain`` at the kernel's block gives each thread's value
  bitwise as the reference's loop order gives it, and its scalar within
  the ``REGIONS`` tolerance of the reference's;
* the region's |body| is derived per iteration from a SASS text whose
  innermost loop holds a trip;
* the wrapper refuses an n its shared stage cannot take, on either device.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench import kernels as ref_bench
from repro_torch.bench.kernels import matmul_region
from repro_torch.kernels.loop_regions import kernel as lk
from repro_torch.kernels.loop_regions import ref as lref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "src", "repro_torch", "csrc", "loop_regions.cu")


def _cu_define(name: str) -> int:
    """A ``#define`` of ``csrc/loop_regions.cu``."""
    with open(CU) as f:
        return int(re.search(rf"^#define {name} (\d+)", f.read(),
                             re.M).group(1))


def test_mm_o3_constants_are_the_kernels():
    """The plain version's block and rows, the schedule model's trip and
    ring and the wrapper's stage limit are mm_o3_kernel's."""
    for name in ("MM_O3_THREADS", "MM_O3_UNROLL", "MM_O3_RING",
                 "MM_O3_AHEAD", "MM_O3_MAX_N"):
        assert _cu_define(name) == getattr(lref, name), name
    assert _cu_define("MM_O3_ROWS") == lref.ROWS_O3
    assert _cu_define("LOOP_THREADS") == lref.THREADS
    # whole warps, a block's threads a power of two (its tree sum), the
    # stage ((n + MM_O3_AHEAD) x 32 bytes) and the block sums inside 48 KiB
    # of shared memory; the stage reads ahead no further than the smallest
    # n's columns (their copies past n)
    assert lref.MM_O3_THREADS % 32 == 0
    assert lref.MM_O3_THREADS & (lref.MM_O3_THREADS - 1) == 0
    assert (lref.MM_O3_MAX_N + lref.MM_O3_AHEAD) * 32 \
        + 4 * lref.MM_O3_THREADS <= 48 * 1024
    assert 1 <= lref.MM_O3_AHEAD <= lref.ROWS_O3
    assert 4 <= lref.MM_O3_UNROLL <= 16 and lref.MM_O3_RING >= 1


def _o3_schedule(n: int, n_iter: int, unroll: int = lref.MM_O3_UNROLL,
                 ring: int = lref.MM_O3_RING,
                 ahead: int = lref.MM_O3_AHEAD) -> dict:
    """mm_o3_loop as one thread runs it: the b ring filled with rows 0 ..
    ring-1 (mod n) and the a ring with stage columns 0 .. ahead-1, then
    trips of ``unroll`` iterations while i + unroll <= n_iter and neither
    c = i % n nor l, the row the next b load fetches, wraps inside the trip
    (checked once a trip), else one iteration. Each iteration adds the a
    ring's oldest column with the b ring's oldest value, loads row l into
    the b ring and reads stage column c + ahead into the a ring (the
    stage's column x >= n is column x - n's copy). Returns the b loads in
    issue order as (row, iteration issuing it; -1 before the loop), each
    add as (a column, row of the b value it takes), the emits, and the
    trips and single iterations run."""
    st = {"loads": [], "adds": [], "emits": [], "trips": 0, "singles": 0}
    r = []
    l = 0
    for _ in range(ring):
        st["loads"].append((l, -1))
        r.append(l)
        l = 0 if l + 1 == n else l + 1
    cols = list(range(ahead))

    def body(i, c, row):
        st["adds"].append((cols.pop(0), r.pop(0)))
        st["loads"].append((row, i))
        r.append(row)
        x = c + ahead
        assert x < n + ahead            # inside the stage
        cols.append(x if x < n else x - n)
        st["emits"].append(i)

    c = i = 0
    while i < n_iter:
        while i + unroll <= n_iter and c + unroll <= n and l + unroll <= n:
            for u in range(unroll):
                body(i + u, c + u, l + u)
            c += unroll
            c = 0 if c == n else c
            l += unroll
            l = 0 if l == n else l
            i += unroll
            st["trips"] += 1
        if i < n_iter:
            body(i, c, l)
            c = 0 if c + 1 == n else c + 1
            l = 0 if l + 1 == n else l + 1
            i += 1
            st["singles"] += 1
    return st


@pytest.mark.parametrize("n,n_iter", (
    (192, 16 * 192),            # the main path: every iteration in a trip
    (384, 16 * 384),            # --full's n
    (192, 8 * 192 + 5),         # n_iter no multiple of the trip
    (8, 128),                   # the smallest n: a wrap every trip
    (33, 531),                  # wraps inside trips
    (13, 5),                    # fewer iterations than the ring
    (9, 1000),                  # n just past the trip
    (1024, 100),                # the largest stage
    (8, 1),
    (8, 0)))
def test_o3_schedule_is_the_references(n, n_iter):
    """Every iteration i adds a's column i % n (read from the stage
    MM_O3_AHEAD iterations before) with b's row i % n, in order, once; the
    row it adds was loaded MM_O3_RING iterations before
    (the ring's first entries before the loop); every load reads a row of
    b; the noise is emitted once an iteration in order. Where n is a
    multiple of the trip, every whole trip runs unrolled."""
    st = _o3_schedule(n, n_iter)
    ring = lref.MM_O3_RING
    assert st["adds"] == [(i % n, i % n) for i in range(n_iter)]
    assert st["emits"] == list(range(n_iter))
    assert len(st["loads"]) == n_iter + ring
    assert all(0 <= row < n for row, _ in st["loads"])
    assert [at for _, at in st["loads"][:n_iter]] == [
        j - ring if j >= ring else -1 for j in range(n_iter)]
    assert st["trips"] * lref.MM_O3_UNROLL + st["singles"] == n_iter
    if n % lref.MM_O3_UNROLL == 0 and ring % lref.MM_O3_UNROLL == 0:
        assert st["trips"] == n_iter // lref.MM_O3_UNROLL
        assert st["singles"] == n_iter % lref.MM_O3_UNROLL


def _inputs(n: int):
    rs = np.random.RandomState(n)
    return tuple(rs.standard_normal((n, n)).astype(np.float32)
                 for _ in range(2))


def _threads_np(a: np.ndarray, b: np.ndarray, n_iter: int) -> np.ndarray:
    """Each thread's value in the reference loop's order: acc[r] +=
    a[r][i % n] * b[i % n], one f32 rounding an operation, rows summed
    0..7."""
    n = a.shape[0]
    acc = np.zeros((lref.ROWS_O3, n), dtype=np.float32)
    for i in range(n_iter):
        kk = i % n
        acc = acc + a[:lref.ROWS_O3, kk:kk + 1] * b[kk][None, :]
    out = acc[0]
    for r in range(1, lref.ROWS_O3):
        out = out + acc[r]
    return out


@pytest.mark.parametrize("n", (8, 13, 33, 192))
def test_matmul_o3_plain_threads_and_scalar(n):
    """At every n_iter in {1, 7, 8 n + 5} each thread's value is the
    reference order's bitwise, and the scalar is those values summed in
    blocks of MM_O3_THREADS (reduce_threads); at the reference's 16 n
    iterations the scalar is within the REGIONS tolerance (rtol 1e-5) of
    ``repro.bench.kernels.matmul_region(n, optimized=True)`` on the same
    inputs."""
    a_np, b_np = _inputs(n)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    for n_iter in (1, 7, 8 * n + 5):
        want = torch.from_numpy(_threads_np(a_np, b_np, n_iter))
        got = lref.matmul_o3_threads(a, b, n_iter)
        assert torch.equal(got, want), n_iter
        out, aux = lref.matmul_o3_plain(a, b, n_iter=n_iter)
        assert torch.equal(out, lref.reduce_threads(want,
                                                    lref.MM_O3_THREADS))
        assert float(aux) == 0.0
    ref = ref_bench.matmul_region(n=n, optimized=True)
    want = ref.build("", 0)(jnp.asarray(a_np), jnp.asarray(b_np))
    got = lk.matmul_o3(a, b, n_iter=16 * n)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_matmul_o3_body_is_per_iteration(monkeypatch):
    """matmul_O3's |body| is derived from the clean SASS's innermost loop,
    which holds a trip of MM_O3_UNROLL iterations: divided by it, one
    iteration's (the payload census's body_ops too); the region keeps the
    reference's stated 17."""
    from repro_torch.core import payload as pm
    from repro_torch.core.controller import census_payload, derive_body_size
    from repro_torch.kernels import _build

    U = lref.MM_O3_UNROLL
    iteration = ["LDS.128 R20, [R3+0x20]", "LDS.128 R24, [R3+0x30]"] \
        + [f"FMUL R{28 + r}, R{20 + r}, R9" for r in range(8)] \
        + [f"FADD R{36 + r}, R{36 + r}, R{28 + r}" for r in range(8)] \
        + ["IMAD.WIDE R12, R5, 0x4, R10",
           "LDG.E.CONSTANT R9, desc[UR4][R12.64]"]
    body = ["S2R R0, SR_TID.X", ".L_x_0:", "ISETP.GE.AND P0, PT, R0, R5, PT",
            ".L_x_1:", *(iteration * U), "IADD3 R4, R4, 0x8, RZ",
            "IADD3 R6, R6, 0x8, RZ", "ISETP.GT.AND P1, PT, R4, R7, PT",
            "@!P1 BRA `(.L_x_1)", *iteration, "IADD3 R4, R4, 0x1, RZ",
            "@!P0 BRA `(.L_x_0)", "EXIT", ".L_x_2:", "BRA `(.L_x_2)"]
    text = "\n".join(["\t\tFunction : _Z12mm_o3_kernelILi0ELi0EEvPKfS1_ii",
                      *(f"        /*{16 * a:04x}*/   {ins} ;"
                        if not ins.endswith(":") else ins
                        for a, ins in enumerate(body))]) + "\n"
    monkeypatch.setattr(_build, "site_sass", lambda site: text)
    on_cpu = matmul_region(n=16, optimized=True, device="cpu")
    assert on_cpu.sass is None and derive_body_size(on_cpu) == 0
    on_card = _card_region(monkeypatch)
    assert on_card.body_size == 2 * lref.ROWS_O3 + 1
    site = on_card.sass("", 0)
    assert site.unroll == U and site.kernels == (("mm_o3_kernel", ""),)
    trip = len(iteration) * U + 3          # the trip's IADD3 x2 and ISETP
    assert pm.body_size(text) == trip
    assert derive_body_size(on_card) == (trip + U // 2) // U \
        == len(iteration)
    monkeypatch.setattr(_build, "site_sass",
                        lambda site: text.replace("ILi0ELi0E", "ILi1ELi4E")
                        if site.k else text)
    assert census_payload(on_card, "fp_add", 4, expected=4).body_ops \
        == len(iteration)


def _card_region(monkeypatch):
    """matmul_O3 at n = 16 as the card builds it (its SASS site), on CPU
    tensors: ``resolve_device`` is told the card is there."""
    from repro_torch.bench import kernels as bk

    monkeypatch.setattr(bk, "resolve_device", lambda d: torch.device(
        "cuda") if str(d).startswith("cuda") else torch.device(d))
    monkeypatch.setattr(bk, "to_torch", lambda arrays, dev: tuple(
        torch.from_numpy(a) for a in arrays))
    return bk.matmul_region(n=16, optimized=True, device="cuda")


@pytest.mark.parametrize("n", (lref.ROWS_O3 - 1, lref.MM_O3_MAX_N + 1))
def test_matmul_o3_refuses_n_its_stage_cannot_take(n):
    """n below the 8 rows or past MM_O3_MAX_N (a[:8, :n] in the kernel's
    shared stage) is refused with the limit named: by the wrapper on either
    device, and by the card's launcher before it launches; at the limit the
    wrapper computes."""
    a = torch.zeros((n, n), dtype=torch.float32)
    with pytest.raises(ValueError, match="MM_O3_MAX_N"):
        lk.matmul_o3(a, a, n_iter=1)
    with pytest.raises(ValueError, match="MM_O3_MAX_N"):
        lk.matmul_o3_cuda(a, a, n_iter=1, mode="none", k=0, carry=None,
                          static=False)
    top = torch.zeros((lref.MM_O3_MAX_N,) * 2, dtype=torch.float32)
    assert float(lk.matmul_o3(top, top, n_iter=2)[0]) == 0.0
