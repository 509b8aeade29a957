"""The port's DECAN baseline (``repro_torch.core.decan``, the DECAN loops of
``kernels/decan_loops`` and the ``table3``/``fig6`` studies) on the CPU,
against the reference:

* ``DecanResult.scenario`` and ``cross_check_with_decan`` give the
  reference's labels and hints on a grid of (Sat_FP, Sat_LS, label);
* ``decan`` records are byte-identical between the two packages' stores
  under ``REPRO_SYNTH_MEASURE`` and replay with 0 measured;
* every Table 3 scenario and Livermore loop, each variant, through its
  plain version at 8 lanes in order (one copy of the reference's loop),
  equals ``benchmarks/table3_decan.py:_kernel`` /
  ``fig6_overlap.py:_livermore`` at a small N and a few hundred iterations
  to rtol 1e-6 (the final sums are taken in another order), with and
  without noise; at wider widths the output is the sum over the copies;
* ``python -m repro_torch.bench table3|fig6 --device cpu --store-dir D``
  exits 0, and again with ``--expect-no-measure`` measures 0, variants
  included; ``fig4 --pallas`` returns the Pallas-kernel study and
  ``--pallas`` on a study without one is a usage error.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.fig6_overlap as ref_fig6
import benchmarks.table3_decan as ref_t3
from repro.core import Campaign as RefCampaign
from repro.core import Controller as RefController
from repro.core import DecanTarget as RefTarget
from repro.core.classifier import BottleneckReport as RefReport
from repro.core.classifier import cross_check_with_decan as ref_cross
from repro.core.decan import DecanResult as RefResult
from repro.core.loopnoise import make_loop_modes as ref_loop_modes
from repro_torch.bench.kernels import livermore_target, table3_target
from repro_torch.convert import carry_to_torch
from repro_torch.core import absorption as port_abs
from repro_torch.core.campaign import Campaign, CampaignStore
from repro_torch.core.classifier import BottleneckReport, cross_check_with_decan
from repro_torch.core.controller import Controller
from repro_torch.core.decan import VARIANTS, DecanResult, run_decan
from repro_torch.kernels.decan_loops import kernel as dk
from repro_torch.kernels.decan_loops import ref as dref
from repro_torch.kernels.loop_regions.ref import reduce_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 13
N_ITER = 256
SATS = (0.1, 0.59, 0.6, 0.79, 0.8, 0.84, 0.85, 1.0, 1.3)


@pytest.fixture(autouse=True)
def _fresh_port_measure_state():
    port_abs.reset_floor_warnings()
    port_abs.reset_synth_state()
    yield
    port_abs.release_synth_hang()


@pytest.mark.parametrize("sat_fp", SATS)
def test_scenario_labels_are_the_references(sat_fp):
    for sat_ls in SATS:
        want = RefResult("r", 1.0, sat_fp, sat_ls)
        got = DecanResult("r", 1.0, sat_fp, sat_ls)
        assert got.scenario() == want.scenario(), (sat_fp, sat_ls)
        assert got.scenario(close=0.9, fast=0.5) \
            == want.scenario(close=0.9, fast=0.5)
        assert (got.sat_fp, got.sat_ls) == (want.sat_fp, want.sat_ls)


@pytest.mark.parametrize("label", ("overlap", "compute", "bandwidth",
                                   "mixed"))
def test_cross_check_is_the_references(label):
    for sat_fp in SATS:
        for sat_ls in SATS:
            want = ref_cross(RefReport(label, 0.7, {"fp_add": 0.0}, "e"),
                             sat_fp, sat_ls)
            got = cross_check_with_decan(
                BottleneckReport(label, 0.7, {"fp_add": 0.0}, "e"),
                sat_fp, sat_ls)
            assert (got.label, got.decan_hint, got.confidence) \
                == (want.label, want.decan_hint, want.confidence)


def _ref_kernel_target(name, traces):
    x = jnp.arange(64, dtype=jnp.float32)

    def build(fp, ls):
        traces["n"] += 1
        return jax.jit(lambda v: jnp.sum(v) * (1.0 if fp else 0.5))

    return RefTarget(name, build, lambda: (x,))


def _port_kernel_target(name, traces):
    from repro_torch.core.decan import DecanTarget

    x = torch.arange(64, dtype=torch.float32)

    def build(fp, ls):
        traces["n"] += 1
        return lambda v: v.sum() * (1.0 if fp else 0.5)

    return DecanTarget(name, build, lambda: (x,))


def test_decan_records_are_the_references_and_replay(tmp_path, monkeypatch):
    """Under the deterministic clock both packages write the same bytes,
    and a second run replays all three variants without building one."""
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    ref_path, port_path = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    RefCampaign(str(ref_path), RefController(reps=2, verify_payload=False)) \
        .run_decan(_ref_kernel_target("t3_x", {"n": 0}))
    camp = Campaign(str(port_path), Controller(reps=2, verify_payload=False))
    first = camp.run_decan(_port_kernel_target("t3_x", {"n": 0}))
    assert camp.stats.measured == 3
    camp.store.close()
    assert port_path.read_bytes() == ref_path.read_bytes()
    traces = {"n": 0}
    again = Campaign(str(port_path), Controller(reps=2, verify_payload=False))
    second = again.run_decan(_port_kernel_target("t3_x", traces))
    assert (again.stats.measured, again.stats.cached, traces["n"]) == (0, 3, 0)
    assert second == first
    # other settings supersede instead of replaying
    other = Campaign(str(port_path), Controller(reps=3, verify_payload=False))
    other.run_decan(_port_kernel_target("t3_x", {"n": 0}))
    assert other.stats.measured == 3
    # the port's store reads the reference's records
    st = CampaignStore(str(ref_path), readonly=True)
    assert sorted(st.decan) == [("t3_x", v) for v in sorted(VARIANTS)]


def test_run_decan_without_a_store_measures_every_variant():
    traces = {"n": 0}
    res = run_decan(_port_kernel_target("t", traces), reps=1)
    assert traces["n"] == 3 and res.t_ref > 0 and res.name == "t"


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _ref_inputs(seed: int = 0):
    """a, b, c standard normal and x0 uniform in [0.1, 0.9), from a seed:
    a load from a wrong address changes the output (the reference's own
    constant buffers would hide it)."""
    rng = np.random.default_rng(seed)
    a, b, c = (rng.standard_normal(N, dtype=np.float32) for _ in range(3))
    x0 = rng.uniform(0.1, 0.9, 8).astype(np.float32)
    return a, b, c, x0


@pytest.fixture
def small_t3(monkeypatch):
    monkeypatch.setattr(ref_t3, "N", N)
    return _ref_inputs()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("scenario", sorted(ref_t3.SCENARIOS))
def test_table3_loop_matches_the_reference(small_t3, scenario, variant):
    kind, depth, _ = ref_t3.SCENARIOS[scenario]
    fp, ls = VARIANTS[variant]
    want = ref_t3._kernel(kind, depth, ls, fp, N_ITER)(*small_t3)
    args = tuple(torch.from_numpy(a.copy()) for a in small_t3)
    got, aux = dk.table3(*args, kind=kind, depth=depth, n_iter=N_ITER,
                         fp=fp, ls=ls, width=8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    assert float(aux) == 0.0


@pytest.mark.parametrize("width", (8, None))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_table3_triad_buffer_is_the_references(small_t3, variant, width):
    """The stream scenarios' triad buffer, whole: c with every iteration's
    chunk (i*512) % (N-512) overwritten by a + 3 b, as the reference's
    loop body writes it (transcribed in numpy); untouched without LS."""
    fp, ls = VARIANTS[variant]
    a, b, c, x0 = small_t3
    n_iter = 3 * N // dref.CHUNK // 2        # the offsets wrap
    want = c.copy()
    if ls:
        for i in range(n_iter):
            off = (i * ref_t3.CHUNK) % (N - ref_t3.CHUNK)
            want[off:off + ref_t3.CHUNK] = a[off:off + ref_t3.CHUNK] \
                + np.float32(3.0) * b[off:off + ref_t3.CHUNK]
    args = tuple(torch.from_numpy(v.copy()) for v in small_t3)
    cout = args[2].clone()
    got, _ = dk.table3(*args, kind="stream", depth=4, n_iter=n_iter, fp=fp,
                       ls=ls, width=width, cout=cout)
    np.testing.assert_array_equal(cout.numpy(), want)
    alone, _ = dk.table3(*args, kind="stream", depth=4, n_iter=n_iter, fp=fp,
                         ls=ls, width=width)
    assert torch.equal(got, alone)
    if width == 8:
        ref_out = ref_t3._kernel("stream", 4, ls, fp, n_iter)(*small_t3)
        np.testing.assert_allclose(_np(got), _np(ref_out), rtol=1e-6)


@pytest.mark.parametrize("mode", ("fp_add", "l1_ld", "mem_ld", "chase"))
@pytest.mark.parametrize("scenario", sorted(ref_t3.SCENARIOS))
def test_table3_noise_leaves_the_output(small_t3, scenario, mode):
    """With noise the reference's and the port's outputs are the noiseless
    ones (the aux differs by construction: the card sums one carry a
    thread)."""
    kind, depth, _ = ref_t3.SCENARIOS[scenario]
    noise = ref_loop_modes()[mode]
    carry = noise.init(jax.random.PRNGKey(0))
    want, _ = ref_t3._kernel(kind, depth, True, True, 64, noise=noise,
                             k=3)(*small_t3, carry)
    args = tuple(torch.from_numpy(a.copy()) for a in small_t3)
    pcarry = carry_to_torch({k: (tuple(np.asarray(x) for x in v)
                                 if isinstance(v, tuple) else np.asarray(v))
                             for k, v in carry.items()})
    got, aux = dk.table3(*args, kind=kind, depth=depth, n_iter=64, width=8,
                         mode=mode, k=3, carry=pcarry)
    rt, rt_aux = dk.table3(*args, kind=kind, depth=depth, n_iter=64, width=8,
                           mode=mode, k=3, carry=pcarry, static=False)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    assert torch.equal(got, rt) and torch.equal(aux, rt_aux)
    assert torch.isfinite(aux) and float(aux) != 0.0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_livermore_matches_the_reference(monkeypatch, variant):
    """300 iterations on 2^12 floats: the offset (i*64) % (2^12 - 64)
    wraps four times."""
    monkeypatch.setattr(ref_fig6, "N", 1 << 12)
    fp, ls = VARIANTS[variant]
    buf = np.random.default_rng(1).standard_normal(1 << 12, dtype=np.float32)
    want = ref_fig6._livermore(fp, ls, 300)(buf)
    got, _ = dk.livermore(torch.from_numpy(buf), n_iter=300, width=8, fp=fp,
                          ls=ls)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


@pytest.mark.parametrize("scenario", ("compute-bound", "limited-overlap"))
def test_wider_widths_sum_the_copies(scenario):
    """token: every copy is the reference's loop, so width 24 gives three
    times width 8's terms; scatter_dep's copies load from their own address
    streams (copy 0 the reference's), so each differs."""
    kind, depth, _ = ref_t3.SCENARIOS[scenario]
    args = tuple(torch.from_numpy(a.copy()) for a in _ref_inputs())
    base = float(dref.first8(args[2]))      # sum(c[:8]) is added once

    def widths(a):
        return tuple(float(dref.table3_plain(a, *args[1:], kind=kind,
                                             depth=depth, n_iter=40,
                                             width=w)[0]) - base
                     for w in (8, 24))

    # a constant buffer: every copy loads the same values
    one, three = widths(torch.ones(N))
    assert three == pytest.approx(3 * one, rel=1e-6)
    one, three = widths(args[0])
    same = three == pytest.approx(3 * one, rel=1e-6)
    assert same == (kind == "token")


def test_stream_warps_walk_the_iterations_grid_stride():
    """Stream scenarios: one reference copy a warp (lanes 0..7 add to the
    output), the warps taking iterations w, w + W, ... At one warp the
    loop is the reference's, whatever the width default says."""
    args = tuple(torch.from_numpy(a.copy()) for a in _ref_inputs())
    n_iter = N // dref.CHUNK
    assert dref.default_width("stream", n_iter) == 8 * n_iter
    one = dref.table3_plain(*args, kind="stream", depth=4, n_iter=n_iter,
                            width=8)[0]
    many = dref.table3_plain(*args, kind="stream", depth=4, n_iter=n_iter)[0]
    a, b = args[:2]
    cb8 = float(dref.first8(a[:8] + b[:8] * 3.0))   # the triad's first 8
    xs = float(one) - cb8
    assert float(many) - cb8 == pytest.approx(n_iter * xs, rel=1e-6)
    with pytest.raises(ValueError, match="explicit width"):
        dref.default_width("token", 10)


def _stepped_offsets(n: int, n_iter: int, groups: int) -> torch.Tensor:
    """(n_iter,) int64: the triad offset of every iteration as t3_kernel
    steps it, warp w taking iterations w, w + groups, ...: it starts at
    (w*512) % m and adds (groups*512) % m a step, taking m off when it
    reaches m (m = n - 512)."""
    m = n - dref.CHUNK
    off = torch.arange(groups, dtype=torch.int64) * dref.CHUNK % m
    step = groups * dref.CHUNK % m
    out = torch.empty(n_iter, dtype=torch.int64)
    for lo in range(0, n_iter, groups):
        hi = min(lo + groups, n_iter)
        out[lo:hi] = off[:hi - lo]
        off = off + step
        off = torch.where(off >= m, off - m, off)
    return out


@pytest.mark.parametrize("n,n_iter,groups", (
    (1 << 25, (1 << 25) // 512, None),      # the main path: 16 rounds
    (1 << 13, 3 * (1 << 13) // 512 // 2, 7),   # the offsets wrap
    (1 << 13, 200, 5),                      # 40 rounds of 5 warps
    (4096 + 512, 450, 100),                 # a step of 100 chunks > m
    (3 * (1 << 20) + 4, 3 * (1 << 20) // 512, 77)))
def test_stepped_triad_offsets_are_the_references(n, n_iter, groups):
    """t3_kernel steps each warp's triad offset (no modulo in the loop):
    past one round of the grid-stride walk, at every iteration it equals
    the reference's (i*512) % (n-512), int32-wrapped then floor modulo."""
    from repro_torch.core.loopnoise import _wrap32

    if groups is None:
        groups = dref.default_width("stream", n_iter) // 8
    assert -(-n_iter // groups) > 1
    i = torch.arange(n_iter, dtype=torch.int64)
    want = _wrap32(i * dref.CHUNK) % (n - dref.CHUNK)
    assert torch.equal(_stepped_offsets(n, n_iter, groups), want)


def _cu_define(name: str) -> int:
    """A ``#define`` of ``csrc/decan_loops.cu``."""
    import re

    path = os.path.join(ROOT, "src", "repro_torch", "csrc", "decan_loops.cu")
    with open(path) as f:
        return int(re.search(rf"^#define {name} (\d+)", f.read(),
                             re.M).group(1))


def test_livermore_constants_are_the_kernels():
    """The plain version's and the schedule model's constants are
    liv_kernel's."""
    for name in ("LIV_CHUNK", "LIV_CHAINS", "LIV_UNROLL", "LIV_RING"):
        assert _cu_define(name) == getattr(dref, name), name
    assert 4 <= dref.LIV_UNROLL <= 8 and dref.LIV_RING >= 1


def _liv_schedule(n: int, n_iter: int, unroll: int = dref.LIV_UNROLL,
                  ring: int = dref.LIV_RING) -> dict:
    """liv_kernel's loop (``liv_loop``) as one thread runs it: the ring of
    ``ring`` loads, trips of ``unroll`` iterations while each of their
    loads exists (i + unroll + ring <= n_iter), a trip taking its loads at
    immediate offsets from lo when lo + (unroll-1)*64 < m (checked once a
    trip; lo then steps once) and stepping each load otherwise, then the
    last iterations one by one. Returns the loads in issue order as
    (iteration loaded, offset, iteration issuing it; -1 before the loop),
    the iteration whose value each accumulator add takes, the iterations
    that emit noise, and the fast and stepped trips."""
    chunk = dref.LIV_CHUNK
    m = n - chunk
    st = {"lo": 0, "loads": [], "adds": [], "emits": [], "fast": 0,
          "stepped": 0}
    ring_vals = [None] * ring

    def stepped(j, at):
        if st["lo"] >= m:
            st["lo"] -= m
        st["loads"].append((j, st["lo"], at))
        st["lo"] += chunk
        return j

    def body(i, load):
        st["adds"].append(ring_vals.pop(0))     # consume, the ring moves on
        ring_vals.append(load(i + ring, i) if load else None)
        st["emits"].append(i)

    for d in range(ring):
        ring_vals[d] = stepped(d, -1) if d < n_iter else None
    last_trip = n_iter - ring - unroll
    i = 0
    while i <= last_trip:
        while i <= last_trip and st["lo"] + (unroll - 1) * chunk < m:
            base = st["lo"]
            for u in range(unroll):
                body(i + u, lambda j, at, u=u: st["loads"].append(
                    (j, base + u * chunk, at)) or j)
            st["lo"] += unroll * chunk
            st["fast"] += 1
            i += unroll
        if i <= last_trip:
            for u in range(unroll):
                body(i + u, stepped)
            st["stepped"] += 1
            i += unroll
    while i < n_iter:
        body(i, stepped if i + ring < n_iter else None)
        i += 1
    return st


@pytest.mark.parametrize("n,n_iter", (
    (1 << 18, 60_000),          # the main path: 14 wraps, each inside a trip
    (1 << 12, 1000),            # m = 63 * 64: the wrap lands inside a trip
    (4096 + 40, 1001),          # m not a multiple of 64, n_iter % U != 0
    (130, 50),                  # m = 66: every trip steps its loads
    (1 << 12, 3),               # n_iter < the ring
    (1 << 12, 1),
    (1 << 12, 0),
    (1 << 18, 5003)))           # n_iter % U != 0 past the first wrap
def test_livermore_schedule_is_the_references(n, n_iter):
    """liv_kernel's redesigned schedule loads every iteration's reference
    offset (i*64) % (n-64), int32-wrapped then floor modulo, exactly once
    and in order, LIV_RING iterations before the one that adds it; the
    accumulator adds each iteration's value once, in the reference's order,
    and the noise is emitted once an iteration in order. Run on seeded
    values, that order gives the plain version's output bit for bit."""
    from repro_torch.core.loopnoise import _wrap32

    st = _liv_schedule(n, n_iter)
    want = _wrap32(torch.arange(n_iter, dtype=torch.int64) * dref.LIV_CHUNK
                   ) % (n - dref.LIV_CHUNK)
    assert [j for j, _, _ in st["loads"]] == list(range(n_iter))
    assert torch.equal(torch.tensor([o for _, o, _ in st["loads"]],
                                    dtype=torch.int64), want)
    assert [at for _, _, at in st["loads"]] == [
        j - dref.LIV_RING if j >= dref.LIV_RING else -1
        for j in range(n_iter)]
    assert st["adds"] == list(range(n_iter)) == st["emits"]
    trips = max(0, -(-(n_iter - dref.LIV_RING - dref.LIV_UNROLL + 1)
                     // dref.LIV_UNROLL))
    assert st["fast"] + st["stepped"] == trips
    m = n - dref.LIV_CHUNK
    if n_iter * dref.LIV_CHUNK > m and m > dref.LIV_UNROLL * dref.LIV_CHUNK:
        assert 0 < st["stepped"] <= -(-n_iter * dref.LIV_CHUNK // m)
        assert st["fast"] > st["stepped"]
    if m < (dref.LIV_UNROLL - 1) * dref.LIV_CHUNK:
        assert st["fast"] == 0
    first = -(-m // dref.LIV_CHUNK)        # the first iteration past a wrap
    if m % dref.LIV_CHUNK and first < n_iter:   # it lands past 0
        assert int(want[first]) == first * dref.LIV_CHUNK - m > 0
    buf = torch.from_numpy(
        np.random.default_rng(n_iter).standard_normal(n, dtype=np.float32))
    offs = dict((j, o) for j, o, _ in st["loads"])
    acc = torch.zeros(8, dtype=torch.float32)
    for j in st["adds"]:
        acc = acc + buf[offs[j]:offs[j] + 8]
    lanes = torch.arange(dref.LIV_CHAINS, dtype=torch.float32)
    per_lane = lanes[0].expand(8)
    for j in range(1, dref.LIV_CHAINS):
        per_lane = per_lane + lanes[j]
    total = reduce_threads(per_lane + acc)
    got, _ = dref.livermore_plain(buf, n_iter=n_iter, width=8, fp=False)
    assert torch.equal(got, total)


def test_livermore_body_is_per_iteration(monkeypatch):
    """livermore_target states no |body|, so it is derived from the clean
    SASS's innermost loop, which holds an unrolled trip: divided by
    LIV_UNROLL it is one iteration's (the payload census's body_ops too)."""
    import dataclasses

    from repro_torch.core import payload as pm
    from repro_torch.core.controller import census_payload, derive_body_size
    from repro_torch.kernels import _build

    U = dref.LIV_UNROLL
    iteration = ["FADD R1, R1, R7"] + [f"FADD R{8 + j}, R{8 + j}, 1e-07"
                                       for j in range(12)] \
        + ["LDG.E.CONSTANT R7, desc[UR4][R2.64+0x100]"]
    body = ["S2R R0, SR_TID.X", ".L_x_0:", "ISETP.GE.AND P0, PT, R0, R5, PT",
            ".L_x_1:", *(iteration * U), "IADD3 R4, R4, 0x800, RZ",
            "IADD3 R0, R0, 0x8, RZ", "ISETP.GT.AND P1, PT, R4, R6, PT",
            "@!P1 BRA `(.L_x_1)", *iteration, "IADD3 R4, R4, 0x40, RZ",
            "@!P0 BRA `(.L_x_0)", "EXIT", ".L_x_2:", "BRA `(.L_x_2)"]
    text = "\n".join(["\t\tFunction : _Z10liv_kernelILb1ELb1ELi0ELi0EEvPKfiiii",
                      *(f"        /*{16 * a:04x}*/   {ins} ;"
                        if not ins.endswith(":") else ins
                        for a, ins in enumerate(body))]) + "\n"
    monkeypatch.setattr(_build, "site_sass", lambda site: text)
    target = livermore_target(32, n=1 << 12, width=16, device="cpu")
    region = dataclasses.replace(target, device="cuda").region()
    assert region.sass("", 0).unroll == U
    trip = len(iteration) * U + 3          # the trip's IADD3 x2 and ISETP
    assert pm.body_size(text) == trip
    assert derive_body_size(region) == (trip + U // 2) // U \
        == len(iteration)
    monkeypatch.setattr(_build, "site_sass",
                        lambda site: text.replace("ILi0ELi0E", "ILi1ELi4E")
                        if site.k else text)
    assert census_payload(region, "fp_add", 4, expected=4).body_ops \
        == len(iteration)


def test_stream_wrapper_refuses_where_the_stepped_offset_would_differ():
    """At n_iter*512 >= 2^31 the int32 product wraps and the stepped offset
    is no longer the reference's: the launcher refuses before it
    launches (at one iteration less it goes on to the launch)."""
    args = tuple(torch.from_numpy(a.copy()) for a in _ref_inputs())
    kw = {"kind": "stream", "depth": 4, "fp": True, "ls": True, "width": 8,
          "mode": "none", "k": 0, "carry": None, "static": False}
    with pytest.raises(ValueError, match="below 2\\^31"):
        dk.table3_cuda(*args, n_iter=2 ** 22, **kw)
    with pytest.raises(Exception) as err:
        dk.table3_cuda(*args, n_iter=2 ** 22 - 1, **kw)
    assert "2^31" not in str(err.value)


def test_variants_refuse_noise_and_empty_removal():
    args = tuple(torch.from_numpy(a.copy()) for a in _ref_inputs())
    with pytest.raises(ValueError, match="without noise"):
        dk.table3(*args, kind="token", depth=1, n_iter=1, width=8, fp=False,
                  mode="fp_add", k=1, carry={})
    with pytest.raises(ValueError, match="keeps FP, LS or both"):
        dk.table3(*args, kind="token", depth=1, n_iter=1, width=8, fp=False,
                  ls=False)


def test_targets_region_and_names():
    tgt = table3_target("t3_compute-bound", "token", 24, 16, n=N, width=8,
                        device="cpu")
    region = tgt.region()
    assert region.name == "t3_compute-bound" and tgt.n_iter == 16
    out, aux = region.build_rt("fp_add")(2, *region.args_for_rt("fp_add"))
    clean = region.build("", 0)(*region.args_for("", 0))
    assert torch.equal(out, clean) and float(aux) != 0.0
    assert region.payload_check("l1_ld", 4).payload == 4
    for fp, ls in VARIANTS.values():
        assert torch.equal(tgt.build(fp, ls)(*tgt.args_for()),
                           tgt.build_plain(fp, ls)(*tgt.args_for()))
    liv = livermore_target(32, n=1 << 12, width=16, device="cpu")
    assert liv.name == "livermore_1351"
    # seeded targets: random inputs, the same for the same seed
    one, two = (table3_target("t", "token", 1, 4, n=N, width=8, seed=s,
                              device="cpu").args_for() for s in (3, 3))
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    a, b, c, x0 = one
    assert float(a.std()) > 0.5 and not torch.equal(a, b)
    assert 0.1 <= float(x0.min()) and float(x0.max()) < 0.9
    assert not torch.equal(x0, tgt.args_for()[3])
    buf = livermore_target(4, n=1 << 12, seed=3, device="cpu").args_for()[0]
    assert float(buf.std()) > 0.5


def _bench(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", *args],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 **(env or {})),
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("study", ("table3", "fig6"))
def test_study_cli_replays_with_zero_measured(tmp_path, study):
    store, out = str(tmp_path / "st"), str(tmp_path / "out")
    first = _bench(study, "--device", "cpu", "--store-dir", store,
                   "--out", out)
    assert first.returncode == 0, first.stdout + first.stderr
    name = {"table3": "table3_decan", "fig6": "fig6_overlap"}[study]
    res = json.load(open(os.path.join(out, f"{name}.json")))
    assert res["points"]["measured"] > 0
    stats = json.load(open(os.path.join(out, f"{name}.stats.json")))
    kernel = "decan_table3" if study == "table3" else "decan_livermore"
    assert stats["launches"][kernel][1] > 0        # the plain versions ran
    again = _bench(study, "--device", "cpu", "--store-dir", store, "--out",
                   out, "--expect-no-measure")
    assert again.returncode == 0, again.stdout + again.stderr
    res2 = json.load(open(os.path.join(out, f"{name}.json")))
    assert res2["points"]["measured"] == 0 and res2["points"]["replayed"] > 0
    rows = ({k: v for k, v in res.items() if isinstance(v, dict)
             and "sat_fp" in v} if study == "table3" else {"fig6": res})
    assert rows and all(
        {"sat_fp", "sat_ls", "noise_label", "combined_label"} <= set(r)
        for r in rows.values())
    if study == "table3":
        assert set(rows) == set(ref_t3.SCENARIOS)
        for r, r2 in zip(rows.values(), (res2[k] for k in rows)):
            assert (r["sat_fp"], r["sat_ls"], r["abs_fp"]) \
                == (r2["sat_fp"], r2["sat_ls"], r2["abs_fp"])


def test_fig4_pallas_runs_the_matmul_kernel_study(tmp_path):
    out = str(tmp_path / "out")
    res = _bench("fig4", "--device", "cpu", "--pallas", "--out", out,
                 env={"REPRO_SYNTH_MEASURE": "1e-3"})
    assert res.returncode == 0, res.stdout + res.stderr
    got = json.load(open(os.path.join(out, "fig4_matmul.json")))
    pallas = got["pallas"]
    assert pallas["region"] == "pallas_matmul_n128"
    assert set(pallas["abs"]) == {"fp", "vmem"}
    assert pallas["sweep_cost"]["compile_once"]["executables"] <= 2
    assert pallas["sweep_cost"]["trace_per_k"]["executables"] >= 6
    assert "signature_flip" in got


@pytest.mark.parametrize("study", ("fig5", "table3", "fig6", "table1",
                                   "table4"))
def test_pallas_is_refused_where_the_reference_has_none(tmp_path, study):
    res = _bench(study, "--device", "cpu", "--pallas", "--out",
                 str(tmp_path))
    assert res.returncode == 2
    assert "--pallas" in res.stderr and "usage:" in res.stderr
    assert not os.listdir(tmp_path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", sorted(ref_t3.SCENARIOS))
def test_cuda_decan_kernels_against_plain(card, scenario):
    """On the card, on seeded random inputs: every variant and the noisy
    reference variant at k=5 bitwise equal to the plain version on the same
    tensors, the stream scenarios' whole triad buffer too."""
    from repro_torch.core.loopnoise import loop_carry, make_loop_modes

    kind, depth, _ = ref_t3.SCENARIOS[scenario]
    n_iter = (1 << 16) // dref.CHUNK if kind == "stream" else 64
    tgt = table3_target(f"t3_{scenario}", kind, depth, n_iter, n=1 << 16,
                        width=None if kind == "stream" else 1024, seed=0)
    args = tgt.args_for()
    for fp, ls in VARIANTS.values():
        assert torch.equal(tgt.build(fp, ls)(*args),
                           tgt.build_plain(fp, ls)(*args))
        if kind == "stream":
            got, want = args[2].clone(), args[2].clone()
            dk.table3(*args, kind=kind, depth=depth, n_iter=n_iter, fp=fp,
                      ls=ls, cout=got)
            dref.table3_plain(*args, kind=kind, depth=depth, n_iter=n_iter,
                              fp=fp, ls=ls, cout=want)
            assert torch.equal(got, want)
    for mode in ("fp_add", "l1_ld", "mem_ld", "chase"):
        carry = loop_carry(mode, card)
        noise = make_loop_modes()[mode]
        got = tgt.build_noisy(noise, 5, static=False)(*args, carry)
        want = tgt.build_noisy(noise, 5, plain=True)(*args, carry)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
