"""The port's loop regions (``repro_torch.bench``) on the CPU, through
their plain versions, against the reference's (``repro.bench.kernels``):

* every region's output at k=0 and, under every loop mode, at k=4 equals
  the reference region's on the reference's own inputs (STREAM bitwise,
  lat_mem_rd exact, SPMXV, HACCmk and the matmuls to the f32 summation
  bound of their reordered sums);
* outputs are bitwise equal across k, and ``build_rt(k)`` equals
  ``build(k)`` (out and aux);
* ``payload_check`` passes for every mode; a sweep takes at most two
  builds per mode; the trace-per-k fallback one per k;
* both packages write byte-identical stores for ``stream_triad`` under
  ``REPRO_SYNTH_MEASURE``;
* a region asked for ``cuda`` without a card raises; names and body sizes
  are the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.bench import kernels as ref_bench
from repro.core import Campaign as RefCampaign
from repro.core import Controller as RefController
from repro_torch.bench import kernels as port_bench
from repro_torch.convert import carry_to_torch, to_torch
from repro_torch.core import absorption as port_abs
from repro_torch.core.campaign import Campaign
from repro_torch.core.controller import Controller

MODES = ("fp_add", "fp_fma", "l1_ld", "mem_ld", "chase")

# region -> (builder name, reference-size kwargs, tolerance against the
# reference). STREAM and lat_mem_rd compute the same operations in the same
# order (exact); the others sum in another order than XLA: rtol 1e-5 covers
# the f32 recursive-summation bound of their short sums (HACCmk: 6 chains x
# 8 lanes; SPMXV: 16 terms a row; matmul: 16 columns of 64-256 products)
REGIONS = {
    "stream_triad": ("stream_region", {"n": 1 << 12, "chunk": 512}, 0.0),
    "lat_mem_rd": ("lat_mem_rd_region", {"table_len": 1 << 10, "n_iter": 32},
                   0.0),
    "haccmk": ("haccmk_region", {"n_iter": 20, "width": 8}, 1e-5),
    "spmxv_q0.5": ("spmxv_region", {"n": 1 << 10, "q": 0.5}, 1e-5),
    "matmul_O0": ("matmul_region", {"n": 16}, 1e-5),
    "matmul_O3": ("matmul_region", {"n": 16, "optimized": True}, 1e-5),
}


@pytest.fixture(autouse=True)
def _fresh_port_measure_state():
    port_abs.reset_floor_warnings()
    port_abs.reset_synth_state()
    yield
    port_abs.release_synth_hang()


@pytest.fixture(scope="module")
def pairs():
    """region -> (reference RegionTarget, port RegionTarget on the CPU)."""
    out = {}
    for name, (builder, kw, _) in REGIONS.items():
        out[name] = (getattr(ref_bench, builder)(**kw),
                     getattr(port_bench, builder)(device="cpu", **kw))
    return out


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _port_on_ref_inputs(ref, port, mode, k):
    """The port's static-k build run on the reference region's arguments
    (and its carry, converted)."""
    args = ref.args_for(mode, k)
    if mode and k:
        base = to_torch([np.asarray(a) for a in args[:-1]])
        call = (*base, carry_to_torch(
            {key: (tuple(np.asarray(v) for v in val)
                   if isinstance(val, tuple) else np.asarray(val))
             for key, val in args[-1].items()}))
    else:
        call = to_torch([np.asarray(a) for a in args])
    return port.build(mode, k)(*call)


@pytest.mark.parametrize("mode", ("",) + MODES)
@pytest.mark.parametrize("region", sorted(REGIONS))
def test_output_matches_the_reference(pairs, region, mode):
    ref, port = pairs[region]
    rtol = REGIONS[region][2]
    k = 4 if mode else 0
    want = ref.build(mode, k)(*ref.args_for(mode, k))
    got = _port_on_ref_inputs(ref, port, mode, k)
    if mode:
        want, got = want[0], got[0]
        # the aux: the reference sums one carry, the port one per thread
        # group; both are finite
    if rtol:
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("region", sorted(REGIONS))
def test_outputs_unchanged_across_k_and_runtime_k_is_static_k(pairs, region):
    _, port = pairs[region]
    clean = port.build("", 0)(*port.args_for("", 0))
    for mode in MODES:
        static = port.build(mode, 4)(*port.args_for(mode, 4))
        rt = port.build_rt(mode)(4, *port.args_for_rt(mode))
        assert torch.equal(static[0], clean), mode
        assert torch.equal(static[0], rt[0]) and torch.equal(static[1], rt[1])
        assert torch.isfinite(static[1])
        rt0 = port.build_rt(mode)(0, *port.args_for_rt(mode))
        assert torch.equal(rt0[0], clean), mode


@pytest.mark.parametrize("region", sorted(REGIONS))
def test_payload_check_passes_every_mode(pairs, region):
    _, port = pairs[region]
    for mode in MODES:
        rep = port.payload_check(mode, 6)
        assert rep.expected == rep.payload == 6 and rep.ok(), mode
        assert rep.body_ops == port.body_size


def test_names_and_body_sizes_are_the_references(pairs):
    for ref, port in pairs.values():
        assert port.name == ref.name
        assert port.body_size == ref.body_size
        assert port.audit_hint == ref.audit_hint


def _counting(region):
    """The region with its builds counted (static and run-time)."""
    builds = {"n": 0}

    def count(fn):
        def wrapped(*a):
            builds["n"] += 1
            return fn(*a)
        return wrapped

    return dataclasses.replace(region, build=count(region.build),
                               build_rt=count(region.build_rt)), builds


def test_sweep_builds_at_most_two_per_mode(pairs):
    region, builds = _counting(pairs["stream_triad"][1])
    ctl = Controller(reps=2, compile_once=True)
    before = 0
    for mode in MODES:
        res = ctl.run_mode(region, mode, ks=(0, 1, 2, 4, 8, 16))
        assert builds["n"] - before <= 2, mode
        before = builds["n"]
        assert len(res.curve.ks) >= 3
        assert res.injection.payload == res.injection.expected > 0


def test_fallback_builds_one_per_k(pairs):
    region, builds = _counting(pairs["haccmk"][1])
    ctl = Controller(reps=2, compile_once=False, verify_payload=False,
                     stop_ratio=100.0)
    ctl.run_mode(region, "fp_add", ks=(0, 2, 4, 8))
    assert builds["n"] >= 4


def test_both_packages_write_byte_identical_stores(tmp_path, monkeypatch):
    """Under the deterministic clock, the reference and the port write the
    same bytes for the same stream_triad campaign (the payload records
    differ by construction: the reference counts HLO ops, the port checks
    the aux, so both sweep without it, as the studies do)."""
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    paths = {p: str(tmp_path / f"{p}.jsonl") for p in ("ref", "port")}
    ref = RefCampaign(paths["ref"], RefController(reps=2, verify_payload=False))
    ref.characterize(ref_bench.stream_region(n=4096), ["fp_add", "l1_ld",
                                                       "mem_ld"])
    ref.store.close()
    port = Campaign(paths["port"], Controller(reps=2, verify_payload=False))
    rep = port.characterize(port_bench.stream_region(n=4096, device="cpu"),
                            ["fp_add", "l1_ld", "mem_ld"])
    port.store.close()
    assert ref.stats.measured == port.stats.measured > 0
    with open(paths["ref"], "rb") as f_ref, open(paths["port"], "rb") as f:
        assert f_ref.read() == f.read()
    assert rep.bottleneck.label
    # the port replays the reference's store without measuring
    monkeypatch.delenv("REPRO_SYNTH_MEASURE")
    again = Campaign(paths["ref"], Controller(reps=2, verify_payload=False))
    again.characterize(port_bench.stream_region(n=4096, device="cpu"),
                       ["fp_add", "l1_ld", "mem_ld"])
    again.store.close()
    assert again.stats.measured == 0 and again.stats.cached > 0


@pytest.mark.parametrize("builder", ["stream_region", "lat_mem_rd_region",
                                     "haccmk_region", "spmxv_region",
                                     "matmul_region"])
def test_region_on_cuda_raises_without_a_card(builder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port_bench, builder)(device="cuda")


def test_default_modes_are_the_references():
    """``Controller.characterize`` sweeps fp_add, l1_ld and mem_ld when
    no modes are given, as the reference's does."""
    import inspect

    from repro.core.controller import Controller as Ref

    want = inspect.signature(Ref.characterize).parameters["modes"].default
    got = inspect.signature(Controller.characterize).parameters["modes"]
    assert got.default == want == ("fp_add", "l1_ld", "mem_ld")


def test_cuda_tensors_launch_or_raise():
    """A wrapper given a tensor on neither the CPU nor a CUDA device raises
    instead of taking the plain version."""
    from repro_torch.kernels.loop_regions import kernel as lk

    a = torch.ones(1024, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        lk.stream_triad(a, a, a, chunk=512)


def test_reference_inputs_are_the_ports(pairs):
    """Where both packages draw inputs the same way (all but the matmuls'
    PRNGKey operands), the port's region computes on the reference's
    arguments; HACCmk's x is numpy's linspace, within one f32 ulp of
    jnp's (which rounds start*(1-t) + stop*t in f32)."""
    for name in ("stream_triad", "lat_mem_rd", "spmxv_q0.5"):
        ref, port = pairs[name]
        for r, p in zip(ref.args_for("", 0), port.args_for("", 0)):
            np.testing.assert_array_equal(np.asarray(r).ravel(),
                                          p.numpy().ravel())
    ref, port = pairs["haccmk"]
    want = np.asarray(ref.args_for("", 0)[0])
    got = port.args_for("", 0)[0].numpy()
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels there")
    return torch.device("cuda")


# matmul_O3's (n, n_iter) at the edges of mm_o3_kernel's trips, load ring
# and shared stage (chip_smoke.py's CHECK_O3_SHAPES)
CARD_O3_SHAPES = {f"matmul_O3 n={n} n_iter={it}": (n, it)
                  for n, it in ((8, 128), (33, 531), (192, 8 * 192 + 5),
                                (384, 4 * 384), (13, 5))}


def _o3_edge_against_plain(n: int, n_iter: int) -> None:
    """mm_o3_kernel at (n, n_iter) on seeded inputs: every mode at k in
    {0, 5} against the plain version (out and aux bitwise), run-time k
    equal to static k at k=24."""
    from repro_torch.core.loopnoise import loop_carry
    from repro_torch.kernels.loop_regions import kernel as lk
    from repro_torch.kernels.loop_regions import ref as lref

    rs = np.random.RandomState(n)
    a, b = to_torch(tuple(rs.standard_normal((n, n)).astype(np.float32)
                          for _ in range(2)), torch.device("cuda"))
    for mode in MODES:
        carry = loop_carry(mode, "cuda")
        for k in (0, 5):
            got = lk.matmul_o3(a, b, n_iter=n_iter, mode=mode, k=k,
                               carry=carry, static=False)
            want = lref.matmul_o3_plain(a, b, n_iter=n_iter, mode=mode, k=k,
                                        carry=carry)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (mode, k)
        rt, static = (lk.matmul_o3(a, b, n_iter=n_iter, mode=mode, k=24,
                                   carry=carry, static=s)
                      for s in (False, True))
        assert torch.equal(rt[0], static[0]) and torch.equal(rt[1], static[1])


@pytest.mark.cuda
@pytest.mark.parametrize("region", sorted(REGIONS) + list(CARD_O3_SHAPES))
def test_cuda_loop_kernels_against_plain(card, region):
    """On the card: every mode's run-time and static k=4 kernels against the
    plain version on the same tensors, bitwise (out and aux); matmul_O3 at
    the edges of its kernel's schedule (``CARD_O3_SHAPES``)."""
    if region in CARD_O3_SHAPES:
        _o3_edge_against_plain(*CARD_O3_SHAPES[region])
        return
    builder, kw, _ = REGIONS[region]
    reg = getattr(port_bench, builder)(device="cuda", **kw)
    for mode in MODES:
        args = reg.args_for_rt(mode)
        got = reg.build_rt(mode)(4, *args)
        static = reg.build(mode, 4)(*reg.args_for(mode, 4))
        assert reg.payload_check(mode, 4).payload == 4
        torch.cuda.synchronize()
        assert torch.equal(got[0], static[0]) and torch.equal(got[1], static[1])


@pytest.mark.parametrize("mode", MODES)
def test_grid_stride_carries_are_each_warps_own_loop(mode):
    """The plain versions' noise grouping for STREAM and SPMXV past one
    iteration a warp: with n_iter = 3 W + 37 (W = ``N_WARPS_MAX`` warps),
    warps 0..36 run four iterations and the rest three, the last round only
    partly. Each warp's final carry equals that warp's own sequential loop
    over its iterations w, w + W, ... (k=5: mem_ld's offsets wrap in int32
    past i = 10,604)."""
    from repro_torch.core.loopnoise import loop_carry, make_loop_modes
    from repro_torch.kernels.loop_regions import ref as lref

    W, k = lref.N_WARPS_MAX, 5
    n_iter = 3 * W + 37
    carry = loop_carry(mode, "cpu")
    got = lref.run_noise(mode, carry, k, W,
                         lref._strided_schedule(n_iter, W, "cpu"))
    noise = make_loop_modes()[mode]
    for w in (0, 1, 36, 37, 38, W - 1):
        own = carry
        for i in range(w, n_iter, W):
            own = noise.emit(own, k, i)
        want = lref.lane_values(mode, lref._grouped(own, 1))[0]
        assert torch.equal(got[w], want), w


def test_both_triads_take_their_chunk_from_one_routine():
    """stream_kernel (``csrc/loop_regions.cu``) and t3_kernel's stream
    scenarios (``csrc/decan_loops.cu``) take their chunk from
    ``csrc/triad.cuh``, so the two cannot drift apart (phase 3 of
    ``chip_smoke.py`` holds both against their plain versions on the
    card)."""
    import os

    import repro_torch

    csrc = os.path.join(os.path.dirname(repro_torch.__file__), "csrc")
    for name in ("loop_regions.cu", "decan_loops.cu"):
        with open(os.path.join(csrc, name)) as f:
            assert '#include "triad.cuh"' in f.read(), name
