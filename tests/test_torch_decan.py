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
