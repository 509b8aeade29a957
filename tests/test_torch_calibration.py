"""Threshold calibration in the port (``repro_torch.core.calibration``):
the reference's ``tests/test_calibration.py`` cases that need no segmented
store, run through the port, plus the fleet's ``calibrate`` kind, its CLI
and classification under a calib record.

Pinned contracts, as the reference's:
  * ``fit_thresholds`` places max-margin cuts between the role clusters and
    falls back to the paper defaults (fitted=False) whenever the clusters
    are missing, overlap, or the cuts invert (property layer with
    hypothesis, optional);
  * ``forced_regime`` appends the SynthShape marker where the synthetic
    clock scans for it and strips it before the real callable runs;
  * ``calib`` records are hw-keyed, last-wins superseded, and survive merge;
  * ``run_calibration`` refuses to run without the synthetic clock, fits
    low=4.5/high=16.5 from the shipped regime shapes, classifies all four
    known regimes correctly with a mean confidence above the
    default-threshold run, and replays from a complete store with zero new
    measurements; the reference's fit on the same regimes is the same.
"""
try:
    import hypothesis
    import hypothesis.strategies as st
except ModuleNotFoundError:   # property tests skip; the rest still runs
    from conftest import hypothesis_stub as hypothesis
    from conftest import strategies_stub as st

import json
import os

import pytest

from repro_torch.core import absorption as port_abs
from repro_torch.core.calibration import (CALIB_MODES, EXPECTED, REGIMES,
                                          calibrate_targets, fit_thresholds,
                                          hw_name,
                                          resolve_thresholds, run_calibration)
from repro_torch.core.classifier import HIGH, LOW, classify


@pytest.fixture(autouse=True)
def _fresh_port_measure_state():
    port_abs.reset_floor_warnings()
    port_abs.reset_synth_state()
    yield
    port_abs.release_synth_hang()


def _samples(sats=(), mids=(), highs=()):
    out = []
    for role, k1s in (("sat", sats), ("mid", mids), ("high", highs)):
        out.extend({"region": "r", "mode": "m", "role": role, "k1": k1}
                   for k1 in k1s)
    return out


# ---------------------------------------------------------------- fit math

def test_fit_places_max_margin_cuts():
    low, high, fitted = fit_thresholds(
        _samples(sats=(0.0, 1.0), mids=(8.0,), highs=(24.0, 25.0)))
    assert fitted
    assert low == pytest.approx((1.0 + 8.0) / 2)
    assert high == pytest.approx((8.0 + 24.0) / 2)


def test_fit_without_mid_cluster_falls_back():
    assert fit_thresholds(_samples(sats=(1.0,), highs=(25.0,))) \
        == (LOW, HIGH, False)


def test_fit_falls_back_when_a_boundary_cluster_is_missing():
    assert fit_thresholds(_samples(mids=(8.0,), highs=(24.0,))) \
        == (LOW, HIGH, False)
    assert fit_thresholds(_samples(sats=(1.0,), mids=(8.0,))) \
        == (LOW, HIGH, False)
    assert fit_thresholds([]) == (LOW, HIGH, False)


def test_fit_falls_back_when_clusters_overlap():
    assert fit_thresholds(
        _samples(sats=(9.0,), mids=(8.0,), highs=(24.0,)))[2] is False
    assert fit_thresholds(
        _samples(sats=(1.0,), mids=(30.0,), highs=(24.0,)))[2] is False


def test_fit_honours_custom_defaults_on_fallback():
    low, high, fitted = fit_thresholds([], default_low=3.0, default_high=9.0)
    assert (low, high, fitted) == (3.0, 9.0, False)


@hypothesis.given(st.lists(st.floats(0.0, 2.0, allow_nan=False), max_size=4),
                  st.lists(st.floats(6.0, 10.0, allow_nan=False), max_size=4),
                  st.lists(st.floats(20.0, 40.0, allow_nan=False),
                           min_size=1, max_size=4))
@hypothesis.settings(max_examples=60, deadline=None)
def test_fit_deterministic_and_never_inverts(sats, mids, highs):
    """Same samples -> same fit, equal to the reference's; a fitted result
    keeps LOW strictly below HIGH."""
    from repro.core.calibration import fit_thresholds as ref_fit

    sats = sats or [0.0]
    a = fit_thresholds(_samples(sats=sats, mids=mids, highs=highs))
    assert a == fit_thresholds(_samples(sats=sats, mids=mids, highs=highs))
    assert a == ref_fit(_samples(sats=sats, mids=mids, highs=highs))
    low, high, fitted = a
    if fitted:
        assert low < high
    else:
        assert (low, high) == (LOW, HIGH)


@hypothesis.given(st.floats(0.0, 50.0, allow_nan=False),
                  st.floats(0.0, 50.0, allow_nan=False))
@hypothesis.settings(max_examples=60, deadline=None)
def test_fit_monotone_in_the_separating_gap(gap_a, gap_b):
    lo_gap, hi_gap = sorted((gap_a, gap_b))

    def wide(gap):
        return _samples(sats=(0.0, 1.0), mids=(8.0,),
                        highs=(24.0 + gap, 25.0 + gap))

    _, high_small, f1 = fit_thresholds(wide(lo_gap))
    _, high_large, f2 = fit_thresholds(wide(hi_gap))
    assert f1 and f2
    assert high_small <= high_large


# ------------------------------------------------- forced-regime wrappers

def test_forced_regime_appends_and_strips_the_marker():
    from repro_torch.core.absorption import SynthShape

    targets = {t.name: t for t in calibrate_targets(n=256, chunk=64,
                                                    device="cpu")}
    assert set(targets) == set(REGIMES)
    t = targets["calib_compute"]
    args = t.args_for("fp_add", 3)
    assert isinstance(args[-1], SynthShape)
    assert args[-1] == REGIMES["calib_compute"]["fp_add"][1]
    rt_args = t.args_for_rt("fp_add")
    assert isinstance(rt_args[-1], SynthShape)
    out, aux = t.build("fp_add", 2)(*args)     # the marker is stripped
    assert out.shape == (256,) and float(aux) != 0.0
    t.build_rt("fp_add")(2, *rt_args)
    assert t.payload_check("fp_add", 2) is None


def test_regimes_are_the_references():
    from repro.core import calibration as ref

    assert CALIB_MODES == ref.CALIB_MODES
    assert EXPECTED == ref.EXPECTED
    assert {n: {m: (r, (s.knee, s.slope)) for m, (r, s) in spec.items()}
            for n, spec in REGIMES.items()} == \
        {n: {m: (r, (s.knee, s.slope)) for m, (r, s) in spec.items()}
         for n, spec in ref.REGIMES.items()}
    for name, spec in REGIMES.items():
        assert set(spec) == set(CALIB_MODES)
        assert {role for role, _ in spec.values()} <= {"sat", "mid", "high"}
        assert name in EXPECTED


# ------------------------------------------------------- store semantics

def _calib_rec(hw="cpu", low=4.5, high=16.5, fitted=True):
    return {"kind": "calib", "hw": hw, "low": low, "high": high,
            "fitted": fitted, "reps": 2, "samples": []}


def test_calib_records_supersede_by_hw_and_survive_merge(tmp_path):
    from repro_torch.core.campaign import CampaignStore, merge_stores

    path = str(tmp_path / "s.jsonl")
    store = CampaignStore(path)
    store.append(_calib_rec(low=1.0, high=2.0, fitted=False))
    store.append(_calib_rec(hw="NVIDIA H100 80GB HBM3", low=3.0, high=30.0))
    store.append(_calib_rec(low=4.5, high=16.5))   # supersedes cpu
    store.close()
    loaded = CampaignStore(path, readonly=True)
    assert set(loaded.calib) == {"cpu", "NVIDIA H100 80GB HBM3"}
    assert loaded.calib["cpu"]["low"] == 4.5
    assert loaded.calib["cpu"]["fitted"] is True
    merged = str(tmp_path / "m.jsonl")
    merge_stores(merged, [path])
    assert CampaignStore(merged, readonly=True).calib == loaded.calib


class _FakeStore:
    def __init__(self, calib):
        self.calib = calib


def test_resolve_thresholds_provenance():
    assert resolve_thresholds(_FakeStore({})) == (LOW, HIGH, "default")
    assert resolve_thresholds(_FakeStore({"gpu": _calib_rec(hw="gpu")}),
                              hw="cpu") == (LOW, HIGH, "default")
    assert resolve_thresholds(_FakeStore({"cpu": _calib_rec(fitted=False)}),
                              hw="cpu") == (LOW, HIGH, "fallback")
    assert resolve_thresholds(_FakeStore({"cpu": _calib_rec()}),
                              hw="cpu") == (4.5, 16.5, "calibrated")


def test_hw_name_is_the_card_or_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert hw_name() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert hw_name() == "NVIDIA H100 80GB HBM3"


# ------------------------------------------------------------ end-to-end

def test_run_calibration_requires_the_synth_clock(monkeypatch):
    monkeypatch.delenv("REPRO_SYNTH_MEASURE", raising=False)
    with pytest.raises(RuntimeError, match="REPRO_SYNTH_MEASURE"):
        run_calibration("unused.jsonl", device="cpu")


def test_run_calibration_end_to_end(monkeypatch, tmp_path):
    """All four known regimes classify correctly under the fitted
    thresholds, the mean confidence beats the default-threshold run with
    no regime losing confidence, the calib record persists, a re-run
    replays without measuring, and the reference fits the same."""
    from repro.core.calibration import run_calibration as ref_run
    from repro_torch.core.campaign import CampaignStore

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    store = str(tmp_path / "cal.jsonl")
    res = run_calibration(store, reps=2, device="cpu")
    assert (res.low, res.high, res.fitted) == (4.5, 16.5, True)
    assert res.correct()
    fitted_conf, default_conf = [], []
    for name, rep in res.reports.items():
        assert rep.bottleneck.label == EXPECTED[name]
        base = classify({m: r.fit.k1 for m, r in rep.results.items()})
        assert base.label == EXPECTED[name]
        assert rep.bottleneck.confidence >= base.confidence
        fitted_conf.append(rep.bottleneck.confidence)
        default_conf.append(base.confidence)
    assert sum(fitted_conf) > sum(default_conf)
    loaded = CampaignStore(store, readonly=True)
    assert resolve_thresholds(loaded) == (4.5, 16.5, "calibrated")
    assert len(loaded.calib[res.hw]["samples"]) == \
        len(REGIMES) * len(CALIB_MODES)
    again = run_calibration(store, reps=2, device="cpu")
    assert (again.low, again.high) == (res.low, res.high)
    assert again.stats.measured == 0 and again.stats.cached > 0
    ref = ref_run(str(tmp_path / "ref.jsonl"), reps=2)
    assert (ref.low, ref.high, ref.fitted) == (res.low, res.high, res.fitted)
    assert ref.samples == res.samples


# ------------------------------------------------------------- the fleet

def test_calibrate_target_kind_plans_and_resolves(tmp_path):
    from repro_torch.fleet.plan import PlanError, SweepPlan, TargetSpec

    plan = SweepPlan(name="calibrate", store=str(tmp_path / "c.jsonl"),
                     targets=[TargetSpec("calibrate", CALIB_MODES, {})],
                     backend="cpu", shards=1)
    plan.validate()
    assert [r for r, _ in plan.grid()][::len(CALIB_MODES)] == list(REGIMES)
    assert [t.name for t in plan.resolve()[0][1]] == list(REGIMES)
    for spec in (TargetSpec("calibrate", ("fp",), {}),
                 TargetSpec("calibrate", CALIB_MODES, {"q": 1}),
                 TargetSpec("calibrate", CALIB_MODES, {"n": 0})):
        with pytest.raises(PlanError):
            spec.validate()
    with pytest.raises(PlanError, match="not ported"):
        TargetSpec("serve", ("fp_add32",),
                   {"arch": "qwen3_moe_30b_a3b"}).validate()


def test_calibrate_cli_runs_replays_inspects_and_applies(tmp_path, capsys,
                                                        monkeypatch):
    from repro_torch.core.campaign import CampaignStore
    from repro_torch.fleet.cli import main

    # the CLI turns the synthetic clock on; monkeypatch turns it off after
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    store = str(tmp_path / "cal.jsonl")
    assert main(["calibrate", "run", "--store", store, "--backend",
                 "cpu"]) == 0
    out = capsys.readouterr().out
    assert "low=4.5 high=16.5 (fitted)" in out and "WRONG" not in out
    assert main(["calibrate", "run", "--store", store, "--backend", "cpu",
                 "--expect-no-measure"]) == 0
    assert main(["calibrate", "inspect", "--store", store]) == 0
    assert "calib hw=cpu: low=4.5 high=16.5 [fitted]" in \
        capsys.readouterr().out
    dest = str(tmp_path / "dest.jsonl")
    assert main(["calibrate", "apply", "--store", store, "--to", dest]) == 0
    assert CampaignStore(dest, readonly=True).calib["cpu"]["low"] == 4.5
    assert main(["calibrate", "inspect", "--store",
                 str(tmp_path / "none.jsonl")]) == 2


def test_fleet_classifies_under_the_stores_calibration(tmp_path, monkeypatch):
    """A plan whose store holds a calib record for this hardware classifies
    under the fitted thresholds (the executor's ``resolve_thresholds``)."""
    from repro_torch.core.campaign import CampaignStore
    from repro_torch.fleet.executor import run_worker
    from repro_torch.fleet.plan import SweepPlan, TargetSpec

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    store = str(tmp_path / "s.jsonl")
    plan = SweepPlan(name="p", store=store, backend="cpu",
                     targets=[TargetSpec("calibrate", CALIB_MODES, {})])
    reports, _ = run_worker(plan)
    default = {n: (r.bottleneck.label, r.bottleneck.confidence)
               for n, r in reports.items()}
    s = CampaignStore(store)
    s.append(_calib_rec(hw=hw_name(), low=4.5, high=16.5))
    s.close()
    reports, stats = run_worker(plan)
    assert stats.measured == 0
    calibrated = {n: (r.bottleneck.label, r.bottleneck.confidence)
                  for n, r in reports.items()}
    assert {n: lab for n, (lab, _) in calibrated.items()} == EXPECTED
    assert sum(c for _, c in calibrated.values()) > \
        sum(c for _, c in default.values())
    with open(plan.report_path()) as f:
        assert set(json.load(f)) == set(REGIMES)
    assert os.path.exists(store)
