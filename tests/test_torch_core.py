"""The port's framework-neutral core against the reference: the golden
signatures replay to identical labels and confidences, the whole 8748-cell
decision table classifies identically in both packages, the strategy guard
rejects every scope-opening expression (the reference's co_consts guard
misses inlined comprehensions on Python 3.12), and the three-phase fit is
identical on the same series."""
import importlib
import json
import os
import shutil

import numpy as np
import pytest

from repro.core.classifier import classify as ref_classify
from repro_torch.core import absorption as port_abs
from repro_torch.core.campaign import Campaign
from repro_torch.core.classifier import HIGH, LOW, classify
from repro_torch.core.controller import Controller, RegionTarget
from repro_torch.core.strategy import (StrategyError, StrategyTree,
                                       default_tree, strategies_dir)

ref_abs = importlib.import_module("repro.core.absorption")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLDEN_DIR, "expected.json")) as f:
    EXPECTED = json.load(f)


@pytest.fixture(autouse=True)
def _fresh_port_measure_state():
    """The port keeps its own synthetic-clock and floor-warning state."""
    port_abs.reset_floor_warnings()
    port_abs.reset_synth_state()
    yield
    port_abs.release_synth_hang()


def _fail_build(*a, **k):
    raise AssertionError("golden replay must never build or measure")


@pytest.mark.parametrize("region", sorted(EXPECTED), ids=sorted(EXPECTED))
def test_port_replays_golden_signatures(tmp_path, region):
    dst = str(tmp_path / "signatures.jsonl")
    shutil.copy(os.path.join(GOLDEN_DIR, "signatures.jsonl"), dst)
    exp = EXPECTED[region]
    camp = Campaign(dst, Controller(reps=2, verify_payload=False))
    rep = camp.characterize(RegionTarget(name=region, build=_fail_build,
                                         args_for=_fail_build),
                            sorted(exp["modes"]))
    camp.store.close()
    assert camp.stats.measured == 0
    assert rep.bottleneck.label == exp["label"]
    assert rep.bottleneck.confidence == pytest.approx(exp["confidence"],
                                                      rel=1e-6, abs=1e-9)
    assert rep.body_size == exp["body_size"]
    for mode, fields in exp["modes"].items():
        fit = rep.results[mode].fit
        for name, want in fields.items():
            assert getattr(fit, name) == pytest.approx(want, rel=1e-6,
                                                       abs=1e-12)


def _cells(low, high):
    """The boundary-exhaustive decision table of tests/test_strategy.py."""
    vals = (None, 0.0, 3.0, low, low + 0.125, high / 2, high - 0.25, high,
            high + 6.0)
    ici_options = ({}, {"ici_allreduce": 0.0},
                   {"ici_allreduce": high + 1.0},
                   {"ici_allreduce": low, "ici_all2all": high})
    for fp in vals:
        for l1 in vals:
            for mem in vals:
                for chase in (None, 0.0, high):
                    for icis in ici_options:
                        sig = {name: v for name, v in (
                            ("fp_add", fp), ("l1_ld", l1), ("mem_ld", mem),
                            ("chase", chase)) if v is not None}
                        sig.update(icis)
                        yield sig


@pytest.mark.parametrize("low,high", [(LOW, HIGH), (4.5, 16.5)])
def test_decision_table_classifies_identically_in_both_packages(low, high):
    checked = 0
    for sig in _cells(low, high):
        got = classify(sig, low=low, high=high)
        want = ref_classify(sig, low=low, high=high)
        assert (got.label, got.confidence, got.explanation) == \
            (want.label, want.confidence, want.explanation), sig
        assert got.path == want.path, sig
        checked += 1
    assert checked == 9 * 9 * 9 * 3 * 4


def test_port_reads_the_shared_strategy_tree():
    assert os.path.samefile(strategies_dir(),
                            os.path.join(os.path.dirname(__file__), "..",
                                         "strategies"))
    assert [n.name for n in default_tree().nodes][-1] == "mixed"


def _spec(when):
    return {"strategy": 1, "name": "t", "slots": {"fp": ["fp_add"]},
            "nodes": [{"name": "n", "label": "x", "when": when,
                       "fixed": 0.5, "explanation": "e"}]}


@pytest.mark.parametrize("expr", [
    "min([v for v in known])",
    "min({v for v in known})",
    "min({k: v for k, v in known.items()}.values())",
    "min(v for v in known.values())",
    "(lambda: True)()",
    "[v for v in [1]] and True",
])
def test_guard_rejects_scopes_the_reference_guard_misses(expr):
    with pytest.raises(StrategyError, match="not allowed"):
        StrategyTree(_spec(expr))


def test_guard_still_rejects_unknown_names_and_accepts_the_tree_grammar():
    with pytest.raises(StrategyError, match="unknown name"):
        StrategyTree(_spec("__import__('os')"))
    tree = StrategyTree(_spec("fp is not None and min(known.values()) <= low"))
    assert tree.decide({"fp_add": 1.0}, low=LOW, high=HIGH).label == "x"


def _series(seed):
    rng = np.random.RandomState(seed)
    ks = [0, 1, 2, 4, 8, 12, 16, 24, 32, 48, 64]
    knee = rng.choice(ks[1:-2])
    base = 1e-3 * (1 + rng.random_sample())
    ts = [base * (1 + 0.04 * max(0, k - knee)) * (1 + 0.01 * rng.random_sample())
          for k in ks]
    return ks, ts


@pytest.mark.parametrize("seed", range(6))
def test_fit_and_absorption_match_the_reference(seed):
    ks, ts = _series(seed)
    got = port_abs.fit_three_phase(ks, ts)
    want = ref_abs.fit_three_phase(ks, ts)
    assert got.__dict__ == want.__dict__
    curve = port_abs.assemble_curve("fp", ks, ts, drift=1.03)
    ref_curve = ref_abs.assemble_curve("fp", ks, ts, drift=1.03)
    assert curve.ts == ref_curve.ts
    assert port_abs.absorption(curve).__dict__ == \
        ref_abs.absorption(ref_curve).__dict__
    assert port_abs.cluster_times(ts) == ref_abs.cluster_times(ts)


def test_synthetic_clock_reads_a_plain_int_k(monkeypatch):
    monkeypatch.setenv(port_abs.SYNTH_MEASURE_VAR, "1e-3")
    t0 = port_abs.measure(lambda k: None, (0,))
    t24 = port_abs.measure(lambda k: None, (24,))
    assert t0 == 1e-3
    assert t24 == pytest.approx(1e-3 * (1 + 0.05 * 18))
    # a leading tensor (a static-k build's operands) carries no noise quantity
    import torch
    assert port_abs.measure(lambda a: None, (torch.ones(3),)) == 1e-3
