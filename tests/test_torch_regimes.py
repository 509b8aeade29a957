"""The SPMXV regime-transition harness (the reference's
``tests/test_regimes.py``) through the port: the spmxv family over the swap
probability q, each member's modes forced onto per-q synthetic clock
shapes (``forced_regime``), classified through the port's campaign and
strategy tree, and held against the reference's golden map
``tests/golden/regimes.json`` (read, not copied): labels, confidences,
Abs^raw, and the crossover to ``l1`` pinned at q = 0.75.

    q:        0.0       0.25     0.5      0.75     1.0
    verdict:  compute   mixed    mixed    l1       l1
"""
import json
import os

import pytest

from repro_torch.core import absorption as port_abs

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "regimes.json")

QS = (0.0, 0.25, 0.5, 0.75, 1.0)
TRANSITION_Q = 0.75
BASE_S = "1e-3"


def _forced_family():
    """The port's spmxv family over QS on the CPU, each member forced onto
    its per-q clock: fp knee 1 + 30q, vmem knee max(0, 25 - 30q)."""
    from repro_torch.core.absorption import SynthShape
    from repro_torch.core.calibration import forced_regime
    from repro_torch.kernels.region import pallas_family

    members = pallas_family("spmxv", [512], qs=list(QS), device="cpu")
    out = []
    for q, base in zip(QS, members):
        shapes = {"fp": SynthShape(knee=1.0 + 30.0 * q, slope=0.2),
                  "vmem": SynthShape(knee=max(0.0, 25.0 - 30.0 * q),
                                     slope=0.2)}
        out.append((q, forced_regime(base, base.name, shapes)))
    return out


def sweep_regime_map(store_path: str) -> dict:
    """Run (or replay) the forced q-sweep into ``store_path``: the ordered
    {region: {q, label, confidence, absorptions}} map the golden file
    pins."""
    from repro_torch.core.campaign import Campaign
    from repro_torch.core.controller import Controller

    port_abs.reset_synth_state()
    camp = Campaign(store_path, Controller(reps=2, verify_payload=False))
    out = {}
    for q, target in _forced_family():
        rep = camp.characterize(target, ["fp", "vmem"])
        out[target.name] = {
            "q": q,
            "label": rep.bottleneck.label,
            "confidence": rep.bottleneck.confidence,
            "absorptions": {m: r.fit.k1 for m, r in rep.results.items()},
        }
    camp.store.close()
    return out


@pytest.fixture(scope="module")
def regime_map(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_SYNTH_MEASURE", BASE_S)
    try:
        return sweep_regime_map(
            str(tmp_path_factory.mktemp("regimes") / "regimes.jsonl"))
    finally:
        mp.undo()


def test_verdict_flips_at_the_pinned_transition(regime_map):
    labels = [(cell["q"], cell["label"]) for cell in regime_map.values()]
    assert [q for q, _ in labels] == list(QS)
    flips = [q for q, label in labels if label == "l1"]
    assert flips, "the sweep never reached the LSU regime"
    assert flips[0] == TRANSITION_Q
    assert flips == [q for q, _ in labels if q >= TRANSITION_Q]
    assert labels[0][1] == "compute"
    assert {label for q, label in labels
            if 0.0 < q < TRANSITION_Q} == {"mixed"}


def test_regime_map_matches_the_references_golden(regime_map):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert list(regime_map) == list(golden)
    for region, want in golden.items():
        got = regime_map[region]
        assert got["label"] == want["label"], region
        assert got["q"] == pytest.approx(want["q"]), region
        assert got["confidence"] == pytest.approx(want["confidence"]), region
        assert set(got["absorptions"]) == set(want["absorptions"]), region
        for mode, k1 in want["absorptions"].items():
            assert got["absorptions"][mode] == pytest.approx(k1), \
                f"{region}/{mode}"


def test_regime_sweep_replays_deterministically(regime_map, tmp_path,
                                                monkeypatch):
    """A fresh store reproduces the map exactly, and a second pass over the
    same store replays it with no measurement."""
    from repro_torch.core.campaign import Campaign
    from repro_torch.core.controller import Controller

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", BASE_S)
    path = str(tmp_path / "again.jsonl")
    assert sweep_regime_map(path) == regime_map
    camp = Campaign(path, Controller(reps=2, verify_payload=False))
    for _, target in _forced_family():
        camp.characterize(target, ["fp", "vmem"])
    camp.store.close()
    assert camp.stats.measured == 0 and camp.stats.cached > 0
