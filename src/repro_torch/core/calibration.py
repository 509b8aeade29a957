"""Threshold calibration campaigns: fit per-hardware LOW/HIGH from
known-regime synthetic sweeps.

The classifier's LOW/HIGH constants are the paper's defaults (§3.2 suggests
~20-30 instructions as the core-vs-data-access tipping point), but the right
cut depends on the machine under test. This module measures it: a fleet of
KNOWN-REGIME kernels — compute-, bandwidth-, latency- and overlap-shaped
targets built from the stream-triad loop region with their regimes FORCED
through the deterministic synthetic clock (``core.absorption``'s
``SynthShape`` marker) — sweeps under the ordinary campaign machinery, and
the fitted Abs^raw values are separated into per-role clusters:

  sat   the mode the regime saturates: absorption must land at ~0
  mid   partial absorption (the latency signature's memory mode)
  high  deep absorption: the mode the regime leaves slack on

``fit_thresholds`` then places LOW and HIGH at the max-margin midpoints
between adjacent clusters (Pareto-style separation maximization: each
threshold maximizes its distance to BOTH neighbouring clusters), falling
back to the paper defaults whenever the clusters fail to separate. The
result persists as a ``calib`` record in the CampaignStore — keyed by
hardware config, superseded like any other record kind — and
``resolve_thresholds`` threads it into every ``classify`` call site
(``Campaign`` and the fleet executor).

PyTorch port of the reference's ``repro.core.calibration``; the records,
the regimes and the fit are the reference's, so a store calibrated by
either package classifies the same under both. ``hw_name`` keys a record
by the card's name (``torch.cuda.get_device_name``), or "cpu".

Calibration is definitionally synthetic: the forced regimes are clock
shapes, not real kernel behaviour, so ``run_calibration`` refuses to run
without ``REPRO_SYNTH_MEASURE`` (the ``fleet calibrate`` CLI sets it).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import logging

from repro_torch.core.absorption import SYNTH_MEASURE_VAR, SynthShape
from repro_torch.core.classifier import HIGH, LOW, classify

log = logging.getLogger("repro_torch.calibration")

#: the loop-vocabulary modes every calibration regime sweeps
CALIB_MODES = ("fp_add", "l1_ld", "mem_ld")

#: default synthetic base time (seconds) the CLI exports when the synth
#: clock is not already configured
DEFAULT_BASE_S = "1e-3"

# The three cluster roles as clock shapes. Knees are what the hinge fit
# recovers as Abs^raw; slopes are chosen so the sensitivity probe routes
# each role onto a k-grid that samples its knee well (sat/mid: the fine
# grid; high: the robust far grid).
_SAT0 = SynthShape(knee=0.0, slope=0.3)     # saturated from the first pattern
_SAT = SynthShape(knee=1.0, slope=0.3)      # saturated almost immediately
_MID = SynthShape(knee=8.0, slope=0.2)      # partial absorption
_HIGHK = SynthShape(knee=24.0, slope=0.2)   # deep absorption (clear slack)

#: regime name -> {mode: (cluster role, forced clock shape)}. Every regime
#: shapes ALL of CALIB_MODES (a fleet TargetSpec shares one mode list across
#: its regions), with roles arranged so the default strategy tree assigns
#: each regime its eponymous label under both default and fitted thresholds.
REGIMES: dict[str, dict[str, tuple[str, SynthShape]]] = {
    # fp noise hurts immediately; data-access noise is absorbed deep
    "calib_compute": {"fp_add": ("sat", _SAT0), "l1_ld": ("high", _HIGHK),
                      "mem_ld": ("high", _HIGHK)},
    # memory-stream noise not absorbed while fp absorbs deep (l1 mid keeps
    # the bandwidth node's "l1 > low" guard honest)
    "calib_bandwidth": {"fp_add": ("high", _HIGHK), "l1_ld": ("mid", _MID),
                        "mem_ld": ("sat", _SAT)},
    # substantial-but-partial memory absorption with fp slack
    "calib_latency": {"fp_add": ("high", _HIGHK), "l1_ld": ("high", _HIGHK),
                      "mem_ld": ("mid", _MID)},
    # nothing absorbs: every resource saturated (Table 3 case 3)
    "calib_overlap": {"fp_add": ("sat", _SAT), "l1_ld": ("sat", _SAT),
                      "mem_ld": ("sat", _SAT)},
}

#: the label each regime must classify as — the calibration's ground truth
EXPECTED = {"calib_compute": "compute", "calib_bandwidth": "bandwidth",
            "calib_latency": "latency", "calib_overlap": "overlap"}

#: regime (== region) names in declaration order, for cheap grid queries
REGIME_NAMES = tuple(REGIMES)


def forced_regime(base, name: str, shapes: dict) -> "object":
    """Wrap a RegionTarget so each mode's sweep runs under a forced
    synthetic-clock shape.

    ``shapes`` maps mode -> SynthShape; the wrapper appends the mode's
    marker to the measured argument tuple (where the synthetic clock scans
    for it) and strips it again before invoking the real callable, so the
    target stays runnable under a real clock — the markers only matter when
    ``REPRO_SYNTH_MEASURE`` is set. Payload verification is skipped (the
    noise payload is irrelevant to a clock-shaped sweep)."""
    from repro_torch.core.controller import RegionTarget

    def _strip(args: tuple) -> tuple:
        return tuple(a for a in args if not isinstance(a, SynthShape))

    def build(mode: str, k: int):
        inner = base.build(mode, k)

        def fn(*args):
            return inner(*_strip(args))
        return fn

    def args_for(mode: str, k: int) -> tuple:
        args = base.args_for(mode, k)
        shape = shapes.get(mode)
        return args if shape is None else (*args, shape)

    def build_rt(mode: str):
        inner = base.build_rt(mode) if base.build_rt is not None else None
        if inner is None:
            return None

        def fn(k, *args):
            return inner(k, *_strip(args))
        return fn

    def args_for_rt(mode: str) -> tuple:
        args = base.args_for_rt(mode)
        shape = shapes.get(mode)
        return args if shape is None else (*args, shape)

    return RegionTarget(name=name, build=build, args_for=args_for,
                        body_size=base.body_size, build_rt=build_rt,
                        args_for_rt=args_for_rt,
                        payload_check=lambda mode, k: None,
                        audit_hint=base.audit_hint, sass=base.sass)


def calibrate_targets(*, n: int = 4096, chunk: int = 512,
                      device="cuda") -> list:
    """The four known-regime RegionTargets (one per ``REGIMES`` entry), each
    a small stream-triad loop region with its regime's clock shapes forced.
    ``n``/``chunk`` size the underlying buffers — the defaults are tiny
    because under the synthetic clock the kernel never actually runs;
    ``device``: where the buffers live ("cuda" or "cpu")."""
    from repro_torch.bench.kernels import stream_region

    out = []
    for name, spec in REGIMES.items():
        base = stream_region(n=n, chunk=chunk, device=device)
        out.append(forced_regime(base, name,
                                 {m: shape for m, (_, shape) in spec.items()}))
    return out


def fit_thresholds(samples: Sequence[dict], *, default_low: float = LOW,
                   default_high: float = HIGH) -> tuple[float, float, bool]:
    """Fit (low, high, fitted) from calibration samples.

    ``samples`` is a list of ``{"region", "mode", "role", "k1"}`` dicts
    (the ``calib`` record's payload). LOW lands at the midpoint between the
    sat cluster's maximum and the mid∪high clusters' minimum; HIGH at the
    midpoint between the sat∪mid maximum and the high cluster's minimum —
    the max-margin (Pareto-style separation-maximizing) cuts. Whenever the
    clusters overlap, a boundary cluster is empty, or the cuts invert, the
    paper defaults come back with ``fitted=False``."""
    sats = [float(s["k1"]) for s in samples if s.get("role") == "sat"]
    mids = [float(s["k1"]) for s in samples if s.get("role") == "mid"]
    highs = [float(s["k1"]) for s in samples if s.get("role") == "high"]
    if not sats or not highs:
        log.warning("calibration saw no %s samples; keeping paper defaults",
                    "sat" if not sats else "high")
        return default_low, default_high, False
    upper = mids + highs
    lower = sats + mids
    low = (max(sats) + min(upper)) / 2.0
    high = (max(lower) + min(highs)) / 2.0
    if not (max(sats) < min(upper) and max(lower) < min(highs)
            and low < high):
        log.warning(
            "calibration regimes do not separate (sat<=%.3g, mid=%s, "
            "high>=%.3g); keeping paper defaults", max(sats),
            [round(m, 3) for m in sorted(mids)], min(highs))
        return default_low, default_high, False
    return low, high, True


def hw_name() -> str:
    """The hardware-config key a ``calib`` record is stored under: the
    card's name (``torch.cuda.get_device_name``), or "cpu" without one."""
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def resolve_thresholds(store, hw: Optional[str] = None
                       ) -> tuple[float, float, str]:
    """The effective (low, high, provenance) for classifications replayed
    from ``store``.

    Provenance is ``"default"`` (no calib record for this hardware),
    ``"calibrated"`` (a fitted record), or ``"fallback"`` (a record whose
    fit fell back to the paper defaults). Stores without any calib record
    never ask for the hardware's name — the common path stays cheap."""
    calib = getattr(store, "calib", None)
    if not calib:
        return LOW, HIGH, "default"
    rec = calib.get(hw if hw is not None else hw_name())
    if rec is None:
        return LOW, HIGH, "default"
    if not rec.get("fitted"):
        return LOW, HIGH, "fallback"
    return float(rec["low"]), float(rec["high"]), "calibrated"


@dataclasses.dataclass
class CalibrationResult:
    """What ``run_calibration`` produced: the fitted thresholds, the raw
    per-(region, mode) samples behind them, and each regime's RegionReport
    re-classified UNDER the fitted thresholds."""
    hw: str
    low: float
    high: float
    fitted: bool
    samples: list
    reports: dict
    stats: "object"

    def correct(self) -> bool:
        """True when every known-regime kernel classified as its expected
        label under the fitted thresholds."""
        return all(rep.bottleneck.label == EXPECTED[name]
                   for name, rep in self.reports.items())


def run_calibration(store, *, reps: int = 2, workers: int = 1,
                    n: int = 4096, chunk: int = 512,
                    device="cuda") -> CalibrationResult:
    """Run (or replay) the known-regime calibration campaign into ``store``
    and persist the fitted thresholds as a ``calib`` record.

    Sweeps every ``REGIMES`` region over ``CALIB_MODES`` through the
    ordinary ``Campaign`` machinery (so a completed store REPLAYS with zero
    measurements), fits thresholds from the per-role Abs^raw clusters, and
    appends one ``calib`` record keyed by ``hw_name()``. Raises
    ``RuntimeError`` when the deterministic synthetic clock is off — forced
    regimes are meaningless under a real clock."""
    if not os.environ.get(SYNTH_MEASURE_VAR):
        raise RuntimeError(
            "calibration needs the deterministic synthetic clock: set "
            f"{SYNTH_MEASURE_VAR} (e.g. {DEFAULT_BASE_S}) or run via "
            "`python -m repro_torch.fleet calibrate run`, which sets it")
    from repro_torch.core.campaign import Campaign, CampaignStore
    from repro_torch.core.controller import Controller

    opened = isinstance(store, str)
    ctl = Controller(reps=reps, verify_payload=False)
    camp = Campaign(store if not opened else CampaignStore(store), ctl,
                    workers=workers)
    try:
        samples: list[dict] = []
        reports: dict = {}
        for target in calibrate_targets(n=n, chunk=chunk, device=device):
            rep = camp.characterize(target, list(CALIB_MODES))
            for mode in CALIB_MODES:
                role = REGIMES[target.name][mode][0]
                samples.append({"region": target.name, "mode": mode,
                                "role": role,
                                "k1": float(rep.results[mode].fit.k1)})
            reports[target.name] = rep
        low, high, fitted = fit_thresholds(samples)
        hw = hw_name()
        camp.store.append({"kind": "calib", "hw": hw, "low": low,
                           "high": high, "fitted": fitted, "reps": reps,
                           "samples": samples})
        for name, rep in reports.items():
            bott = classify({m: r.fit.k1 for m, r in rep.results.items()},
                            low=low, high=high)
            reports[name] = dataclasses.replace(rep, bottleneck=bott)
        return CalibrationResult(hw=hw, low=low, high=high, fitted=fitted,
                                 samples=samples, reports=reports,
                                 stats=camp.stats)
    finally:
        if opened:
            camp.store.close()
