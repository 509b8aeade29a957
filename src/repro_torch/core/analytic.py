"""Analytic saturation model — absorption prediction from roofline terms.

PyTorch port of the reference's model (``repro.core.analytic``): pure
Python on floats, the same formulas, so both packages predict the same
absorptions for the same ``StepTerms`` and ``HardwareConfig`` values. A
step's per-resource busy times T_r (compute / memory / ici / serial
latency) and a noise mode's per-pattern cost d_r give

    t(k) = alpha * max_r(T_r + k * d_r)  +  (1 - alpha) * sum_r(T_r + k * d_r)

with alpha the overlap coefficient (1 = perfect overlap; 0 = fully
serial). Absorption is the knee:

    Abs^raw = max k such that t(k) <= (1 + tol) * t(0)

With alpha = 1 this reduces to Abs = (T_dom - T_tau) / d_tau —
*absorption == slack of the targeted resource measured in noise
patterns*, which is what the paper estimates empirically. The same model
answers the paper's Table-4 question ("HBM or DDR for this kernel?") by
re-evaluating T_r under another ``HardwareConfig``
(``repro_torch.configs.base``: the H100 SXM and a DDR-class point).

Predictions persist: ``core.campaign.AnalyticCampaign`` runs these
functions through the campaign store ("pred" records carrying the
HardwareConfig, these StepTerms and every model setting), so predicted
curves live in the same artifact as measured ones and replay
byte-identically.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.configs.base import HardwareConfig
from repro_torch.core.absorption import AbsorptionFit
from repro_torch.core.noise import NoiseMode, PatternCost

RESOURCES = ("compute", "memory", "ici", "latency")


@dataclasses.dataclass(frozen=True)
class StepTerms:
    """Per-step busy seconds of each resource on ONE chip (roofline terms)."""
    compute: float
    memory: float
    ici: float = 0.0
    latency: float = 0.0

    def as_dict(self) -> dict[str, float]:
        return {r: getattr(self, r) for r in RESOURCES}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "StepTerms":
        """Inverse of ``as_dict`` — reconstructs the terms a campaign
        ``pred`` record was computed from (its ``"terms"`` field)."""
        return cls(**{r: float(d.get(r, 0.0)) for r in RESOURCES})

    @property
    def dominant(self) -> str:
        d = self.as_dict()
        return max(d, key=d.get)

    def bound(self, alpha: float = 1.0) -> float:
        """Modeled step time (seconds)."""
        vals = list(self.as_dict().values())
        return alpha * max(vals) + (1 - alpha) * sum(vals)


def pattern_deltas(mode: NoiseMode, hw: HardwareConfig) -> dict[str, float]:
    cost: PatternCost = mode.pattern_cost(hw)
    return cost.time_on(hw)


def predict_time(terms: StepTerms, deltas: Mapping[str, float], k: float,
                 *, alpha: float = 1.0) -> float:
    vals = [terms.as_dict()[r] + k * deltas.get(r, 0.0) for r in RESOURCES]
    return alpha * max(vals) + (1 - alpha) * sum(vals)


def predict_absorption(terms: StepTerms, mode: NoiseMode, hw: HardwareConfig,
                       *, tol: float = 0.05, alpha: float = 1.0,
                       k_max: int = 1 << 20) -> AbsorptionFit:
    """Closed-form-ish absorption: binary search on the piecewise-linear t(k)."""
    deltas = pattern_deltas(mode, hw)
    t0 = predict_time(terms, deltas, 0, alpha=alpha)
    limit = (1 + tol) * t0
    if predict_time(terms, deltas, 1, alpha=alpha) > limit:
        k1 = 0.0
    elif predict_time(terms, deltas, k_max, alpha=alpha) <= limit:
        k1 = float(k_max)  # unbounded absorption at this scale
    else:
        lo, hi = 0, k_max
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if predict_time(terms, deltas, mid, alpha=alpha) <= limit:
                lo = mid
            else:
                hi = mid
        k1 = float(lo)

    # saturation slope: once noise dominates every resource it adds to the max
    slope = alpha * max(deltas.values()) + (1 - alpha) * sum(deltas.values())
    # k2: where the targeted resource becomes the global max
    tvals = terms.as_dict()
    dom = max(tvals, key=tvals.get)
    tgt = max(deltas, key=deltas.get)
    if deltas.get(tgt, 0) > 0 and tgt != dom:
        k2 = max(k1, (tvals[dom] - tvals[tgt]) / deltas[tgt])
    else:
        k2 = k1
    return AbsorptionFit(k1=k1, k2=k2, t0=t0, slope=slope, k1_threshold=k1,
                         sse=0.0, tol=tol)


def predict_curve(terms: StepTerms, mode: NoiseMode, hw: HardwareConfig,
                  ks, *, alpha: float = 1.0) -> np.ndarray:
    deltas = pattern_deltas(mode, hw)
    return np.asarray([predict_time(terms, deltas, k, alpha=alpha) for k in ks])


def compare_memory_systems(terms_by_hw: Mapping[str, StepTerms],
                           modes: Mapping[str, NoiseMode],
                           hws: Mapping[str, HardwareConfig],
                           *, tol: float = 0.05
                           ) -> dict[str, dict[str, float]]:
    """Paper Table 4: same kernel, different memory systems.

    Returns {hw_name: {"t_step": s, "<mode>": Abs, ...}} — the system with the
    smaller modeled step time *and* non-collapsed absorption profile is the
    better fit for the access pattern.
    """
    out: dict[str, dict[str, float]] = {}
    for hw_name, terms in terms_by_hw.items():
        hw = hws[hw_name]
        row: dict[str, float] = {"t_step": terms.bound()}
        for mname, mode in modes.items():
            row[mname] = predict_absorption(terms, mode, hw, tol=tol).k1
        out[hw_name] = row
    return out
