"""Bottleneck classification from absorption signatures.

Encodes the paper's decision logic (§4.2 validation + Table 3):

  - compute-bound   : fp absorption ~ 0, data-access absorption high (HACCmk)
  - bandwidth-bound : memory-stream absorption ~ 0 even though fp/l1 absorb
                      a lot (parallel STREAM)
  - latency-bound   : absorbs *substantial* memory noise (the STREAM vs
                      lat_mem_rd distinction) and large fp noise
  - full-overlap    : ALL absorptions ~ 0 (Table 3 case 3) — every resource
                      saturated; distinguish from a frontend-style shared
                      bottleneck with the DECAN cross-check (case 4, Fig. 6)
  - ici-bound       : collective-noise absorption ~ 0 (our TPU extension)

Thresholds are in *patterns* and deliberately coarse — the paper reads the
signature shape, not exact values; §3.2 suggests ~20–30 instructions as the
tipping point between "core-level" and "data-access" codes. ``LOW``/``HIGH``
below are the paper DEFAULTS; a calibration campaign
(the reference's ``repro.core.calibration``, not yet ported) fits
per-hardware replacements from known-regime sweeps.

The decision logic itself lives in a declarative strategy tree
(``strategies/default.yaml`` via ``repro_torch.core.strategy``) — ``classify``
resolves the tree, and the report carries the evaluated decision path for
``fleet doctor --explain``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.core import strategy as strategy_mod

LOW = 4.0       # <= LOW patterns: the targeted resource is saturated
HIGH = 20.0     # >= HIGH patterns: clearly unsaturated (paper §3.2: 20-30)


@dataclasses.dataclass
class BottleneckReport:
    label: str                       # compute|bandwidth|latency|ici|overlap|mixed
    confidence: float                # 0..1, separation-based
    absorptions: dict[str, float]    # mode -> Abs^raw (or Abs^rel * scale)
    explanation: str
    decan_hint: Optional[str] = None  # set by the DECAN cross-check
    # static audit evidence per mode (apply_audit_evidence); None = no audit
    evidence: Optional[list] = None
    # runtime measurement-quality evidence per mode (apply_quality_evidence);
    # None = no quality guard ran
    quality: Optional[list] = None
    # the strategy tree's evaluated decision path (which nodes were tried,
    # which fired, under which thresholds) — NOT serialized into report
    # JSON / __str__ (byte-identity with pre-tree reports); rendered by
    # fleet doctor --explain
    path: Optional[dict] = None

    def __str__(self) -> str:
        abss = ", ".join(f"{m}={a:.1f}" for m, a in self.absorptions.items())
        s = f"[{self.label} | conf={self.confidence:.2f}] {self.explanation} ({abss})"
        if self.decan_hint:
            s += f" | DECAN: {self.decan_hint}"
        if self.evidence is not None:
            n_sup = sum(1 for e in self.evidence if e["supports"])
            s += f" | audit: {n_sup}/{len(self.evidence)} mode(s) support"
        if self.quality is not None:
            n_clean = sum(1 for q in self.quality if not q["quarantined"])
            s += f" | quality: {n_clean}/{len(self.quality)} mode(s) clean"
        return s


def classify(absorptions: Mapping[str, float], *, low: float = LOW,
             high: float = HIGH,
             tree: Optional["strategy_mod.StrategyTree"] = None,
             ) -> BottleneckReport:
    """Map {mode: absorption} to a bottleneck class.

    Mode names accept loop-level (fp_add/l1_ld/mem_ld/chase), graph-level
    (fp_add32/mxu_fma128/vmem_ld/hbm_stream/hbm_latency/ici_*) and Pallas
    kernel-level (fp/mxu/vmem — repro_torch.kernels.noise_slots) vocabularies,
    plus the paper aliases.

    The decision is delegated to a strategy tree (``tree``, defaulting to
    ``strategies/default.yaml``); ``low``/``high`` are the effective
    thresholds — pass a calibration's fitted values to classify under them
    (confidence is normalized by the *effective* ``high``, never the module
    default). The returned report's ``path`` records the evaluated
    decision path.
    """
    t = tree if tree is not None else strategy_mod.default_tree()
    d = t.decide(absorptions, low=low, high=high)
    return BottleneckReport(d.label, d.confidence, dict(absorptions),
                            d.explanation, path=d.path)


def apply_audit_evidence(report: BottleneckReport,
                         audits: Mapping[str, Mapping],
                         *, downgrade: float = 0.6) -> BottleneckReport:
    """Annotate a classification with static audit evidence
    (``repro.analysis`` records, one per audited mode).

    A mode SUPPORTS the label when its noise survived compilation intact
    and the audit's predicted sensitivity direction matches the mode's
    declared target — the absorption reading measured what the classifier
    assumed it measured. A mode whose payload died or degraded, or whose
    surviving instructions pressure a different resource, CONFLICTS: its
    reading is structurally suspect, and each conflicting mode multiplies
    the confidence by ``downgrade``.

    Deterministic and measurement-free: two runs over the same store attach
    byte-identical evidence.
    """
    if not audits:
        return report
    evidence = []
    conf = report.confidence
    for mode in sorted(audits):
        rec = audits[mode]
        supports = (rec.get("verdict") == "intact"
                    and rec.get("agrees") is not False)
        evidence.append({
            "mode": mode,
            "verdict": rec.get("verdict"),
            "survival": rec.get("survival"),
            "predicted": rec.get("predicted"),
            "target": rec.get("target"),
            "corruption": rec.get("corruption"),
            "supports": supports,
        })
        if not supports:
            conf *= downgrade
    return dataclasses.replace(report, confidence=conf, evidence=evidence)


UNRELIABLE = "unreliable"    # the refused label: measurements can't back one


def apply_quality_evidence(report: BottleneckReport,
                           quality: Mapping[str, Mapping],
                           *, downgrade: float = 0.6,
                           majority: float = 0.5) -> BottleneckReport:
    """Annotate a classification with runtime measurement-quality evidence
    (the quality records a guarded campaign persisted, aggregated per mode
    as ``{"points": n, "quarantined": n, "reasons": {reason: count}}``).

    The mirror of ``apply_audit_evidence`` for *dynamic* validity: a mode
    with any quarantined points is suspect (its curve was fit through
    condemned measurements) and multiplies the confidence by ``downgrade``;
    a mode whose points are MAJORITY-quarantined (> ``majority`` of them)
    cannot back any label at all — the report's label is refused and
    replaced with ``unreliable`` at confidence 0, naming the condemned
    modes and the dominant quarantine reasons.

    Deterministic and measurement-free: two runs over the same store attach
    byte-identical evidence.
    """
    if not quality:
        return report
    evidence = []
    refused = []
    conf = report.confidence
    for mode in sorted(quality):
        rec = quality[mode]
        points = int(rec.get("points", 0))
        quarantined = int(rec.get("quarantined", 0))
        reasons = dict(rec.get("reasons", {}))
        evidence.append({"mode": mode, "points": points,
                         "quarantined": quarantined, "reasons": reasons})
        if quarantined:
            conf *= downgrade
        if points and quarantined / points > majority:
            why = ", ".join(sorted(reasons, key=lambda r: (-reasons[r], r)))
            refused.append(f"{mode} ({quarantined}/{points} point(s) "
                           f"quarantined: {why})")
    if refused:
        return dataclasses.replace(
            report, label=UNRELIABLE, confidence=0.0, quality=evidence,
            explanation="measurement quality refuses a label — majority-"
                        "quarantined curve(s): " + "; ".join(refused)
                        + " (re-measure under a quieter clock, e.g. "
                        "fleet run --resume)")
    return dataclasses.replace(report, confidence=conf, quality=evidence)
