"""Measurement-quality policy: valid / re-measure / quarantine decisions.

The paper's classification rests on trusting small t(k)/t(0) deltas, so a
measurement that cannot be trusted must not flow unmarked into a curve.
This module is the single place that decides what "cannot be trusted"
means at runtime (the reference's audit pass is the static counterpart):

  * ``QualityPolicy`` — thresholds: relative spread across reps, the
    timer-resolution floor, sentinel cadence/tolerance for mid-sweep
    baseline drift, and the per-point watchdog deadline.
  * ``RemeasureBudget`` — bounded extra reps: a noisy sample earns a few
    more repetitions before it is condemned, never unbounded retries.
  * ``decide(sample, policy)`` — the valid / re-measure / quarantine
    decision table over a :class:`repro_torch.core.absorption.Sample`.
  * ``measure_quality(...)`` — the re-measure loop: merge extra reps into
    the sample until the spread stabilizes or the budget is exhausted.

Quarantine reasons are a closed vocabulary (``REASONS``) so stores,
``fleet doctor`` and the classifier agree on *why* a point was rejected:

  * ``timer_floor`` — the time is below the trustworthy timer resolution;
  * ``spread``      — rep dispersion stayed above ``max_spread`` after the
                      re-measure budget;
  * ``drift_span``  — a baseline sentinel moved more than ``sentinel_tol``,
                      invalidating the span since the previous sentinel;
  * ``timeout``     — the watchdog deadline expired (hung kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.absorption import Sample

# closed quarantine-reason vocabulary (stores / doctor / classifier share it)
REASON_TIMER_FLOOR = "timer_floor"
REASON_SPREAD = "spread"
REASON_DRIFT_SPAN = "drift_span"
REASON_TIMEOUT = "timeout"
REASONS = (REASON_TIMER_FLOOR, REASON_SPREAD, REASON_DRIFT_SPAN,
           REASON_TIMEOUT)

VERDICT_VALID = "valid"
VERDICT_REMEASURE = "remeasure"
VERDICT_QUARANTINE = "quarantine"


@dataclass(frozen=True)
class QualityPolicy:
    """Thresholds for the runtime measurement-integrity guard.

    ``sentinel_every`` and ``watchdog_floor_s`` default to 0 = off, so a
    policy-less campaign behaves exactly like the pre-guard code path.
    """
    max_spread: float = 0.15        # max relative (max-min)/min across reps
    timer_floor_s: float = 1e-8     # below this, the timer itself is noise
    sentinel_every: int = 0         # re-time k=0 every N points (0 = off)
    sentinel_tol: float = 0.25      # baseline may move this much, relatively
    watchdog_margin: float = 8.0    # deadline = margin * expected worst time
    watchdog_floor_s: float = 0.0   # minimum deadline; 0 disables watchdog

    def __post_init__(self) -> None:
        if self.max_spread <= 0:
            raise ValueError(f"max_spread must be > 0, got {self.max_spread}")
        if self.timer_floor_s < 0:
            raise ValueError("timer_floor_s must be >= 0, got "
                             f"{self.timer_floor_s}")
        if self.sentinel_every < 0:
            raise ValueError("sentinel_every must be >= 0, got "
                             f"{self.sentinel_every}")
        if self.sentinel_tol <= 0:
            raise ValueError("sentinel_tol must be > 0, got "
                             f"{self.sentinel_tol}")
        if self.watchdog_margin <= 0:
            raise ValueError("watchdog_margin must be > 0, got "
                             f"{self.watchdog_margin}")
        if self.watchdog_floor_s < 0:
            raise ValueError("watchdog_floor_s must be >= 0, got "
                             f"{self.watchdog_floor_s}")

    @property
    def watchdog_on(self) -> bool:
        return self.watchdog_floor_s > 0

    def deadline(self, t0: Optional[float], *, stop_ratio: float,
                 reps: int, warmup: int = 0, inner: int = 1
                 ) -> Optional[float]:
        """Per-point watchdog deadline in seconds, or None when off.

        Derived from the worst time the online stop rule would accept —
        ``stop_ratio * t(0)`` per call, across every warmup+rep call —
        scaled by ``watchdog_margin``.  Before t(0) is known (the k=0
        point itself) only the floor applies.
        """
        if not self.watchdog_on:
            return None
        if t0 is None:
            return self.watchdog_floor_s
        calls = max(1, warmup + reps) * max(1, inner)
        return max(self.watchdog_floor_s,
                   self.watchdog_margin * stop_ratio * t0 * calls)

    def to_dict(self) -> dict:
        return {"max_spread": self.max_spread,
                "timer_floor_s": self.timer_floor_s,
                "sentinel_every": self.sentinel_every,
                "sentinel_tol": self.sentinel_tol,
                "watchdog_margin": self.watchdog_margin,
                "watchdog_floor_s": self.watchdog_floor_s}


@dataclass(frozen=True)
class RemeasureBudget:
    """Bounded re-measurement: how much extra timing a noisy point earns
    before quarantine.  ``max_total_reps`` caps the merged sample so a
    pathological clock cannot consume unbounded wall time."""
    max_attempts: int = 2       # extra measure rounds beyond the first
    extra_reps: int = 3         # reps per extra round
    max_total_reps: int = 12    # hard cap on merged sample size

    def __post_init__(self) -> None:
        if self.max_attempts < 0:
            raise ValueError("max_attempts must be >= 0, got "
                             f"{self.max_attempts}")
        if self.extra_reps < 1:
            raise ValueError(f"extra_reps must be >= 1, got "
                             f"{self.extra_reps}")
        if self.max_total_reps < 1:
            raise ValueError("max_total_reps must be >= 1, got "
                             f"{self.max_total_reps}")

    def to_dict(self) -> dict:
        return {"max_attempts": self.max_attempts,
                "extra_reps": self.extra_reps,
                "max_total_reps": self.max_total_reps}


def decide(sample: Sample, policy: QualityPolicy, *,
           can_remeasure: bool = True) -> tuple[str, Optional[str]]:
    """The decision table: (verdict, reason).

    ``timer_floor`` wins over everything (more reps cannot fix a timer);
    an in-tolerance spread is ``valid``; an out-of-tolerance spread is
    ``remeasure`` while budget remains, else ``quarantine``.
    """
    if sample.t < policy.timer_floor_s:
        return VERDICT_QUARANTINE, REASON_TIMER_FLOOR
    if sample.spread <= policy.max_spread:
        return VERDICT_VALID, None
    if can_remeasure:
        return VERDICT_REMEASURE, None
    return VERDICT_QUARANTINE, REASON_SPREAD


def measure_quality(measure_once: Callable[[int], Sample], *, reps: int,
                    policy: QualityPolicy,
                    budget: Optional[RemeasureBudget] = None
                    ) -> tuple[Sample, str, Optional[str]]:
    """Measure one point under the policy: time it, and while the spread
    verdict is ``remeasure``, take ``budget.extra_reps`` more timings.

    The spread verdict is judged on the LATEST round alone: transient
    interference during one round is exactly what re-measurement forgives,
    and a clean later round vindicates the point. The returned sample is
    the MERGE of every round (its min is the best-supported time), so a
    vindicated point still benefits from all the timings taken. The
    timer-floor check uses the merged minimum — more reps cannot fix a
    timer, so a sub-floor time quarantines immediately.

    ``measure_once(n)`` must return a fresh :class:`Sample` of n reps.
    Returns ``(sample, verdict, reason)`` where verdict is ``valid`` or
    ``quarantine`` (never ``remeasure`` — the loop resolves it).
    """
    budget = budget or RemeasureBudget()
    sample = latest = measure_once(reps)
    attempts = 0
    while True:
        if sample.t < policy.timer_floor_s:
            return sample, VERDICT_QUARANTINE, REASON_TIMER_FLOOR
        if latest.spread <= policy.max_spread:
            return sample, VERDICT_VALID, None
        extra = min(budget.extra_reps,
                    budget.max_total_reps - len(sample.reps))
        # a 1-rep round has zero spread by construction and would vindicate
        # anything — if that's all the budget leaves, the point is condemned
        if attempts >= budget.max_attempts or extra < 2:
            return sample, VERDICT_QUARANTINE, REASON_SPREAD
        latest = measure_once(extra)
        sample = sample.merged(latest)
        attempts += 1


_POLICY_KEYS = frozenset(QualityPolicy().to_dict())
_BUDGET_KEYS = frozenset(RemeasureBudget().to_dict())


def quality_from_dict(d: dict) -> tuple[QualityPolicy, RemeasureBudget]:
    """Build (policy, budget) from one flat dict — the shape a SweepPlan's
    ``quality`` field and ``--quality-policy`` carry.  Unknown keys are an
    error: a typoed threshold silently ignored is a policy not applied."""
    if not isinstance(d, dict):
        raise ValueError(f"quality policy must be a dict, got {type(d).__name__}")
    unknown = sorted(set(d) - _POLICY_KEYS - _BUDGET_KEYS)
    if unknown:
        raise ValueError(
            "unknown quality key(s) " + ", ".join(unknown) + "; policy keys: "
            + ", ".join(sorted(_POLICY_KEYS)) + "; budget keys: "
            + ", ".join(sorted(_BUDGET_KEYS)))
    try:
        policy = QualityPolicy(**{k: d[k] for k in d if k in _POLICY_KEYS})
        budget = RemeasureBudget(**{k: d[k] for k in d if k in _BUDGET_KEYS})
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad quality policy: {e}")
    return policy, budget
