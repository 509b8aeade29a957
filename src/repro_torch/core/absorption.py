"""Absorption measurement: timing, noise sweeps, and the three-phase model fit.

The paper's idealized model (Fig. 2): run time is flat up to k1 (absorption
phase), degrades through a transient, and grows linearly past k2 (saturation).
``Abs_N^raw = k1``; footnote 1 says k1 is obtained by fitting the measured
series to the model — ``fit_three_phase`` does exactly that with a hinge fit,
cross-checked by a threshold rule. ``Abs^rel = k1 / |body|`` (Eq. 1–2)
renormalizes by the size of the original loop body.

PyTorch port of the reference's absorption module: identical clocks, sweep
and fit; timing synchronises the CUDA device a callable's outputs live on
(``torch.cuda.synchronize``) where the reference calls
``block_until_ready``. On the runtime-k path k is a plain Python ``int``
(the counterpart of the reference's scalar-prefetch operand).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

# Deterministic stand-in clock for orchestration tests and CI smoke: when this
# env var is set (to the baseline in seconds, e.g. "1e-3"), ``measure`` does
# not run or time anything — it returns a pure function of the noise quantity
# k (args[0], a plain int, on the runtime-k path), so independently-run processes produce
# byte-identical stores and classifications that can be compared exactly.
# Never set it for real measurements.
SYNTH_MEASURE_VAR = "REPRO_SYNTH_MEASURE"

# Deterministic perturbations of the synthetic clock, for driving the
# measurement-integrity guard in tests and CI (all inert unless
# REPRO_SYNTH_MEASURE is also set):
#   REPRO_SYNTH_JITTER=amp    rep r>0 of every sample reads
#                             t*(1 + amp*u(k, r)) with u a hash-derived
#                             uniform in [0, 1); rep 0 is always exactly t,
#                             so MIN-OF-REPS VALUES ARE UNCHANGED — only the
#                             spread inflates (jittered and clean runs yield
#                             byte-identical curves and reports).
#   REPRO_SYNTH_DRIFT=f@n     every sample after the n-th synthetic
#                             measurement in this process is multiplied by f
#                             (mid-sweep interference for sentinel tests).
#   REPRO_SYNTH_HANG=k1,k2    a measurement at one of these noise quantities
#                             blocks until release_synth_hang() (a hung
#                             kernel for watchdog tests).
SYNTH_JITTER_VAR = "REPRO_SYNTH_JITTER"
SYNTH_DRIFT_VAR = "REPRO_SYNTH_DRIFT"
SYNTH_HANG_VAR = "REPRO_SYNTH_HANG"

_SYNTH_CALLS = 0                      # samples taken (REPRO_SYNTH_DRIFT)
_SYNTH_HANG_RELEASE = threading.Event()


def reset_synth_state() -> None:
    """Reset the synthetic clock's process state (call counter, hang latch).
    Tests that use REPRO_SYNTH_DRIFT / REPRO_SYNTH_HANG call this so one
    test's synthetic history can't leak into the next."""
    global _SYNTH_CALLS
    _SYNTH_CALLS = 0
    _SYNTH_HANG_RELEASE.clear()


def release_synth_hang() -> None:
    """Unblock any measurement parked by REPRO_SYNTH_HANG (lets a test's
    timed-out daemon thread finish instead of sleeping forever)."""
    _SYNTH_HANG_RELEASE.set()


def _synth_k(args: tuple) -> int:
    """The runtime noise quantity: a leading plain ``int`` argument (bool is
    not a noise quantity), else 0 (static-k builds carry k in the callable)."""
    if args and isinstance(args[0], (int, np.integer)) \
            and not isinstance(args[0], bool):
        return int(args[0])
    return 0


@dataclasses.dataclass(frozen=True)
class SynthShape:
    """Marker that reshapes the synthetic clock for ONE measured callable.

    The default synthetic t(k) has a single knee at k=6 — every region and
    mode look alike, which is exactly wrong for calibration campaigns that
    need known-REGIME kernels (a compute-shaped target must saturate its fp
    mode immediately while absorbing l1 noise deep). A region appends a
    SynthShape to its runtime args (``args_for_rt``); the clock scans the
    argument tuple for it and moves the knee/slope accordingly. Regions
    must strip the marker before calling the real kernel (it is not an
    array), and absent a marker the clock is byte-identical to before."""
    knee: float = 6.0            # absorption Abs^raw the fit will recover
    slope: float = 0.05          # fractional slowdown per pattern past knee
    base_scale: float = 1.0      # scales the region's base time


def _synth_shape(args: tuple) -> "SynthShape | None":
    for a in args:
        if isinstance(a, SynthShape):
            return a
    return None


def _synth_time(args: tuple, base: float) -> float:
    """t(k) with a knee at k=6 — flat absorption then a linear ramp, enough
    structure for the fit/classifier to produce stable, non-trivial output.
    A ``SynthShape`` marker among the args overrides knee/slope/base (known-
    regime calibration kernels); without one the shape is unchanged."""
    shape = _synth_shape(args)
    if shape is None:
        return base * (1.0 + 0.05 * max(0, _synth_k(args) - 6))
    return base * shape.base_scale * (
        1.0 + shape.slope * max(0.0, _synth_k(args) - shape.knee))


def _synth_u(k: int, r: int) -> float:
    """Deterministic uniform in [0, 1) for rep ``r`` of noise quantity ``k``
    — hash-derived so every process, platform and run agrees."""
    h = hashlib.sha256(f"{k}:{r}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def _synth_sample(args: tuple, base: float, *, reps: int) -> "Sample":
    """One synthetic Sample: rep 0 is the exact model time (min-of-reps and
    therefore curves/reports are jitter-invariant); later reps may be
    inflated by REPRO_SYNTH_JITTER; REPRO_SYNTH_DRIFT scales whole samples
    after its call threshold; REPRO_SYNTH_HANG parks matching ks."""
    global _SYNTH_CALLS
    k = _synth_k(args)
    hang = os.environ.get(SYNTH_HANG_VAR)
    if hang and k in {int(p) for p in hang.split(",") if p.strip()}:
        while not _SYNTH_HANG_RELEASE.wait(0.01):
            pass
    t = _synth_time(args, base)
    _SYNTH_CALLS += 1
    drift_env = os.environ.get(SYNTH_DRIFT_VAR)
    if drift_env:
        factor_s, _, at_s = drift_env.partition("@")
        if _SYNTH_CALLS > int(at_s or 0):
            t *= float(factor_s)
    amp = float(os.environ.get(SYNTH_JITTER_VAR) or 0.0)
    vals = [t]
    for r in range(1, max(1, reps)):
        vals.append(t * (1.0 + amp * _synth_u(k, r)) if amp > 0.0 else t)
    return Sample(reps=tuple(vals))

# Coarse timers (or a fully cached call) can report 0.0 s; every ratio in this
# module divides by a baseline, so baselines are floored to one timer tick.
MIN_MEASURABLE_S = 1e-9

# floor_time fires at most once per distinct ``what`` — on a fast kernel every
# point of a series trips the floor and the repeated warning floods fleet logs.
_FLOOR_WARNED: set[str] = set()


def reset_floor_warnings() -> None:
    """Forget which series already warned about the timer floor (per-test
    isolation; also bounds the dedup set in long-lived processes)."""
    _FLOOR_WARNED.clear()


def floor_time(t: float, what: str = "baseline") -> float:
    """Clamp a measured time to the minimum measurable tick, with a warning —
    a 0.0 baseline otherwise poisons every downstream ratio (t/t0, drift).
    The warning is deduplicated per ``what`` (once per series, not per call)."""
    if t < MIN_MEASURABLE_S:
        if what not in _FLOOR_WARNED:
            _FLOOR_WARNED.add(what)
            warnings.warn(
                f"{what} measured {t:.3g}s, below the {MIN_MEASURABLE_S:.0e}s "
                "timer resolution; clamping (absorption ratios for this "
                "series are unreliable)", RuntimeWarning, stacklevel=2)
        return MIN_MEASURABLE_S
    return t


@dataclasses.dataclass(frozen=True)
class Sample:
    """All rep timings of one measured point, not just the min.

    ``measure`` still reports ``t`` (min-of-reps, the paper's estimator);
    the dispersion properties are what the quality policy gates on."""
    reps: tuple[float, ...]

    def __post_init__(self) -> None:
        if not self.reps:
            raise ValueError("Sample needs at least one rep")

    @property
    def t(self) -> float:
        """Min-of-reps — the noise-robust point estimate."""
        return min(self.reps)

    @property
    def spread(self) -> float:
        """Relative spread (max-min)/min — 0 for a perfectly quiet clock."""
        t = self.t
        return (max(self.reps) - t) / max(t, MIN_MEASURABLE_S)

    @property
    def mad(self) -> float:
        """Relative median absolute deviation — a spread estimate robust to
        a single outlier rep."""
        a = np.asarray(self.reps, np.float64)
        med = float(np.median(a))
        return float(np.median(np.abs(a - med))) / max(med, MIN_MEASURABLE_S)

    def merged(self, other: "Sample") -> "Sample":
        """The pooled sample after a re-measure round."""
        return Sample(reps=self.reps + other.reps)


class MeasureTimeout(RuntimeError):
    """A measurement exceeded its watchdog deadline (hung kernel)."""


def _cuda_devices(obj) -> set:
    """The CUDA devices of every tensor in a (nested) call result."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, (tuple, list)):
        return set().union(*(_cuda_devices(o) for o in obj))
    if isinstance(obj, dict):
        return set().union(*(_cuda_devices(o) for o in obj.values()))
    return set()


def _wait(out) -> None:
    """Block until the device work behind ``out`` has finished (kernels
    launch asynchronously); CPU results are complete on return."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def _measure_sample_inner(fn: Callable, args: tuple, *, reps: int,
                          warmup: int, inner: int) -> Sample:
    synth = os.environ.get(SYNTH_MEASURE_VAR)
    if synth:
        return _synth_sample(args, float(synth), reps=reps)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    vals = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        _wait(out)
        vals.append((time.perf_counter() - t0) / inner)
    return Sample(reps=tuple(vals))


def measure_sample(fn: Callable, args: tuple = (), *, reps: int = 5,
                   warmup: int = 2, inner: int = 1,
                   deadline: Optional[float] = None) -> Sample:
    """Time ``fn(*args)`` and keep every rep (compile excluded).

    With ``deadline`` (seconds), the measurement runs on a watchdog: if it
    has not finished by then, :class:`MeasureTimeout` is raised and the hung
    call is abandoned on a daemon thread — a stuck kernel becomes a recorded
    quarantine instead of a stuck process.
    """
    if deadline is None:
        return _measure_sample_inner(fn, args, reps=reps, warmup=warmup,
                                     inner=inner)
    box: dict[str, Any] = {}

    def _run() -> None:
        try:
            box["sample"] = _measure_sample_inner(fn, args, reps=reps,
                                                  warmup=warmup, inner=inner)
        except BaseException as e:          # re-raised on the caller's thread
            box["error"] = e

    th = threading.Thread(target=_run, daemon=True,
                          name="repro-measure-watchdog")
    th.start()
    th.join(deadline)
    if th.is_alive():
        raise MeasureTimeout(
            f"measurement still running after the {deadline:.3g}s watchdog "
            "deadline (hung kernel?); abandoning it")
    if "error" in box:
        raise box["error"]
    return box["sample"]


def measure(fn: Callable, args: tuple = (), *, reps: int = 5, warmup: int = 2,
            inner: int = 1, deadline: Optional[float] = None) -> float:
    """Best-of-``reps`` wall time of ``fn(*args)`` in seconds (compile excluded).

    ``inner`` repeats the call inside the timed region for very short kernels.
    Min-of-reps is the standard noise-robust estimator for dedicated machines.
    (``measure_sample`` is the dispersion-preserving form this wraps;
    ``deadline`` raises :class:`MeasureTimeout` the same way.)
    """
    return measure_sample(fn, args, reps=reps, warmup=warmup, inner=inner,
                          deadline=deadline).t


# ---------------------------------------------------------------------------
# Sweep with online saturation detection (paper §3.1)
# ---------------------------------------------------------------------------

DEFAULT_KS = (0, 1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

# online saturation rule: stop after this many consecutive points past
# stop_ratio×t0 (shared by sweep() and the campaign engine)
STOP_CONSECUTIVE = 2


def drift_corrected(ts: Sequence[float], drift: float) -> list[float]:
    """Two-point linear drift correction: the k=0 kernel re-timed after the
    sweep came out at ``drift``×t0, so divide a linear ramp out of the series.
    Implausible (>2× either way) or negligible (<2%) drift returns ``ts``
    unchanged — but an implausible factor is itself evidence of heavy
    interference, so it warns instead of being swallowed silently (the raw
    factor also lands in the campaign ``done`` record for ``fleet doctor``)."""
    if len(ts) < 3 or not (0.5 < drift < 2.0 and abs(drift - 1.0) > 0.02):
        if len(ts) >= 3 and not (0.5 < drift < 2.0):
            warnings.warn(
                f"baseline drift factor {drift:.3g} is implausible (outside "
                "0.5–2.0) — not correcting; the machine was likely under "
                "heavy interference during this sweep", RuntimeWarning,
                stacklevel=2)
        return list(ts)
    n = len(ts) - 1
    return [t / (1.0 + (drift - 1.0) * i / n) for i, t in enumerate(ts)]


@dataclasses.dataclass
class AbsorptionCurve:
    mode: str
    ks: list[int]
    ts: list[float]                  # seconds per k
    stopped_early: bool = False

    def ratios(self) -> np.ndarray:
        return np.asarray(self.ts) / floor_time(self.ts[0], "t(k=0) baseline")


def assemble_curve(mode: str, ks: Sequence[int], ts: Sequence[float], *,
                   drift: Optional[float] = None,
                   stopped_early: bool = False) -> AbsorptionCurve:
    """The ONE place a raw (ks, ts) series becomes an AbsorptionCurve.

    Campaign stores persist points RAW and re-apply the recorded drift factor
    here on every replay, so a replayed curve is byte-identical to the curve
    the original run assembled. The golden-signature regression suite pins
    this function's behaviour — change it and those tests fail loudly.
    """
    out = drift_corrected(ts, drift) if drift is not None else list(ts)
    return AbsorptionCurve(mode=mode, ks=list(ks), ts=out,
                           stopped_early=stopped_early)


def sweep(build: Callable[[int], Callable], *, mode: str = "",
          ks: Sequence[int] = DEFAULT_KS, args_for: Optional[Callable] = None,
          reps: int = 5, inner: int = 1, stop_ratio: float = 4.0,
          stop_consecutive: int = STOP_CONSECUTIVE,
          drift_correct: bool = True) -> AbsorptionCurve:
    """Measure t(k) for increasing noise quantities.

    ``build(k)`` returns the noisy callable; ``args_for(k)`` its args.
    Online saturation detection (paper §3.1): stop once ``stop_consecutive``
    successive points exceed ``stop_ratio``×t(0) — the tail is already in the
    linear regime and further points only cost experiment time.

    drift_correct: on shared/throttled machines the baseline drifts between
    builds; the k=0 kernel is re-timed after the sweep and a linear drift
    factor is divided out (two-point correction).
    """
    out_ks: list[int] = []
    out_ts: list[float] = []
    n_over = 0
    stopped = False
    base_fn = build(ks[0]) if drift_correct else None
    base_args = (args_for(ks[0]) if args_for else ()) if drift_correct else ()
    for k in ks:
        fn = build(k)
        a = args_for(k) if args_for else ()
        t = measure(fn, a, reps=reps, inner=inner)
        out_ks.append(k)
        out_ts.append(t)
        if t / floor_time(out_ts[0], f"sweep({mode}) t(k=0)") > stop_ratio:
            n_over += 1
            if n_over >= stop_consecutive:
                stopped = True
                break
        else:
            n_over = 0
    if drift_correct and len(out_ts) > 2:
        t0_end = measure(base_fn, base_args, reps=max(reps - 2, 2),
                         inner=inner)
        drift = t0_end / floor_time(out_ts[0], f"sweep({mode}) t(k=0)")
        out_ts = drift_corrected(out_ts, drift)
    return AbsorptionCurve(mode=mode, ks=out_ks, ts=out_ts, stopped_early=stopped)


# ---------------------------------------------------------------------------
# Three-phase fit (Fig. 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AbsorptionFit:
    k1: float                 # absorption — patterns absorbed for free
    k2: float                 # saturation onset — linear regime begins
    t0: float                 # baseline seconds
    slope: float              # seconds per pattern in the saturation regime
    k1_threshold: float       # cross-check: last k within (1+tol)·t0
    sse: float                # fit quality
    tol: float

    @property
    def raw(self) -> float:
        """Abs^raw — the paper's absorption metric."""
        return self.k1

    def rel(self, body_size: int) -> float:
        """Abs^rel = P̂(k1) = k1 / |l1.l2| (Eq. 1–2)."""
        return self.k1 / max(body_size, 1)


def _hinge_fit(ks: np.ndarray, ts: np.ndarray) -> tuple[float, float, float, float]:
    """Least-squares fit of t(k) = max(t0, t0 + s·(k − k1)).

    Grid over candidate knees (measured ks plus midpoints), closed-form t0/s
    per candidate. Returns (k1, t0, slope, sse).
    """
    # descending order: ties in SSE (e.g. a perfectly flat curve, where any
    # knee fits equally) resolve to the LARGEST k1 — "absorbed everywhere we
    # looked", matching the threshold reading.
    cand = sorted(set(list(ks) + [(a + b) / 2 for a, b in zip(ks[:-1], ks[1:])]),
                  reverse=True)
    best = (0.0, float(ts[0]), 0.0, float("inf"))
    for k1 in cand:
        flat = ks <= k1
        rise = ~flat
        t0 = ts[flat].mean() if flat.any() else float(ts[0])
        if rise.sum() >= 1:
            x = ks[rise] - k1
            y = ts[rise] - t0
            s = float((x * y).sum() / (x * x).sum()) if (x * x).sum() else 0.0
            s = max(s, 0.0)
        else:
            s = 0.0
        pred = np.where(flat, t0, t0 + s * (ks - k1))
        sse = float(((pred - ts) ** 2).sum())
        if sse < best[3]:
            best = (float(k1), float(t0), s, sse)
    return best


def fit_three_phase(ks: Sequence[int], ts: Sequence[float], *,
                    tol: float = 0.05) -> AbsorptionFit:
    """Fit the idealized model; k1 = absorption, k2 = saturation onset.

    k2 is where the measured curve joins the linear asymptote (tail regression)
    within ``tol`` — beyond it the system "reaches asymptotic behaviour".
    """
    ka = np.asarray(ks, np.float64)
    ta = np.asarray(ts, np.float64)
    k1, t0, slope, sse = _hinge_fit(ka, ta)

    # threshold cross-check (how a human reads the plot)
    within = ta <= (1 + tol) * ta[0]
    k1_thr = float(ka[within][-1]) if within[0] else 0.0
    if not within.all():
        first_bad = int(np.argmin(within))
        k1_thr = float(ka[first_bad - 1]) if first_bad > 0 else 0.0

    # saturation onset: tail line from the last >=3 points
    if len(ka) >= 3 and slope > 0:
        xt, yt = ka[-3:], ta[-3:]
        s2 = float(np.polyfit(xt, yt, 1)[0])
        b2 = float(yt.mean() - s2 * xt.mean())
        on_line = np.abs(ta - (s2 * ka + b2)) <= tol * np.maximum(ta, 1e-12)
        k2 = float(ka[np.argmax(on_line)]) if on_line.any() else float(ka[-1])
        k2 = max(k2, k1)
    else:
        k2 = k1
    return AbsorptionFit(k1=k1, k2=k2, t0=t0, slope=slope, k1_threshold=k1_thr,
                         sse=sse, tol=tol)


def absorption(curve: AbsorptionCurve, *, tol: float = 0.05) -> AbsorptionFit:
    return fit_three_phase(curve.ks, curve.ts, tol=tol)


# ---------------------------------------------------------------------------
# Execution clustering (paper §3.1, citing [21]): group run times into
# performance classes; each class is analyzed independently. 1-D gap split.
# ---------------------------------------------------------------------------


def cluster_times(samples: Sequence[float], *, gap_ratio: float = 1.5
                  ) -> list[list[int]]:
    """Group sample indices into performance classes.

    Sorted times are split wherever the multiplicative jump between
    neighbours exceeds ``gap_ratio`` — cheap, deterministic, and adequate for
    the bimodal/multimodal run-time families the paper clusters.
    """
    order = np.argsort(samples)
    groups: list[list[int]] = [[int(order[0])]]
    s = np.asarray(samples, np.float64)
    for prev, cur in zip(order[:-1], order[1:]):
        if s[cur] > s[prev] * gap_ratio:
            groups.append([])
        groups[-1].append(int(cur))
    return groups
