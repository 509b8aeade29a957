"""Noise controller — the paper's high-level tool (§3.1/§3.2) that automates
the injection experiments: sensitivity probing, adaptive sweeps, online
saturation detection, payload verification, and classification.

PyTorch port of the reference's controller. "Compile once" here means one
loaded CUDA function per (region, mode): the noise quantity k is a plain
runtime ``int`` argument of the callable ``RegionTarget.build_rt`` returns,
so a whole k-sweep needs the runtime-k build plus one static-k build for the
payload check. The trace-per-k path (``compile_once=False``) builds one
static-k kernel per sweep point, the paper's own cost model.

``loop_region`` adapts a loop-level target (``bench/kernels.py``: the
paper's validation loops as CUDA kernels with a loop-body noise slot) to a
``RegionTarget``, as the reference's does for its ``fori_loop`` regions.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Callable, Optional, Sequence

from repro_torch.core.absorption import (AbsorptionCurve, AbsorptionFit,
                                         absorption, floor_time, measure,
                                         sweep)
from repro_torch.core.classifier import HIGH, LOW, BottleneckReport, classify
from repro_torch.core.loopnoise import loop_carry, make_loop_modes
from repro_torch.core import payload as payload_mod

log = logging.getLogger("repro_torch.controller")


@dataclasses.dataclass(frozen=True)
class RegionTarget:
    """One noisable region (the paper: a loop nest selected by pragma/config).

    ``build(mode_name, k)`` returns the noisy callable; ``args_for(mode_name,
    k)`` its arguments. ``build("", 0)`` must be the clean reference.
    ``body_size``: |l1.l2| for Abs^rel.

    Compile-once sweeps (optional): ``build_rt(mode_name)`` returns ONE
    callable taking ``(k, *args_for_rt(mode_name))`` with k a plain ``int``
    (or None when the mode doesn't support it); the controller then sweeps k
    without rebuilding. Regions without ``build_rt`` use the trace-per-k
    fallback.

    ``payload_check(mode_name, k)`` verifies the payload of a static-k build
    (Pallas-kernel regions compare the noise accumulator against its exact
    oracle). ``audit_hint`` parameterizes the static noise audit
    (``repro_torch.analysis``):
      ``in_loop`` — the noise is meant to execute per loop step;
      ``steps`` — the loop a CTA runs over its grid steps (kernel regions);
      ``scoped`` — the noise runs in a kernel of its own (a step region's
      graph-noise kernel), so the census reads that kernel alone.
    ``sass(mode_name, k)`` (on the card; None for the plain versions) names
    the static build whose SASS carries k patterns of the mode and the
    functions in it (a ``kernels._build.SassSite``); k = 0 is the clean
    build (``sass("", 0)`` too, where the region has a body of its own).
    The audit and the payload census read it.
    """
    name: str
    build: Callable[[str, int], Callable]
    args_for: Callable[[str, int], tuple]
    body_size: int = 0
    payload_target: dict[str, str] = dataclasses.field(default_factory=dict)
    build_rt: Optional[Callable[[str], Optional[Callable]]] = None
    args_for_rt: Optional[Callable[[str], tuple]] = None
    payload_check: Optional[Callable[[str, int], object]] = None
    audit_hint: Optional[dict] = None
    sass: Optional[Callable[[str, int], object]] = None


@dataclasses.dataclass
class ModeResult:
    """One mode's sweep: its curve, its three-phase fit and its payload."""
    mode: str
    curve: AbsorptionCurve
    fit: AbsorptionFit
    injection: Optional[payload_mod.InjectionReport] = None

    def row(self) -> dict:
        """The mode's fields as one JSON-ready report row."""
        return {
            "mode": self.mode,
            "abs_raw": self.fit.k1,
            "abs_threshold": self.fit.k1_threshold,
            "k2": self.fit.k2,
            "t0_s": self.fit.t0,
            "slope_s_per_pattern": self.fit.slope,
            "ks": self.curve.ks,
            "ts": self.curve.ts,
            "payload_survival": (self.injection.survival_fraction
                                 if self.injection else None),
            "payload_overhead": (self.injection.overhead_fraction
                                 if self.injection else None),
        }


@dataclasses.dataclass
class RegionReport:
    """Every mode's result for one region, and its classification."""
    region: str
    results: dict[str, ModeResult]
    bottleneck: BottleneckReport
    body_size: int

    def absorptions(self, *, relative: bool = False) -> dict[str, float]:
        """Abs^raw per mode (Abs^rel with ``relative`` and a known body)."""
        if relative and self.body_size:
            return {m: r.fit.rel(self.body_size) for m, r in self.results.items()}
        return {m: r.fit.k1 for m, r in self.results.items()}

    def to_json(self) -> str:
        """The report as indented JSON (the reference's layout)."""
        bn = {
            "label": self.bottleneck.label,
            "confidence": self.bottleneck.confidence,
            "explanation": self.bottleneck.explanation,
        }
        if getattr(self.bottleneck, "evidence", None):
            bn["evidence"] = self.bottleneck.evidence
        if getattr(self.bottleneck, "quality", None):
            bn["quality"] = self.bottleneck.quality
        return json.dumps({
            "region": self.region,
            "body_size": self.body_size,
            "bottleneck": bn,
            "modes": {m: r.row() for m, r in self.results.items()},
        }, indent=2)

    def summary(self) -> str:
        """Human-readable per-mode lines and the verdict."""
        lines = [f"region {self.region!r}  (|body|={self.body_size})"]
        for m, r in self.results.items():
            surv = (f" payload={r.injection.survival_fraction:.0%}"
                    if r.injection else "")
            lines.append(
                f"  {m:12s} Abs^raw={r.fit.k1:7.1f}  Abs^rel="
                f"{r.fit.rel(self.body_size):6.3f}  t0={r.fit.t0*1e3:8.3f}ms"
                f"  slope={r.fit.slope*1e6:8.3f}us/pat{surv}")
        lines.append(f"  => {self.bottleneck}")
        return "\n".join(lines)


class Controller:
    """Runs the §3.2 methodology against a region."""

    def __init__(self, *, tol: float = 0.05, reps: int = 5,
                 probe_k: int = 24, stop_ratio: float = 4.0,
                 verify_payload: bool = True, compile_once: bool = True):
        self.tol = tol
        self.reps = reps
        self.probe_k = probe_k            # paper: "values around 20 or 30"
        self.stop_ratio = stop_ratio
        self.verify_payload = verify_payload
        self.compile_once = compile_once  # use build_rt when the region has it
        # memoize runtime-k callables per (target, mode), so the sensitivity
        # probe and the sweep share ONE build. Keyed by target IDENTITY (two
        # targets may share a name but hold different tensors); the entry
        # pins the target so its id() cannot be recycled onto a stale build.
        self._rt_cache: dict[tuple[int, str],
                             tuple[RegionTarget, Optional[Callable]]] = {}

    def _rt_fn(self, target: RegionTarget, mode: str) -> Optional[Callable]:
        """The region's runtime-k callable, or None -> trace-per-k fallback."""
        if not self.compile_once or target.build_rt is None:
            return None
        key = (id(target), mode)
        if key not in self._rt_cache:
            self._rt_cache[key] = (target, target.build_rt(mode))
        return self._rt_cache[key][1]

    # -- §3.2: one or two quantities first, to learn the sensitivity --------
    def probe_sensitivity(self, target: RegionTarget, mode: str,
                          deadline: Optional[float] = None) -> float:
        """t(probe_k) / t(0) for one mode."""
        reps = max(2, self.reps - 2)
        fn_rt = self._rt_fn(target, mode)
        if fn_rt is not None:
            args = target.args_for_rt(mode)
            t0 = measure(fn_rt, (0, *args), reps=reps, deadline=deadline)
            tk = measure(fn_rt, (int(self.probe_k), *args), reps=reps,
                         deadline=deadline)
        else:
            t0 = measure(target.build(mode, 0), target.args_for(mode, 0),
                         reps=reps, deadline=deadline)
            tk = measure(target.build(mode, self.probe_k),
                         target.args_for(mode, self.probe_k), reps=reps,
                         deadline=deadline)
        return tk / floor_time(t0, f"probe_sensitivity({target.name}/{mode}) t0")

    def _ks_for(self, sensitivity: float) -> Sequence[int]:
        if sensitivity > 2.0:       # very sensitive: fine steps near zero
            return (0, 1, 2, 3, 4, 6, 8, 12, 16, 24)
        if sensitivity > 1.1:       # moderate
            return (0, 1, 2, 4, 8, 12, 16, 24, 32, 48, 64)
        # robust to noise: steps of 5-10 (paper's guidance), go far
        return (0, 5, 10, 20, 30, 40, 60, 80, 120, 160, 240, 320)

    def run_mode(self, target: RegionTarget, mode: str,
                 ks: Optional[Sequence[int]] = None) -> ModeResult:
        """Sweep one mode. Compile-once path: the sensitivity probe and every
        sweep point reuse ONE runtime-k build; payload verification adds one
        static-k build — at most 2 builds for the whole sweep (the fallback
        path builds one per k, the paper's cost model).

        ``ks``: override the sensitivity-chosen quantities (campaign resume).
        """
        fn_rt = self._rt_fn(target, mode)
        if ks is None:
            ks = self._ks_for(self.probe_sensitivity(target, mode))
        if fn_rt is not None:
            args_rt = target.args_for_rt(mode)
            curve = sweep(lambda k: fn_rt, mode=mode, ks=ks,
                          args_for=lambda k: (int(k), *args_rt),
                          reps=self.reps, stop_ratio=self.stop_ratio)
        else:
            curve = sweep(lambda k: target.build(mode, k), mode=mode, ks=ks,
                          args_for=lambda k: target.args_for(mode, k),
                          reps=self.reps, stop_ratio=self.stop_ratio)
        fit = absorption(curve, tol=self.tol)
        inj = self.verify_mode_payload(target, mode, curve.ks) \
            if self.verify_payload else None
        return ModeResult(mode=mode, curve=curve, fit=fit, injection=inj)

    def verify_mode_payload(self, target: RegionTarget, mode: str,
                            ks: Sequence[int]):
        """Static payload check (§2.3) on a static-k build, at the largest
        nonzero k of the sweep. Only regions with a ``payload_check`` can be
        verified; others report None. A failing check raises: on the card
        it means a kernel did not build or run."""
        k_chk = next((k for k in reversed(list(ks)) if k), 8)
        if target.payload_check is None:
            return None
        return target.payload_check(mode, k_chk)

    def characterize(self, target: RegionTarget,
                     modes: Sequence[str] = ("fp_add", "l1_ld", "mem_ld"),
                     *, low: float = LOW, high: float = HIGH) -> RegionReport:
        """Sweep every mode and classify the region; ``low``/``high`` are
        the effective classification thresholds."""
        results = {m: self.run_mode(target, m) for m in modes}
        report = classify({m: r.fit.k1 for m, r in results.items()},
                          low=low, high=high)
        return RegionReport(region=target.name, results=results,
                            bottleneck=report,
                            body_size=target.body_size or derive_body_size(target))


def derive_body_size(target: RegionTarget) -> int:
    """|l1.l2| of a region that does not state it, from the SASS of its
    clean build (``payload.body_size``). 0 for a region with no compiled
    body: the plain versions on the cpu, and a step region, whose clean
    step is a CUDA graph of library kernels built from no source here. A
    census that fails is logged and reads 0, as the reference's does."""
    site = target.sass("", 0) if target.sass is not None else None
    if site is None or not site.body:
        return 0
    try:
        from repro_torch.analysis.audit import site_text

        return payload_mod.body_size(site_text(site),
                                     kernels={b for b, _ in site.kernels},
                                     unroll=site.unroll)
    except Exception:
        log.warning("body-size derivation failed for %s", target.name,
                    exc_info=True)
        return 0


def census_payload(target: RegionTarget, mode: str, k: int, *,
                   expected: int, trips: int = 1):
    """The SASS census of a region's static k-pattern build against its
    clean build (``payload.analyze_injection``); None when the region has
    no compiled noise (the plain versions). Raises when the SASS cannot be
    read (a failed payload check on the card)."""
    if target.sass is None or not k:
        return None
    from repro_torch.analysis.audit import site_text

    site = target.sass(mode, k)
    if site is None:
        return None
    clean = target.sass(mode, 0)
    return payload_mod.analyze_injection(
        site_text(clean), site_text(site), mode=mode,
        target=target.payload_target.get(mode, _default_target(mode)),
        expected=expected, kernels={b for b, _ in site.kernels},
        trips=trips, unroll=site.unroll)


def _default_target(mode: str) -> str:
    """The resource one pattern of ``mode`` stresses (payload reports)."""
    modes = make_loop_modes()
    if mode in modes:
        return modes[mode].target
    return {"fp_add32": "compute", "mxu_fma128": "compute",
            "vmem_ld": "vmem", "hbm_stream": "memory",
            "hbm_latency": "latency",
            # kernel-level vocabulary (kernels/noise_slots.py)
            "fp": "compute", "mxu": "compute", "vmem": "vmem",
            }.get(mode, "compute")


def loop_region(name: str,
                make_fn: Callable[..., Callable],
                args_for: Callable[[], tuple], *, body_size: int = 0,
                n_iter: int = 0, device="cuda",
                sass: Optional[tuple] = None) -> RegionTarget:
    """Adapter for loop-level targets.

    ``make_fn(noise_or_None, k, static=True, plain=False)`` returns the
    region's callable: it takes ``args_for()`` and, when ``noise`` is given,
    the mode's carry as its last argument, and returns ``(out, aux)`` with
    noise, ``out`` without. ``static``: the static-k kernel (k unrolled);
    else the run-time-k kernel, which serves a whole sweep. ``plain``: the
    kernel's plain PyTorch version (the payload check's oracle).

    ``device`` is where the carries live (``loop_carry``: the card's
    256 MiB buffers for mem_ld and chase on CUDA). ``n_iter``: the loop's
    trip count (the payload's dynamic count). ``sass``: ``(source,
    kernels[, unroll])``, the ``csrc/<source>.cu`` static builds and the
    loop kernel's (base name, mangled-tail prefix) in them, which the audit
    and the payload census read on the card; ``unroll`` (default 1): the
    region's iterations one pass of the kernel's innermost loop runs, so
    that a derived |body| is one iteration's.
    """
    from repro_torch.core.loopnoise import MODE_IDS
    from repro_torch.kernels._build import SassSite

    modes = make_loop_modes()
    on_card = str(device).startswith("cuda")

    def carry(mode: str) -> dict:
        return loop_carry(mode, device)

    def build(mode: str, k: int):
        if not mode or k == 0:
            return make_fn(None, 0)
        return make_fn(modes[mode], k)

    def args(mode: str, k: int):
        base = args_for()
        if not mode or k == 0:
            return base
        return (*base, carry(mode))

    def build_rt(mode: str):
        noise = modes[mode]

        def fn(k, *args_and_carry):
            return make_fn(noise, k, static=False)(*args_and_carry)

        return fn

    def args_rt(mode: str):
        return (*args_for(), carry(mode))

    def site(mode: str, k: int) -> SassSite:
        mode_id = MODE_IDS[mode] if mode and k else 0
        return SassSite(sass[0], mode_id, k if mode_id else 0,
                        kernels=tuple(sass[1]),
                        unroll=sass[2] if len(sass) > 2 else 1)

    def payload_check(mode: str, k: int) -> payload_mod.InjectionReport:
        """Run the static-k build once and hold its aux against the plain
        version's: an exact match proves that all k patterns ran; on the
        card the SASS census gives ``overhead`` and ``body_ops``."""
        got = want = None
        if k:
            call_args = args(mode, k)
            got = build(mode, k)(*call_args)[1]
            want = make_fn(modes[mode], k, plain=True)(*call_args)[1]
        rep = payload_mod.analyze_aux(
            got, want, mode=mode, target=_default_target(mode), expected=k,
            body_ops=body_size, trips=n_iter)
        return payload_mod.with_census(rep, census_payload(
            target, mode, k, expected=k, trips=n_iter))

    target = RegionTarget(name=name, build=build, args_for=args,
                          body_size=body_size, build_rt=build_rt,
                          args_for_rt=args_rt, payload_check=payload_check,
                          audit_hint={"scoped": True, "in_loop": True},
                          sass=site if sass is not None and on_card else None)
    return target
