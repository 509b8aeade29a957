"""The static noise audit: a two-point k-scaling census over SASS.

The reference (``repro.analysis.audit``) compiles every planned (region,
mode) pair at two static noise counts plus a clean build and censuses the
optimized HLO. Here the compiler is ``nvcc``/``ptxas`` and the census reads
the SASS of the port's static-k builds (``kernels/_build.py``: one library
per (kernel, mode, k[, variant])): clean (mode 0, k = 0), ``K_LO`` and
``K_HI``. The k-scaling delta ``hi - lo`` is every instruction the compiler
keeps per extra pattern; code that does not scale with k (the kernel's own
work, the reduction epilogue, the functions a call launches beside the
kernel: ``nacc_reduce``, ``transpose_tf32``, ``fa_prep``) cancels in it
exactly. The clean build attributes the corruption class when the payload
died. Nothing is launched: the builds are compiled and dumped, never run.

Census key ``(opcode, loop depth, function)``: mangled names carry the
template arguments (mode and k), so functions are keyed by their base name
(``probe_kernel``), and ``IMAD.MOV`` reads as ``MOV`` (a constant or copy
being materialized). Survival counts the whole payload family of the
mode's target (``core.payload.PAYLOAD_OPS``), per pattern and thread.

Corruption classes (detected in this order) and what each is in SASS:
  strength_reduction      payload does not scale with k; the hi-vs-clean
                          diff gained an FMUL/FFMA (k adds -> one a*k)
  constant_folding        payload does not scale; hi-vs-clean gained only
                          moves (the reference's ``constant`` growth: in
                          SASS a folded value is an immediate or a MOV)
  dce                     payload does not scale and left nothing behind
  fusion_into_consumer    payload scales, but only outside the region's
                          kernel (in a function a call runs once, not per
                          step) at depth 0 while the region loops
  loop_invariant_hoisting same, but in the kernel at depth 0, out of the
                          loop that carries the region's steps
  partial_elision         payload scales at < 1 family op per pattern

Verdicts: ``intact`` (>= 1 surviving family op per pattern, placed where it
executes), ``degraded`` (hoisting / fusion / partial), ``dead`` (the first
three classes). Only ``dead`` refuses a fleet plan at the gate. A pair
whose SASS cannot be read (no ``cuobjdump``, a failed build, a CPU region
with no compiled noise) is unauditable (``AuditError``), never a verdict.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from repro_torch.analysis.graph import chain_depth
from repro_torch.analysis.resources import (BANDWIDTH_OPS, TARGET_FAMILY,
                                            access_bytes, predict_direction,
                                            pressure_vector)
from repro_torch.core.payload import PAYLOAD_OPS, census_op
from repro_torch.sass.parse import parse_sass

K_LO = 4
K_HI = 12

# never part of a payload: alignment padding
_PLUMBING = frozenset({"NOP"})
# what a strength-reduced add chain and a folded constant leave in SASS
_MULTIPLY = frozenset({"FMUL", "FFMA", "DMUL", "DFMA", "HMUL2", "HFMA2"})
_CONSTANT = frozenset({"MOV", "UMOV", "MOV32I"})


class AuditError(RuntimeError):
    """A planned pair could not be audited (no SASS to census)."""


@dataclasses.dataclass
class Census:
    """One build's SASS, reduced to audit-comparable aggregates."""
    counts: Counter          # (opcode, depth, function) -> instructions
    bytes: Counter           # (opcode, depth, function) -> bytes a thread moves
    load_depth: int          # longest load-family def-use chain (any function)
    loop_depth: int          # deepest loop of the region's kernel function(s)


def take_census(text: str, *, kernels=None) -> Census:
    """Census one SASS dump. ``kernels``: base names of the functions that
    carry the region's noise (the others are the kernels a call launches
    beside it); None: every function carries it."""
    counts: Counter = Counter()
    nbytes: Counter = Counter()
    load_depth = loop_depth = 0
    for fn in parse_sass(text).values():
        where = fn.base
        if kernels is None or where in kernels:
            loop_depth = max(loop_depth,
                             max((i.depth for i in fn.instrs), default=0))
        load_depth = max(load_depth, chain_depth(
            fn.instrs, lambda ins: ins.op in BANDWIDTH_OPS))
        for ins in fn.instrs:
            op = census_op(ins.opcode, ins.text)
            if op in _PLUMBING:
                continue
            key = (op, ins.depth, where)
            counts[key] += 1
            if op in BANDWIDTH_OPS:
                nbytes[key] += access_bytes(ins.opcode)
    return Census(counts=counts, bytes=nbytes, load_depth=load_depth,
                  loop_depth=loop_depth)


def _delta(hi: Counter, lo: Counter) -> dict:
    """Per-key census difference (keys present in either side)."""
    out = {}
    for key in set(hi) | set(lo):
        d = hi.get(key, 0) - lo.get(key, 0)
        if d:
            out[key] = d
    return out


def _family_total(delta: dict, family) -> int:
    return sum(n for key, n in delta.items() if key[0] in family)


@dataclasses.dataclass
class AuditReport:
    """Static verdict for one planned (region, mode) pair."""
    region: str
    mode: str
    target: str                  # the mode's declared resource target
    verdict: str                 # intact | degraded | dead
    corruption: Optional[str]    # corruption class when not intact
    survival: float              # surviving payload-family ops per pattern
    resources: dict              # per-pattern pressure vector
    predicted: str               # compute | bandwidth | latency | ici | none
    agrees: Optional[bool]       # predicted direction matches the target?
    k_lo: int = K_LO
    k_hi: int = K_HI
    detail: str = ""             # human-readable census-delta summary

    @property
    def survival_fraction(self) -> float:
        return max(0.0, min(1.0, self.survival))

    @property
    def ok(self) -> bool:
        return self.verdict != "dead"

    def to_dict(self) -> dict:
        """The store's ``audit`` record body (the reference's layout)."""
        d = dataclasses.asdict(self)
        d["survival"] = round(self.survival, 4)
        d["resources"] = {k: round(v, 4)
                          for k, v in sorted(self.resources.items())}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "AuditReport":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def explain(self) -> str:
        """One line: what the compiler did to this pair."""
        why = {
            "strength_reduction":
                "k chained adds were strength-reduced to one multiply "
                "(the addend is loop-invariant to nvcc)",
            "constant_folding":
                "the noise payload folded to immediates and moves "
                "(the addend was not a run-time value)",
            "dce":
                "the noise payload was dead-code-eliminated (its result "
                "does not reach a live output)",
            "fusion_into_consumer":
                "the payload landed in a kernel that runs once a call, "
                "not per region step",
            "loop_invariant_hoisting":
                "the payload was hoisted out of the region loop and runs "
                "once, not per step",
            "partial_elision":
                "only part of the payload survives per pattern (merged or "
                "partly folded)",
        }.get(self.corruption or "", "payload scales instruction-for-"
                                     "instruction with k")
        return (f"{self.region} × {self.mode}: {self.verdict} "
                f"(survival {self.survival_fraction:.0%}/pattern, "
                f"predicts {self.predicted}) — {why}")


def _expects_loop_placement(hint: dict, loop_depth: int) -> bool:
    """Should the payload sit inside a loop?

    Only when the region says its noise executes per loop step AND a CTA
    really loops: ``steps`` is the loop's trip count a CTA (``steps_per_cta``
    of a kernel region: on the card CTAs stand in for grid steps, and a CTA
    that takes one step legitimately places its noise at depth 0). Hints
    without ``steps`` (loop regions) fall back to the kernel's own loops."""
    if not hint.get("in_loop"):
        return False
    steps = hint.get("steps")
    if steps is not None:
        return steps > 1
    return loop_depth > 0


def audit_texts(clean_text: str, lo_text: str, hi_text: str, *,
                region: str, mode: str, target: str,
                hint: Optional[dict] = None,
                k_lo: int = K_LO, k_hi: int = K_HI) -> AuditReport:
    """Audit one pair from its three SASS dumps (pure; the layer the golden
    fixtures pin). ``hint``: the region's ``audit_hint``, plus ``kernels``
    (the base names of the noise-carrying functions) when the dumps hold
    other functions too."""
    hint = hint or {}
    kernels = hint.get("kernels")
    kernels = set(kernels) if kernels else None
    c0 = take_census(clean_text, kernels=kernels)
    clo = take_census(lo_text, kernels=kernels)
    chi = take_census(hi_text, kernels=kernels)

    patterns = k_hi - k_lo
    scale = _delta(chi.counts, clo.counts)          # the k-scaling delta
    scale_bytes = _delta(chi.bytes, clo.bytes)
    vs_clean = _delta(chi.counts, c0.counts)        # for attribution only
    family = PAYLOAD_OPS.get(target, PAYLOAD_OPS["compute"])
    survival = max(0, _family_total(scale, family)) / patterns
    depth_delta = max(0, chi.load_depth - clo.load_depth)

    verdict, corruption = "intact", None
    if survival < 1.0 / patterns:                   # < 1 op across the span
        verdict = "dead"
        n_mult = sum(n for key, n in vs_clean.items()
                     if key[0] in _MULTIPLY and n > 0)
        n_const = sum(n for key, n in vs_clean.items()
                      if key[0] in _CONSTANT and n > 0)
        if target == "compute" and n_mult > 0:
            corruption = "strength_reduction"
        elif n_const > 0:
            corruption = "constant_folding"
        else:
            corruption = "dce"
    elif survival < 1.0:
        verdict, corruption = "degraded", "partial_elision"
    elif (_expects_loop_placement(hint, chi.loop_depth)
          and all(key[1] == 0 for key, n in scale.items()
                  if key[0] in family and n > 0)):
        # scales with k but never inside the loop that carries the steps
        verdict = "degraded"
        outside = any(kernels is not None and key[2] not in kernels
                      for key, n in scale.items()
                      if key[0] in family and n > 0)
        corruption = ("fusion_into_consumer" if outside
                      else "loop_invariant_hoisting")

    resources = pressure_vector(scale, scale_bytes, depth_delta, patterns)
    predicted = predict_direction(scale, depth_delta, patterns)
    fam = TARGET_FAMILY.get(target)
    agrees = (predicted == fam) if predicted != "none" and fam else None

    pieces = [f"{op}@d{d}/{w}:{n:+d}"
              for (op, d, w), n in sorted(scale.items())
              if op in family or n > 0]
    return AuditReport(region=region, mode=mode, target=target,
                       verdict=verdict, corruption=corruption,
                       survival=survival, resources=resources,
                       predicted=predicted, agrees=agrees,
                       k_lo=k_lo, k_hi=k_hi,
                       detail=" ".join(pieces[:12]))


def _site(target, mode: str, k: int):
    """The SASS site of one static build of a pair (k = 0: the clean
    build); AuditError when the region has no compiled noise."""
    site = target.sass(mode, k) if target.sass is not None else None
    if site is None:
        raise AuditError(
            "unauditable — the region has no compiled noise to census (the "
            "plain PyTorch versions on the cpu, or a mode whose noise is a "
            "library call)")
    return site


def site_text(site, what: str = "") -> str:
    """The SASS of one site's functions, built from the repo's sources if
    needed; AuditError when it cannot be read (never an empty census)."""
    from repro_torch.kernels import _build

    try:
        text = _build.site_sass(site)
    except Exception as e:                  # noqa: BLE001 — surfaced as audit
        raise AuditError(f"{what}static build failed during audit: "
                         f"{e}") from e
    if text is None:
        raise AuditError(f"{what}unauditable — the toolkit has no cuobjdump "
                         "to read the SASS with")
    if not text.strip():
        raise AuditError(f"{what}unauditable — the build holds none of the "
                         f"functions {site.kernels + site.aux}")
    return text


def sass_text(target, mode: str, k: int) -> str:
    """ONE static build of a pair (k patterns of ``mode``; k = 0 the clean
    build) and its SASS, restricted to the region's functions. No
    measurement happens: the library is compiled and dumped, never run."""
    try:
        site = _site(target, mode, k)
    except AuditError as e:
        raise AuditError(f"{target.name} × {mode}: {e}") from None
    return site_text(site, f"{target.name} × {mode} (k={k}): ")



def compile_texts(target, mode: str, *, k_lo: int = K_LO, k_hi: int = K_HI,
                  clean_text: Optional[str] = None) -> tuple[str, str, str]:
    """The (clean, k_lo, k_hi) SASS of one pair. ``clean_text`` reuses an
    already-dumped clean build (mode-independent for a kernel region)."""
    if clean_text is None:
        clean_text = sass_text(target, mode, 0)
    return (clean_text, sass_text(target, mode, k_lo),
            sass_text(target, mode, k_hi))


def audit_hint(target, mode: str) -> dict:
    """The region's ``audit_hint`` with the noise-carrying functions of
    ``mode``'s builds (what ``audit_texts`` keys the placement on)."""
    hint = dict(target.audit_hint or {})
    site = _site(target, mode, K_LO)
    hint["kernels"] = sorted({b for b, _ in site.kernels})
    return hint


def _payload_target(target, mode: str) -> str:
    from repro_torch.core.controller import _default_target

    return target.payload_target.get(mode, _default_target(mode))


def audit_pair(target, mode: str, *, k_lo: int = K_LO, k_hi: int = K_HI,
               clean_text: Optional[str] = None) -> AuditReport:
    """Audit one (RegionTarget, mode) pair: three static builds (two when
    ``clean_text`` is shared), zero measurements."""
    clean, lo, hi = compile_texts(target, mode, k_lo=k_lo, k_hi=k_hi,
                                  clean_text=clean_text)
    return audit_texts(clean, lo, hi, region=target.name, mode=mode,
                       target=_payload_target(target, mode),
                       hint=audit_hint(target, mode), k_lo=k_lo, k_hi=k_hi)


def _pair_sites(target, mode: str, k_lo: int, k_hi: int):
    return [_site(target, mode, k) for k in (0, k_lo, k_hi)]


def audit_plan(plan, *, skip=frozenset(), on_error=None,
               k_lo: int = K_LO, k_hi: int = K_HI,
               workers: int = 16) -> list[AuditReport]:
    """Audit every (region, mode) pair of a resolved SweepPlan, in plan
    order. Every build the pairs need is compiled first, ``nvcc`` processes
    side by side, and the dumps are read in a thread pool (``workers``);
    a build shared by several pairs (the clean one) is dumped once.

    ``skip``: (region, mode) pairs with existing audit records.
    ``on_error``: callback ``(region, mode, AuditError)`` — when given, an
    unauditable pair is reported there and skipped instead of aborting
    the audit (an unauditable pair is not PROOF of a dead payload). A plan
    on the cpu backend has no compiled noise: every pair is unauditable
    and ``nvcc`` is never called."""
    def fail(region, mode, err):
        if on_error is None:
            raise err
        on_error(region, mode, err)

    if set(plan.grid()) <= set(skip):
        return []                           # every pair has its record
    if plan.backend == "cpu":
        for region, mode in plan.grid():
            if (region, mode) not in skip:
                fail(region, mode, AuditError(
                    "unauditable — the cpu backend runs the plain PyTorch "
                    "versions, no compiled noise to census"))
        return []
    todo = []                               # (target, mode, sites or error)
    for spec, targets in plan.resolve():
        for tgt in targets:
            for mode in spec.modes:
                if (tgt.name, mode) in skip:
                    continue
                try:
                    todo.append((tgt, mode, _pair_sites(tgt, mode, k_lo,
                                                        k_hi)))
                except AuditError as e:
                    todo.append((tgt, mode, e))
    sites = list(dict.fromkeys(s for _, _, ss in todo
                               if not isinstance(ss, AuditError)
                               for s in ss))
    texts: dict = {}

    def read(site):
        try:
            texts[site] = site_text(site, f"{site.source} mode "
                                          f"{site.mode_id} k={site.k}: ")
        except AuditError as e:
            texts[site] = e

    if sites:
        with ThreadPoolExecutor(max_workers=max(1, min(workers,
                                                       len(sites)))) as ex:
            list(ex.map(read, sites))
    reports = []
    for tgt, mode, ss in todo:
        if isinstance(ss, AuditError):
            fail(tgt.name, mode, ss)
            continue
        got = [texts[s] for s in ss]
        err = next((t for t in got if isinstance(t, AuditError)), None)
        if err is not None:
            fail(tgt.name, mode, err)
            continue
        reports.append(audit_texts(
            *got, region=tgt.name, mode=mode,
            target=_payload_target(tgt, mode), hint=audit_hint(tgt, mode),
            k_lo=k_lo, k_hi=k_hi))
    return reports
