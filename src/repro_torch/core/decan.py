"""DECAN-style decremental analysis — the paper's comparison baseline (§5.2).

PyTorch port of the reference's ``repro.core.decan``. DECAN *removes*
instruction classes (the FP variant keeps only FP, the LS variant keeps only
loads/stores) and defines Sat(VAR) = T(VAR)/T(REF): a variant running much
faster than the reference means the removed class was saturated.

A decremental target is a kernel builder parameterized by which parts to
keep. On the card the removal happens at compile time: the variants of a
loop kernel (``kernels/decan_loops``) are template instances with the FP or
the LS part compiled out, so the "binary patching" is free. The semantics
caveat the paper raises (removal breaks dataflow) is handled as DECAN does:
variants keep the control flow and the trip count and write to dead
buffers, so no compiler can delete the class a variant keeps.

Campaign integration: ``run_decan(..., store=...)`` persists the three
variant timings as ``decan`` records keyed (region, variant) — the records
carry their measurement settings (reps, inner) inline and are replayed on a
re-run with matching settings, superseded otherwise; their bytes are the
reference's. ``Campaign.run_decan`` wires a campaign's store, measurement
lock and stats in, so one store file holds a region's decremental baseline
AND its incremental noise sweeps.

Noise cross-check: a target with ``build_noisy`` (the port's
``loop_region`` make_fn contract: ``build_noisy(noise_or_None, k,
static=True, plain=False)``) exposes ``region()``, a RegionTarget over the
reference kernel whose noise sweeps take the run-time-k kernel — the whole
(scenario, mode) sweep costs at most two builds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.absorption import measure

# variant name -> (keep_fp, keep_ls); "ref" keeps both instruction classes
VARIANTS = {"ref": (True, True), "fp": (True, False), "ls": (False, True)}


@dataclasses.dataclass(frozen=True)
class DecanTarget:
    """A kernel expressed with separable FP and LS parts.

    ``build(fp, ls)`` -> callable; ``args_for()`` -> its arguments.
    build(True, True) is the reference; (True, False) the FP variant
    (memory ops removed); (False, True) the LS variant (FP ops removed).

    ``build_noisy(noise_or_None, k, static=True, plain=False)`` (optional)
    builds the REFERENCE kernel with a loop-level noise slot, following the
    port's ``loop_region`` make_fn contract; it unlocks ``region()`` and
    with it compile-once noise sweeps over this kernel. ``n_iter`` is the
    loop's trip count (the payload's dynamic count) and ``device`` where
    the noise carries live. ``build_plain(fp, ls)`` (optional): the
    variants' plain versions, which a check holds the kernels against.
    """
    name: str
    build: Callable[[bool, bool], Callable]
    args_for: Callable[[], tuple]
    build_noisy: Optional[Callable] = None
    body_size: int = 0
    n_iter: int = 0
    device: str = "cuda"
    build_plain: Optional[Callable[[bool, bool], Callable]] = None

    def region(self):
        """RegionTarget over the reference kernel (both parts kept), with
        ``build_rt`` — noise sweeps take at most 2 builds per mode."""
        if self.build_noisy is None:
            raise ValueError(
                f"DecanTarget {self.name!r} has no build_noisy; pass one to "
                "run noise sweeps against this kernel")
        from repro_torch.core.controller import loop_region
        return loop_region(self.name, self.build_noisy, self.args_for,
                           body_size=self.body_size, n_iter=self.n_iter,
                           device=self.device)


@dataclasses.dataclass
class DecanResult:
    name: str
    t_ref: float
    t_fp: float          # LS removed
    t_ls: float          # FP removed

    @property
    def sat_fp(self) -> float:
        """T(FP)/T(REF). The paper's convention: Sat(VAR)=T(VAR)/T(REF) for
        variant VAR which KEEPS that class. Sat_FP ~ 1 -> the FP stream alone
        reproduces the run time -> FP saturated."""
        return self.t_fp / self.t_ref

    @property
    def sat_ls(self) -> float:
        return self.t_ls / self.t_ref

    def scenario(self, *, close: float = 0.80, fast: float = 0.6) -> str:
        """Table 3 scenarios."""
        fp, ls = self.sat_fp, self.sat_ls
        if fp >= close and ls < fast:
            return "compute-bound"         # case 1: FP variant ~ ref
        if ls >= close and fp < fast:
            return "data-bound"            # case 2
        if fp >= close and ls >= close:
            return "full-overlap"          # case 3
        if fp < close and ls < close:
            return "limited-overlap"       # case 4 (ambiguous for DECAN)
        return "mixed"


def stored_variant_t(store, name: str, variant: str, *, reps: int,
                     inner: int) -> Optional[float]:
    """The stored timing for one variant, or None when the store has no
    record measured under these settings (reps/inner mismatch = stale)."""
    if store is None:
        return None
    rec = store.decan.get((name, variant))
    if rec is None or rec.get("reps") != reps or rec.get("inner") != inner:
        return None
    return float(rec["t"])


def run_decan(target: DecanTarget, *, reps: int = 5, inner: int = 1,
              store=None, lock=None, stats=None) -> DecanResult:
    """Time the three DECAN variants, replaying from ``store`` when it has
    matching records. ``lock`` serializes the timed sections against
    concurrent campaign measurements; ``stats`` (CampaignStats-shaped)
    accumulates measured/cached counts."""
    args = target.args_for()
    ts: dict[str, float] = {}
    for vname, (fp, ls) in VARIANTS.items():
        t = stored_variant_t(store, target.name, vname, reps=reps,
                             inner=inner)
        if t is None:
            fn = target.build(fp, ls)
            if lock is not None:
                with lock:
                    t = measure(fn, args, reps=reps, inner=inner)
            else:
                t = measure(fn, args, reps=reps, inner=inner)
            if store is not None:
                store.append({"kind": "decan", "region": target.name,
                              "variant": vname, "t": t, "reps": reps,
                              "inner": inner})
            if stats is not None:
                stats.measured += 1
        elif stats is not None:
            stats.cached += 1
        ts[vname] = t
    return DecanResult(target.name, ts["ref"], ts["fp"], ts["ls"])
