"""Payload/overhead verification records (paper §2.3).

The paper splits injected instructions into *payload* (the useful noise) and
*overhead* (spills / setup). The reference counts the noise ops that survive
in the optimized HLO. The port reads the compiler's output too, the SASS of
its static-k builds (``sass.parse``), and keeps an arithmetic proof beside
it:

  * ``payload`` — the static-k build's noise output against its exact
    oracle: the kernel regions' noise accumulator, and the loop and step
    regions' aux against the mode's plain version (``analyze_aux``);
  * ``overhead`` — the census: the instructions outside the mode's payload
    family that the k-pattern build holds and the clean build does not
    (``analyze_injection``; setup, address arithmetic, spills);
  * ``body_ops`` — |l1.l2| of the clean build (``body_size``).

The record's fields and layout match the reference package's
``InjectionReport`` so campaign stores stay byte-compatible between the two
packages. Without a card (the plain PyTorch versions) there is no SASS:
``overhead`` stays 0 and ``body_ops`` the region's stated size.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import torch

# never counted as payload or overhead: padding and control flow
BOOKKEEPING = frozenset({"NOP", "BRA", "EXIT", "BSSY", "BSYNC"})

# payload opcode families per noise-mode target (SASS opcodes without
# modifiers): the fp modes' adds and FMAs, the tensor cores (HMMA for
# ``mma.sync``, HGMMA for ``wgmma``), shared-memory re-reads with the adds
# that consume them (vmem: LDS, or the generic LD a volatile pointer into
# shared memory compiles to), device-memory loads (l1, memory, latency)
PAYLOAD_OPS = {
    "compute": {"FADD", "FFMA", "FMUL", "HADD2", "HFMA2", "HMUL2", "DADD",
                "DFMA", "DMUL", "HMMA", "HGMMA", "IMMA"},
    "l1": {"LDG", "LD"},
    "vmem": {"LDS", "LDSM", "LD", "FADD"},
    "memory": {"LDG", "LD"},
    "latency": {"LDG", "LD"},
    "ici": set(),
}


def census_op(opcode: str) -> str:
    """The census name of a SASS opcode: its base, with ``IMAD.MOV`` read
    as ``MOV`` (a value being copied or materialized, not a product)."""
    parts = opcode.split(".")
    if parts[0] == "IMAD" and len(parts) > 1 and parts[1].startswith("MOV"):
        return "MOV"
    return parts[0]


@dataclasses.dataclass
class InjectionReport:
    """Static payload verdict of one (mode, k) build."""
    mode: str
    target: str
    expected: int              # k patterns requested (static count)
    payload: int               # surviving payload ops (static)
    overhead: int              # surviving non-payload noise ops
    payload_dynamic: int       # payload weighted by loop trip counts
    body_ops: int              # non-noise ops in the injected loop body |l1.l2|

    @property
    def survival_fraction(self) -> float:
        """Surviving share of the requested patterns."""
        return self.payload / self.expected if self.expected else 1.0

    @property
    def overhead_fraction(self) -> float:
        """Share of the surviving noise ops that are not payload."""
        tot = self.payload + self.overhead
        return self.overhead / tot if tot else 0.0

    def ok(self, min_survival: float = 0.9, max_overhead: float = 0.5) -> bool:
        """True when enough of the payload survived with little overhead."""
        return (self.survival_fraction >= min_survival
                and self.overhead_fraction <= max_overhead)


def analyze_aux(got: torch.Tensor, want: torch.Tensor, *, mode: str,
                target: str, expected: int, body_ops: int = 0,
                trips: int = 1) -> InjectionReport:
    """The aux oracle of a static-k noisy build: its aux ``got`` bitwise
    equal to the mode's plain version ``want`` proves that all ``expected``
    patterns ran (payload = k), else payload is 0. ``trips``: how often the
    injected body runs a call (the payload's dynamic count)."""
    ok = bool(torch.equal(got.cpu(), want.cpu())) if expected else True
    payload = expected if ok else 0
    return InjectionReport(mode=mode, target=target, expected=expected,
                           payload=payload, overhead=0,
                           payload_dynamic=payload * trips,
                           body_ops=body_ops)


def _counts(sass: str, kernels) -> Counter:
    from repro_torch.sass.parse import parse_sass

    out: Counter = Counter()
    for fn in parse_sass(sass).values():
        if kernels is None or fn.base in kernels:
            for ins in fn.instrs:
                op = census_op(ins.opcode)
                if op not in BOOKKEEPING:
                    out[op] += 1
    return out


def analyze_injection(clean_sass: str, noisy_sass: str, *, mode: str,
                      target: str, expected: int, kernels=None,
                      trips: int = 1) -> InjectionReport:
    """The census of one static-k build against the clean build of the
    same kernel: ``payload`` the payload-family instructions the k build
    adds (per thread: a pattern may be several), ``overhead`` every other
    instruction it adds, ``body_ops`` |l1.l2| of the clean build.
    ``kernels``: the base names of the functions censused (None: all)."""
    clean, noisy = _counts(clean_sass, kernels), _counts(noisy_sass, kernels)
    family = PAYLOAD_OPS.get(target, PAYLOAD_OPS["compute"])
    grown = {op: noisy[op] - clean.get(op, 0) for op in noisy
             if noisy[op] > clean.get(op, 0)}
    payload = sum(n for op, n in grown.items() if op in family)
    overhead = sum(n for op, n in grown.items() if op not in family)
    return InjectionReport(mode=mode, target=target, expected=expected,
                           payload=payload, overhead=overhead,
                           payload_dynamic=payload * trips,
                           body_ops=body_size(clean_sass, kernels=kernels))


def body_size(sass: str, *, kernels=None) -> int:
    """|l1.l2| of a clean build: the non-bookkeeping instructions at the
    deepest loop of the region's kernel function (the first function of
    ``kernels``' base names in the dump, else the first function); the
    whole function when it has no loop. 0 when the dump has no function."""
    from repro_torch.sass.parse import parse_sass

    funcs = [fn for fn in parse_sass(sass).values()
             if kernels is None or fn.base in kernels]
    if not funcs:
        return 0
    instrs = funcs[0].instrs
    deepest = max((i.depth for i in instrs), default=0)
    return sum(1 for i in instrs
               if i.depth == deepest and census_op(i.opcode) not in BOOKKEEPING)


def with_census(report: InjectionReport,
                census: Optional[InjectionReport]) -> InjectionReport:
    """``report`` (the arithmetic proof of the payload) with the census's
    ``overhead`` and ``body_ops``; unchanged without a census."""
    if census is None:
        return report
    return dataclasses.replace(report, overhead=census.overhead,
                               body_ops=census.body_ops)
