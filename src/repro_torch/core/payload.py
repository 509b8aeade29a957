"""Payload/overhead verification records (paper §2.3).

The paper splits injected instructions into *payload* (the useful noise) and
*overhead* (spills / setup). The reference counts the noise ops that survive
in the optimized HLO. The port verifies payload at the arithmetic level
instead — the static-k build's noise output against its exact oracle: the
Pallas-kernel regions' noise accumulator, and the loop and step regions'
aux against the mode's plain version (``analyze_aux``) — and reports the
result in this record, whose fields and layout match the reference
package's ``InjectionReport`` so campaign stores stay byte-compatible
between the two packages.
"""
from __future__ import annotations

import dataclasses

import torch


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
