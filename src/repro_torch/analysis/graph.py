"""Def-use graph over one SASS function's instructions.

A function lists its instructions in address order, so longest-path
questions are one forward scan, as in the reference (``repro.analysis.
graph``): each register's last writer stands for its value, and a read
links to it. The scan does not follow loop back edges; the audit compares
chain DEPTH DELTAS between two builds of the same kernel at two static
noise counts, where the kernel's own (k-independent) chains cancel.
"""
from __future__ import annotations

from typing import Callable, Iterable

from repro_torch.sass.parse import Instr


def defuse_edges(instrs: Iterable[Instr]) -> dict[int, list[int]]:
    """{instruction index: [indices of the instructions that last wrote the
    registers it reads]}, in one forward scan."""
    last: dict[str, int] = {}
    edges: dict[int, list[int]] = {}
    for i, ins in enumerate(instrs):
        edges[i] = sorted({last[r] for r in ins.src if r in last})
        for r in ins.dst:
            last[r] = i
    return edges


def chain_depth(instrs: Iterable[Instr],
                counted: Callable[[Instr], bool]) -> int:
    """Longest def-use chain, scoring only instructions where ``counted``
    holds. Paths pass through uncounted nodes (the ``IMAD.WIDE`` that forms
    a pointer chase's next address from the value just loaded links two
    loads), which is what tells a serial chase from k independent loads."""
    depth: dict[str, int] = {}
    best = 0
    for ins in instrs:
        d = max((depth.get(r, 0) for r in ins.src), default=0)
        if counted(ins):
            d += 1
        for r in ins.dst:
            depth[r] = d
        best = max(best, d)
    return best
