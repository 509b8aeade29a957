"""``cuobjdump -sass`` text → functions and instructions.

The counterpart of the reference's HLO parser (``repro.hlo.parse``), payload
half: the audit (``repro_torch.analysis``) and the payload census
(``core.payload``) read compiled SASS through it. The parser is text-based
and needs no CUDA tool: the card's machine dumps the SASS, and the same
text parses anywhere (the CPU tests read dumps captured on the card).

What it reads from each instruction line (``/*0a30*/ @!P0 LDG.E.128 R4,
desc[UR6][R2.64] ;``): the address, the guard predicate, the opcode with
its modifiers, the destination and source registers (``R``, ``UR``, ``P``,
``UP``; ``RZ``/``PT`` are constants, not registers) and, for branches, the
target. Both target forms ``cuobjdump`` prints are accepted: an address
(``BRA 0x1f0``) and a label (`` BRA `(.L_x_3) ``, the label standing on a
line of its own before the instruction it names).

Loop depth: SASS has no loop instruction; a loop is a backward branch. Every
``BRA``/``JMP`` to its own or a lower address closes a loop over the
addresses from its target to itself, and an instruction's depth is the
number of such loops that hold it (a single-instruction self-branch, the
``BRA`` that parks a thread after ``EXIT``, is not a loop). The depth is the
counterpart of the reference's nesting multiplier: it says where code runs,
not how often.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

_FUNC_RE = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR_RE = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+(.*?)\s*;")
_LABEL_RE = re.compile(r"^\s*([.$\w]+):\s*$")
_GUARD_RE = re.compile(r"^@(!?U?P(?:T|\d+))\s+")
_REG_RE = re.compile(r"(?<![\w.$])(U?R\d+|U?P\d+|URZ|RZ|UPT|PT)(\.64)?(?![\w$])")
_LABEL_TARGET_RE = re.compile(r"`\(([^)]*)\)")
_ADDR_TARGET_RE = re.compile(r"^(0x[0-9a-fA-F]+)$")

# registers that read as constants (zero, true): no def-use edge
CONSTANT_REGS = frozenset({"RZ", "URZ", "PT", "UPT"})
BRANCHES = frozenset({"BRA", "JMP"})
# opcodes whose first operand is read, not written (stores, reductions into
# memory, control flow, barriers and fences)
NO_DEST = frozenset({
    "ST", "STG", "STS", "STL", "STSM", "RED", "REDG", "REDAS", "BRA", "JMP",
    "BRX", "JMX", "CALL", "RET", "EXIT", "BPT", "NOP", "BAR", "BSSY",
    "BSYNC", "WARPSYNC", "MEMBAR", "FENCE", "ERRBAR", "CCTL", "CCTLL",
    "DEPBAR", "SYNCS", "UBLKCP", "UTMALDG", "UTMASTG", "UTMAPF", "UBLKPF",
    "ARRIVES", "WARPGROUP", "KILL", "YIELD", "NANOSLEEP", "ACQBULK",
    "UCGABAR_ARV", "UCGABAR_WAIT", "ELECT",
})


def base_name(mangled: str) -> tuple[str, str]:
    """(base name, what follows it) of an Itanium-mangled function name:
    ``_Z13stream_kernelILi1ELi8EEvPKf`` -> (``stream_kernel``,
    ``ILi1ELi8EEvPKf``). Nested names (``_ZN...E``) give their last
    component; a name that is not mangled is its own base."""
    if not mangled.startswith("_Z"):
        return mangled, ""
    s = mangled[2:]
    if s.startswith("L"):
        s = s[1:]
    nested = s.startswith("N")
    if nested:
        s = s[1:]
    name = ""
    while True:
        m = re.match(r"(\d+)", s)
        if not m:
            break
        n = int(m.group(1))
        start = len(m.group(1))
        name, s = s[start:start + n], s[start + n:]
        if not nested or s.startswith(("I", "E")):
            break
    if nested and s.startswith("E"):
        s = s[1:]
    return (name or mangled), s


@dataclasses.dataclass
class Instr:
    """One SASS instruction."""
    addr: int
    opcode: str                  # with modifiers: "LDG.E.128"
    guard: str                   # "" or the predicate, e.g. "!P0"
    dst: tuple                   # registers written
    src: tuple                   # registers read (the guard included)
    target: Optional[str] = None  # branch target: "0x1f0" or a label
    depth: int = 0               # loops holding it
    text: str = ""

    @property
    def op(self) -> str:
        """The opcode without modifiers."""
        return self.opcode.split(".")[0]


@dataclasses.dataclass
class Function:
    """One function of the dump: its mangled name, base name and
    instructions in address order."""
    name: str
    instrs: list
    labels: dict                 # label -> address

    @property
    def base(self) -> str:
        return base_name(self.name)[0]

    @property
    def tail(self) -> str:
        """The mangled name after the base name (template arguments first)."""
        return base_name(self.name)[1]


def _split_operands(text: str) -> list[str]:
    """Operands split at the commas outside brackets and backquotes."""
    out, depth, cur, quoted = [], 0, [], False
    for ch in text:
        if ch == "`":
            quoted = not quoted
        elif not quoted and ch in "[(":
            depth += 1
        elif not quoted and ch in "])":
            depth -= 1
        if ch == "," and depth == 0 and not quoted:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


def dest_width(opcode: str) -> int:
    """Registers one destination operand of ``opcode`` spans (pairs for
    64-bit results, quads for 128-bit loads and tensor-core tiles)."""
    parts = opcode.split(".")
    op, mods = parts[0], parts[1:]
    if "128" in mods:
        return 4
    if op == "HMMA":
        return 4 if "F32" in mods else 2
    if op == "LDSM":
        return int(mods[-1]) if mods and mods[-1].isdigit() else 1
    if "64" in mods or "WIDE" in mods or op in ("DADD", "DFMA", "DMUL"):
        return 2
    return 1


STORES = frozenset({"ST", "STG", "STS", "STL", "RED", "REDG", "ATOM",
                    "ATOMG", "ATOMS"})


def source_width(opcode: str, index: int, n_operands: int) -> int:
    """Registers a bare source register at operand ``index`` spans: the data
    of a wide store, the 64-bit addend of ``IMAD.WIDE``, FP64 operands and
    tensor-core fragments; 1 otherwise (a 32-bit value: ``IMAD.WIDE R4, R3,
    0x4, R6`` reads R3 alone and the pair R6, R7)."""
    parts = opcode.split(".")
    op, mods = parts[0], parts[1:]
    if op in STORES:
        return dest_width(opcode)
    if op == "IMAD" and "WIDE" in mods:
        return 2 if index == n_operands - 1 else 1
    if op in ("DADD", "DFMA", "DMUL", "DSETP"):
        return 2
    if op in ("HMMA", "IMMA"):
        return 4
    return 1


def _regs(operand: str, width: int = 1) -> list[str]:
    """The registers an operand names; ``Rn.64`` is the pair Rn, Rn+1 and a
    bare ``Rn`` spans ``width`` registers. Constants (RZ, PT) are left out."""
    out = []
    for name, pair in _REG_RE.findall(operand):
        if name in CONSTANT_REGS:
            continue
        n = 2 if pair else (width if name[0] == "R" or name[:2] == "UR" else 1)
        m = re.match(r"(U?[RP])(\d+)", name)
        prefix, idx = m.group(1), int(m.group(2))
        out.extend(f"{prefix}{idx + j}" for j in range(n))
    return out


def parse_instr(addr: int, text: str) -> Instr:
    """One instruction from its text (the line between the address comment
    and the ``;``)."""
    guard = ""
    m = _GUARD_RE.match(text)
    if m:
        guard = m.group(1)
        text = text[m.end():]
    opcode, _, rest = text.strip().partition(" ")
    ops = _split_operands(rest)
    op = opcode.split(".")[0]
    dst, src = [], []
    target = None
    if op in BRANCHES and ops:
        last = ops[-1]
        lm = _LABEL_TARGET_RE.search(last)
        am = _ADDR_TARGET_RE.match(last.strip())
        if lm:
            target = lm.group(1)
        elif am:
            target = am.group(1).lower()
        ops = ops[:-1] if (lm or am) else ops
    first_is_dest = (ops and op not in NO_DEST and "[" not in ops[0]
                     and _REG_RE.search(ops[0]) is not None)
    rest_ops = ops
    if first_is_dest:
        dst.extend(_regs(ops[0], dest_width(opcode)))
        i = 1
        # carry-out and compare results: the predicates right after it
        while (i < len(ops)
               and re.fullmatch(r"U?P(?:T|\d+)", ops[i].strip())):
            dst.extend(_regs(ops[i]))
            i += 1
        rest_ops = ops[i:]
    first = len(ops) - len(rest_ops)
    for j, operand in enumerate(rest_ops, start=first):
        inside = "[" in operand
        src.extend(_regs(operand, 1 if inside
                         else source_width(opcode, j, len(ops))))
    if guard:
        src.extend(_regs(guard.lstrip("!")))
    return Instr(addr=addr, opcode=opcode, guard=guard, dst=tuple(dst),
                 src=tuple(src), target=target, text=text.strip())


def _loop_depths(fn: Function) -> None:
    """Set each instruction's depth from the function's backward branches."""
    loops = []
    for ins in fn.instrs:
        if ins.op not in BRANCHES or ins.target is None:
            continue
        if ins.target.startswith("0x"):
            tgt = int(ins.target, 16)
        elif ins.target in fn.labels:
            tgt = fn.labels[ins.target]
        else:
            continue
        if tgt < ins.addr:
            loops.append((tgt, ins.addr))
    for ins in fn.instrs:
        ins.depth = sum(1 for lo, hi in loops if lo <= ins.addr <= hi)


def parse_sass(text: str) -> dict[str, Function]:
    """{mangled name: Function} of every function in a ``cuobjdump -sass``
    dump, in the order they appear, each instruction with its loop depth."""
    funcs: dict[str, Function] = {}
    cur: Optional[Function] = None
    pending: list[str] = []
    for line in text.splitlines():
        m = _FUNC_RE.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), Function(m.group(1), [], {}))
            pending = []
            continue
        if cur is None:
            continue
        m = _INSTR_RE.match(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                cur.labels[label] = addr
            pending = []
            cur.instrs.append(parse_instr(addr, m.group(2)))
            continue
        m = _LABEL_RE.match(line)
        if m:
            pending.append(m.group(1))
    for fn in funcs.values():
        _loop_depths(fn)
    return funcs


def select(text: str, functions) -> str:
    """The part of a dump holding only the functions ``functions`` selects:
    (base name, mangled-tail prefix) pairs, the prefix naming template
    arguments (``("t3_kernel", "ILi0E")``) or "" for any instance."""
    keep, out = False, []
    for line in text.splitlines():
        m = _FUNC_RE.match(line)
        if m:
            base, tail = base_name(m.group(1))
            keep = any(base == b and tail.startswith(p) for b, p in functions)
        if keep:
            out.append(line)
    return "\n".join(out) + ("\n" if out else "")
