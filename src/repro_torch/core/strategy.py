"""Declarative strategy trees: the classifier's decision logic as data.

The paper's decision table (§4.2 / Table 3) was originally an if-chain in
the reference package's ``classify``. This module re-expresses it as a
STRATEGY TREE loaded from ``strategies/*.yaml``: an ordered list of nodes,
each a boolean predicate over the resolved mode slots and the LOW/HIGH
thresholds; the first node whose predicate holds names the bottleneck,
its separation expression scores the confidence, and its explanation
template renders the human-readable rationale. New vocabularies or
backends add a YAML file, not classifier code — and every classification
now carries the evaluated decision path (which nodes were tried, which
fired, under which thresholds), the raw material for
``fleet doctor --explain``.

Schema (``strategies/default.yaml`` is the reference):

* ``strategy: 1`` — schema version;
* ``name`` — the tree's name (echoed in decision paths);
* ``slots`` — mapping slot name -> ordered mode-alias list; the first
  alias present in the signature binds the slot (None when absent);
* ``groups`` — mapping group name -> mode-name prefix; the group binds
  to the sub-signature of modes with that prefix (``icis: "ici"``);
* ``nodes`` — ordered list; each node has ``name``, ``label``, ``when``
  (a guarded boolean expression over slots/groups/``known``/``low``/
  ``high``), exactly one of ``sep`` (separation expression, clamped to a
  confidence by ``sep / high`` into [0, 1]) or ``fixed`` (literal
  confidence), and ``explanation`` (a ``str.format`` template; for each
  group prefix ``p`` the key ``worst_p`` names the group's worst mode).

Expressions are compiled once at load and evaluated with empty builtins
against a whitelisted namespace — slot/group names, ``known`` (the
non-None slots), ``low``/``high``, and ``min``/``max``/``bool``/``abs``.
Comprehensions, lambdas and any other name are rejected at load time.

Trees resolve from the repo's ``strategies/`` directory (override with
``REPRO_STRATEGY_DIR``). Files parse with PyYAML when available and with
the built-in YAML-subset parser otherwise (the test suite pins both
parsers to agree on every shipped tree).

This is the PyTorch package's own copy of the reference's strategy module
(the reference's ``repro.core`` package imports jax on import). It reads
the same ``strategies/*.yaml`` files. One deliberate difference: the
comprehension/lambda guard walks the expression's AST. The reference
inspects ``co_consts`` for nested code objects, which Python 3.12 no
longer creates for inlined comprehensions (PEP 709).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Mapping, Optional

STRATEGY_SCHEMA = 1

# the strategies/ directory sits at the repo root, next to src/ (this file
# is src/repro_torch/core/strategy.py)
_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
STRATEGY_DIR_VAR = "REPRO_STRATEGY_DIR"

# names an expression may reference beyond the tree's slots/groups
_BASE_NAMES = frozenset({"known", "low", "high", "min", "max", "bool", "abs"})
# attribute/method names (compile() lists them in co_names too)
_ATTR_NAMES = frozenset({"values", "keys", "items", "get"})


# expression nodes that would open a nested scope (rejected at load time)
_FORBIDDEN_NODES = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp,
                    ast.Lambda)


class StrategyError(ValueError):
    """A strategy tree failed to load, validate, or decide."""


# ---------------------------------------------------------------------------
# YAML-subset parser (fallback when PyYAML is absent at runtime)
# ---------------------------------------------------------------------------

def _parse_scalar(s: str) -> Any:
    if s.startswith('"') and s.endswith('"') and len(s) >= 2:
        body = s[1:-1]
        if "\\" in body or '"' in body:
            raise StrategyError(
                f"escaped/nested quotes unsupported by the subset parser: {s!r}")
        return body
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(p.strip()) for p in inner.split(",")]
    if s in ("true", "True"):
        return True
    if s in ("false", "False"):
        return False
    if s in ("null", "~"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _parse_block(items: list, i: int, indent: int):
    if items[i][1].startswith("- "):
        out_list: list = []
        while (i < len(items) and items[i][0] == indent
               and items[i][1].startswith("- ")):
            head = items[i][1][2:].strip()
            j = i + 1
            children = []
            while j < len(items) and items[j][0] > indent:
                children.append(items[j])
                j += 1
            sub = [(indent + 2, head)] + children
            val, used = _parse_block(sub, 0, indent + 2)
            if used != len(sub):
                raise StrategyError(f"unparsed lines in list item near {head!r}")
            out_list.append(val)
            i = j
        return out_list, i
    out: dict = {}
    while (i < len(items) and items[i][0] == indent
           and not items[i][1].startswith("- ")):
        line = items[i][1]
        key, sep, rest = line.partition(":")
        if not sep or not key.strip():
            raise StrategyError(f"expected 'key: value', got {line!r}")
        key, rest = key.strip(), rest.strip()
        if rest:
            out[key] = _parse_scalar(rest)
            i += 1
        else:
            j = i + 1
            if j >= len(items) or items[j][0] <= indent:
                out[key] = None
                i = j
            else:
                out[key], i = _parse_block(items, j, items[j][0])
    return out, i


def _parse_simple_yaml(text: str) -> Any:
    """Parse the YAML subset ``strategies/*.yaml`` is written in: nested
    maps by 2-space indent, block lists of maps (``- key: value``), flow
    lists of scalars, double-quoted strings, ints/floats/bools/null, and
    full-line ``#`` comments. The test suite asserts this agrees with
    ``yaml.safe_load`` on every shipped tree, so environments without
    PyYAML load byte-identical strategies."""
    items = []
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        items.append((len(raw) - len(raw.lstrip(" ")), raw.strip()))
    if not items:
        return None
    value, used = _parse_block(items, 0, items[0][0])
    if used != len(items):
        raise StrategyError(
            f"unparsed trailing content near {items[used][1]!r}")
    return value


def _load_yaml(text: str) -> Any:
    try:
        import yaml
    except ModuleNotFoundError:
        return _parse_simple_yaml(text)
    return yaml.safe_load(text)


# ---------------------------------------------------------------------------
# Guarded expressions
# ---------------------------------------------------------------------------

def _compile_expr(expr: Any, allowed: frozenset, where: str):
    if not isinstance(expr, str):
        raise StrategyError(f"{where}: expression must be a string, "
                            f"got {type(expr).__name__}")
    try:
        code = compile(expr, f"<{where}>", "eval")
    except SyntaxError as e:
        raise StrategyError(f"{where}: {e}") from None
    tree = ast.parse(expr, mode="eval")
    if any(isinstance(node, _FORBIDDEN_NODES) for node in ast.walk(tree)):
        raise StrategyError(
            f"{where}: comprehensions/lambdas are not allowed")
    bad = sorted(set(code.co_names) - allowed - _ATTR_NAMES)
    if bad:
        raise StrategyError(
            f"{where}: expression references unknown name(s) {bad} "
            f"(allowed: {sorted(allowed)})")
    return code


def _eval(code, namespace: dict):
    return eval(code, {"__builtins__": {}}, namespace)  # noqa: S307 (guarded)


@dataclasses.dataclass(frozen=True)
class StrategyNode:
    """One compiled decision node: predicate -> label + confidence +
    explanation template."""
    name: str
    label: str
    when: Any                       # compiled boolean expression
    sep: Optional[Any]              # compiled separation expression, or None
    fixed: Optional[float]          # literal confidence when sep is None
    explanation: str


@dataclasses.dataclass(frozen=True)
class Decision:
    """What a tree decided for one signature, plus the evaluated path."""
    label: str
    confidence: float
    explanation: str
    path: dict


class StrategyTree:
    """An ordered, compiled decision tree loaded from a strategy spec."""

    def __init__(self, spec: Mapping, *, source: str = "<spec>"):
        if not isinstance(spec, Mapping):
            raise StrategyError(f"{source}: strategy spec must be a mapping")
        if spec.get("strategy") != STRATEGY_SCHEMA:
            raise StrategyError(
                f"{source}: unsupported strategy schema "
                f"{spec.get('strategy')!r} (want {STRATEGY_SCHEMA})")
        self.source = source
        self.name = str(spec.get("name") or "unnamed")
        slots = spec.get("slots") or {}
        groups = spec.get("groups") or {}
        if not isinstance(slots, Mapping) or not slots:
            raise StrategyError(f"{source}: 'slots' must be a non-empty map")
        self.slots = {str(s): [str(a) for a in aliases]
                      for s, aliases in slots.items()}
        self.groups = {str(g): str(p) for g, p in (groups or {}).items()}
        allowed = frozenset(self.slots) | frozenset(self.groups) | _BASE_NAMES
        nodes = spec.get("nodes")
        if not isinstance(nodes, list) or not nodes:
            raise StrategyError(f"{source}: 'nodes' must be a non-empty list")
        self.nodes: list[StrategyNode] = []
        for n in nodes:
            name = str(n.get("name") or f"node{len(self.nodes)}")
            where = f"{self.name}.{name}"
            if not n.get("label"):
                raise StrategyError(f"{where}: missing 'label'")
            if ("sep" in n) == ("fixed" in n):
                raise StrategyError(
                    f"{where}: exactly one of 'sep'/'fixed' required")
            if not isinstance(n.get("explanation"), str):
                raise StrategyError(f"{where}: missing 'explanation'")
            self.nodes.append(StrategyNode(
                name=name, label=str(n["label"]),
                when=_compile_expr(n.get("when"), allowed, f"{where}.when"),
                sep=(_compile_expr(n["sep"], allowed, f"{where}.sep")
                     if "sep" in n else None),
                fixed=(float(n["fixed"]) if "fixed" in n else None),
                explanation=n["explanation"]))

    @classmethod
    def from_file(cls, path: str) -> "StrategyTree":
        """Load and compile one ``strategies/*.yaml`` tree."""
        with open(path) as f:
            text = f.read()
        return cls(_load_yaml(text), source=path)

    def decide(self, absorptions: Mapping[str, float], *, low: float,
               high: float) -> Decision:
        """Evaluate the tree against one absorption signature.

        Nodes are tried in order; the first truthy predicate fires. The
        returned :class:`Decision` carries the full evaluated path: bound
        slots/groups, the thresholds, every node tried with its outcome."""
        slots: dict[str, Optional[float]] = {}
        for slot, aliases in self.slots.items():
            v = None
            for a in aliases:
                if a in absorptions:
                    v = absorptions[a]
                    break
            slots[slot] = v
        groups = {g: {m: a for m, a in absorptions.items()
                      if m.startswith(p)} for g, p in self.groups.items()}
        known = {s: v for s, v in slots.items() if v is not None}
        namespace = {**slots, **groups, "known": known, "low": low,
                     "high": high, "min": min, "max": max, "bool": bool,
                     "abs": abs}
        fmt: dict[str, Any] = {"low": low, "high": high}
        for g, p in self.groups.items():
            members = groups[g]
            fmt[f"worst_{p}"] = (min(members, key=members.get)
                                 if members else "")
        tried = []
        fired: Optional[StrategyNode] = None
        for node in self.nodes:
            ok = bool(_eval(node.when, dict(namespace)))
            tried.append({"node": node.name, "fired": ok})
            if ok:
                fired = node
                break
        if fired is None:
            raise StrategyError(
                f"{self.source}: no node fired for signature "
                f"{dict(absorptions)!r} (the last node should be a "
                "catch-all with when: \"True\")")
        if fired.fixed is not None:
            confidence = fired.fixed
        else:
            sep = float(_eval(fired.sep, dict(namespace)))
            confidence = max(0.0, min(1.0, sep / high))
        try:
            explanation = fired.explanation.format(**fmt)
        except (KeyError, IndexError) as e:
            raise StrategyError(
                f"{self.name}.{fired.name}: explanation template "
                f"references unknown key {e}") from None
        path = {
            "strategy": self.name,
            "low": low,
            "high": high,
            "slots": slots,
            "groups": {g: dict(v) for g, v in groups.items()},
            "nodes": tried,
            "fired": fired.name,
            "label": fired.label,
        }
        return Decision(label=fired.label, confidence=confidence,
                        explanation=explanation, path=path)


# ---------------------------------------------------------------------------
# Tree resolution + cache
# ---------------------------------------------------------------------------

_TREES: dict[str, StrategyTree] = {}


def strategies_dir() -> str:
    """The directory strategy trees load from — the repo's ``strategies/``
    unless ``REPRO_STRATEGY_DIR`` overrides it."""
    return (os.environ.get(STRATEGY_DIR_VAR)
            or os.path.join(_REPO_ROOT, "strategies"))


def load_tree(name: str = "default") -> StrategyTree:
    """Load (and cache) ``strategies/<name>.yaml``."""
    path = os.path.abspath(os.path.join(strategies_dir(), name + ".yaml"))
    if path not in _TREES:
        _TREES[path] = StrategyTree.from_file(path)
    return _TREES[path]


def default_tree() -> StrategyTree:
    """The default tree — byte-identical decisions to the historical
    ``classify`` if-chain under the default thresholds (golden-pinned)."""
    return load_tree("default")
