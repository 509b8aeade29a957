"""Pluggable shard launchers — how a fleet's worker processes come to exist.

``run_fleet`` (executor.py) decides WHAT still needs launching from the
stores; a ``Launcher`` decides HOW a shard becomes a running worker. The
protocol is small — spawn shard(s), stream their output, report a
returncode per shard — so the executor's retry/merge/classify spine is the
same whether workers run as local subprocesses or inside a deterministic
fault-injection mock:

  * ``LocalLauncher``        — subprocess fan-out on this machine (the
    default), or sequential in-process execution (``run --in-process``);
  * ``MockClusterLauncher``  — deterministic fault injection: a script maps
    shard index -> per-attempt actions ("crash", "drop-point", "timeout",
    "dead", "ok"), so tests exercise the retry/heal path without hosts.

The reference's ``SSHLauncher`` (and its ``hosts.json``) is not ported.

Retry policy lives in ``RetryBudget``: ``max_attempts`` rounds per
``run_fleet`` call, exponential ``backoff`` between rounds, and an optional
lifetime ``per_shard_cap`` recorded across resumes in ``fleet.json``.

Every launcher hands workers two environment variables as a handshake:
``REPRO_FLEET_EXPECT_DIGEST`` (the plan digest the launcher is driving — the
worker refuses to run if its own plan file disagrees) and
``REPRO_FLEET_HOST`` (the host label the worker echoes back).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import threading
from typing import Mapping, Optional, Sequence

from repro_torch.fleet.plan import SweepPlan

log = logging.getLogger("repro_torch.fleet")

LAUNCHER_KINDS = ("local", "mock")
MOCK_ACTIONS = ("ok", "crash", "drop-point", "timeout", "dead")


class FleetError(RuntimeError):
    """Fleet-level failure the caller must act on (bad state, dead shards,
    unusable launcher config). Re-exported by ``repro_torch.fleet.executor``."""


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryBudget:
    """How persistently ``run_fleet`` re-launches failed/incomplete shards.

    ``max_attempts``   — launch rounds per ``run_fleet`` call (1: one launch,
                         then fail loudly);
    ``backoff``        — seconds to sleep before retry round r, doubled each
                         round (``backoff * 2**(r-2)``);
    ``per_shard_cap``  — LIFETIME attempts one shard may consume across
                         resumes (0 = unlimited), counted from the attempts
                         recorded in ``fleet.json``.
    """
    max_attempts: int = 1
    backoff: float = 0.0
    per_shard_cap: int = 0

    def __post_init__(self):
        """Reject nonsense budgets at construction time."""
        if self.max_attempts < 1:
            raise FleetError(f"retry max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.backoff < 0 or self.per_shard_cap < 0:
            raise FleetError("retry backoff and per_shard_cap must be >= 0")

    def delay(self, round_no: int) -> float:
        """Backoff (seconds) to sleep before launch round ``round_no``."""
        if round_no <= 1 or not self.backoff:
            return 0.0
        return self.backoff * (2 ** (round_no - 2))

    def to_dict(self) -> dict:
        """The plan-serializable form (``SweepPlan.retry``)."""
        return {"max_attempts": self.max_attempts, "backoff": self.backoff,
                "per_shard_cap": self.per_shard_cap}

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "RetryBudget":
        """Build from a plan's ``retry`` dict (missing keys -> defaults)."""
        d = dict(d or {})
        unknown = sorted(set(d) - {"max_attempts", "backoff", "per_shard_cap"})
        if unknown:
            raise FleetError(f"unknown retry setting(s) {unknown}; known: "
                             "max_attempts, backoff, per_shard_cap")
        return cls(max_attempts=int(d.get("max_attempts", 1)),
                   backoff=float(d.get("backoff", 0.0)),
                   per_shard_cap=int(d.get("per_shard_cap", 0)))


# ---------------------------------------------------------------------------
# the launcher protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardOutcome:
    """What one launched shard attempt reported back: its returncode and the
    host label it ran on (None when the launcher has no host notion)."""
    rc: int
    host: Optional[str] = None


class Launcher:
    """Spawn shard workers, stream their output, report a returncode each.

    Implementations override ``launch``; ``attempts`` maps each index to the
    shard's 1-based LIFETIME attempt ordinal (including attempts recorded in
    ``fleet.json`` by previous runs), so fault-injection scripts and logs
    stay deterministic across resumes. Completeness is never decided here —
    the executor re-derives it from the stores after every round.
    """

    name = "?"

    def launch(self, plan_path: str, plan: SweepPlan,
               indices: Sequence[int], *,
               attempts: Optional[Mapping[int, int]] = None
               ) -> dict[int, ShardOutcome]:
        """Run the given shard indices; return {index: ShardOutcome}."""
        raise NotImplementedError


def worker_env(plan: Optional[SweepPlan] = None,
               host: Optional[str] = None) -> dict:
    """The environment a spawned worker needs: the port's src dir on
    PYTHONPATH (so ``-m repro_torch.launch.probe`` resolves however the
    parent was launched) plus the launcher->worker handshake variables."""
    import repro_torch

    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ)
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if src not in parts:
        env["PYTHONPATH"] = os.pathsep.join([src] + parts)
    if plan is not None:
        env["REPRO_FLEET_EXPECT_DIGEST"] = plan.digest()
    if host:
        env["REPRO_FLEET_HOST"] = host
    return env


def _pump(pipe, prefix: str) -> None:
    """Stream a worker's merged stdout/stderr line-prefixed to our stdout."""
    for line in pipe:
        print(prefix + line.rstrip("\n"), flush=True)


def _run_worker_inline(plan_path: str, plan: SweepPlan, index: int) -> int:
    """Execute one shard in THIS process (re-loading the plan from disk like
    a real worker would); exceptions become nonzero returncodes."""
    from repro_torch.fleet.executor import run_worker

    try:
        run_worker(SweepPlan.load(plan_path), index=index, count=plan.shards)
        return 0
    except SystemExit as e:
        return int(bool(e.code))
    except Exception:
        log.warning("in-process shard %d failed", index, exc_info=True)
        return 1


# ---------------------------------------------------------------------------
# LocalLauncher — subprocess fan-out / in-process execution on this machine
# ---------------------------------------------------------------------------


class LocalLauncher(Launcher):
    """Workers on THIS machine.

    Default: one ``python -m repro_torch.launch.probe --plan P --shard i/N``
    subprocess per index, all concurrent, output streamed line-prefixed.
    Co-located shards share the machine — and the card — so their timings
    interfere: that is the fan-out's price, and it proves the spawn and
    merge path rather than the verdicts. ``in_process=True`` runs shards
    sequentially inside this process instead (spawn-restricted
    environments and fast tests).
    """

    def __init__(self, *, in_process: bool = False):
        """``in_process``: sequential same-process workers instead of
        concurrent subprocesses."""
        self.in_process = bool(in_process)
        self.name = "in-process" if in_process else "local"

    def launch(self, plan_path: str, plan: SweepPlan,
               indices: Sequence[int], *,
               attempts: Optional[Mapping[int, int]] = None
               ) -> dict[int, ShardOutcome]:
        """Spawn (or inline-run) every index; see class docstring."""
        if self.in_process:
            return {i: ShardOutcome(_run_worker_inline(plan_path, plan, i))
                    for i in indices}
        procs: dict[int, tuple] = {}
        env = worker_env(plan, host="localhost")
        for i in indices:
            cmd = [sys.executable, "-m", "repro_torch.launch.probe",
                   "--plan", plan_path, "--shard", f"{i}/{plan.shards}"]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 bufsize=1, env=env)
            t = threading.Thread(
                target=_pump, args=(p.stdout, f"[shard {i}/{plan.shards}] "),
                daemon=True)
            t.start()
            procs[i] = (p, t)
        out: dict[int, ShardOutcome] = {}
        for i, (p, t) in procs.items():
            out[i] = ShardOutcome(p.wait(), "localhost")
            t.join(timeout=5)
        return out


# ---------------------------------------------------------------------------
# MockClusterLauncher — deterministic fault injection for tests
# ---------------------------------------------------------------------------


def _loads(line: str) -> dict:
    """Tolerant record parse for fault injection: a torn line is just not a
    match, never a crash."""
    try:
        rec = json.loads(line)
        return rec if isinstance(rec, dict) else {}
    except ValueError:
        return {}


def _store_lines(path: str) -> list[str]:
    with open(path) as f:
        return [ln for ln in f.read().split("\n") if ln]


def tear_store_tail(path: str) -> None:
    """Reproduce the damage a SIGKILL mid-append leaves in a worker store:
    drop the final ``done`` marker, then truncate mid-way into the (now)
    trailing record. ``read_store_records`` heals exactly this shape."""
    lines = _store_lines(path)
    done_idx = max((i for i, ln in enumerate(lines)
                    if _loads(ln).get("kind") == "done"), default=None)
    if done_idx is None:
        raise FleetError(f"{path}: no done-marked sweep to tear")
    rest = [ln for i, ln in enumerate(lines) if i != done_idx]
    with open(path, "wb") as f:
        f.write(("\n".join(rest) + "\n").encode()[:-9])


def _done_point_victim(recs: Sequence[dict]) -> Optional[int]:
    """Index (in replay order) of one done-promised point record, or None."""
    for i in range(len(recs) - 1, -1, -1):
        if recs[i].get("kind") == "done" and recs[i].get("ks"):
            key = (recs[i]["region"], recs[i]["mode"])
            ks = {int(k) for k in recs[i]["ks"]}
            for j in range(len(recs) - 1, -1, -1):
                r = recs[j]
                if (r.get("kind") == "point" and int(r.get("k", -1)) in ks
                        and (r.get("region"), r.get("mode")) == key):
                    return j
    return None


def drop_done_point(path: str) -> None:
    """Delete one done-promised ``point`` record while KEEPING its ``done``
    marker — the store shape a lost append or partial merge leaves behind;
    a relaunch re-measures only that point."""
    lines = _store_lines(path)
    victim = _done_point_victim([_loads(ln) for ln in lines])
    if victim is None:
        raise FleetError(f"{path}: no done-promised point to drop")
    del lines[victim]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


class MockClusterLauncher(Launcher):
    """Deterministic fault injection: a cluster that fails on schedule.

    ``script`` maps shard index -> a sequence of per-attempt actions; attempt
    n of shard i performs ``script[i][n-1]`` and every attempt past the end
    of the list is "ok". Attempt ordinals come from the executor's fleet
    ledger, so scripts stay deterministic across ``--resume`` runs. Actions:

      * "ok"         — run the worker in-process, rc 0;
      * "crash"      — run the worker, then tear the store tail like a
                       SIGKILL mid-append (``tear_store_tail``), rc -9;
      * "drop-point" — run the worker, then delete one done-promised point
                       (``drop_done_point``), rc -9;
      * "timeout"    — the worker never runs (a hung host), rc 124;
      * "dead"       — the worker never runs (host unreachable), rc 1.
    """

    name = "mock"
    DEFAULT_SCRIPT: Mapping = {0: ("crash",)}

    def __init__(self, script: Optional[Mapping] = None):
        """``script``: {shard_index: [action, ...]}; None -> DEFAULT_SCRIPT
        (shard 0 crashes on its first attempt, then recovers)."""
        src = self.DEFAULT_SCRIPT if script is None else script
        try:
            self.script = {int(i): tuple(acts)
                           for i, acts in dict(src).items()}
        except (TypeError, ValueError) as e:
            raise FleetError(f"mock script must map shard indices to "
                             f"action lists: {e}") from e
        bad = sorted({a for acts in self.script.values() for a in acts}
                     - set(MOCK_ACTIONS))
        if bad:
            raise FleetError(f"unknown mock action(s) {bad}; "
                             f"one of {list(MOCK_ACTIONS)}")
        self._seen: dict[int, int] = {}

    def action_for(self, index: int, attempt: int) -> str:
        """The scripted action for shard ``index``'s attempt ``attempt``
        (1-based); past the end of the script every attempt is "ok"."""
        acts = self.script.get(index, ())
        return acts[attempt - 1] if 1 <= attempt <= len(acts) else "ok"

    def launch(self, plan_path: str, plan: SweepPlan,
               indices: Sequence[int], *,
               attempts: Optional[Mapping[int, int]] = None
               ) -> dict[int, ShardOutcome]:
        """Run each index in-process, then apply its scripted fault."""
        out: dict[int, ShardOutcome] = {}
        for i in indices:
            n = (attempts or {}).get(i)
            if n is None:                 # standalone use: count locally
                n = self._seen.get(i, 0) + 1
            self._seen[i] = n
            action = self.action_for(i, n)
            host = f"mock-host-{i}"
            print(f"[mock] shard {i} attempt {n}: scripted action "
                  f"{action!r} on {host}")
            if action == "timeout":
                out[i] = ShardOutcome(124, host)
                continue
            if action == "dead":
                out[i] = ShardOutcome(1, host)
                continue
            rc = _run_worker_inline(plan_path, plan, i)
            ws = plan.worker_stores()[i]
            if rc == 0 and action == "crash":
                tear_store_tail(ws)
                rc = -9
            elif rc == 0 and action == "drop-point":
                drop_done_point(ws)
                rc = -9
            out[i] = ShardOutcome(rc, host)
        return out


# ---------------------------------------------------------------------------
# resolution: CLI flags / plan spec -> a Launcher instance
# ---------------------------------------------------------------------------


def resolve_launcher(kind: Optional[str] = None, *,
                     plan: Optional[SweepPlan] = None,
                     mock_script: Optional[Mapping] = None,
                     in_process: bool = False) -> Launcher:
    """Build the Launcher a fleet run should use.

    Explicit arguments (CLI flags) override the plan's declarative
    ``launcher`` spec; with neither, the default is a subprocess
    ``LocalLauncher``. ``mock_script`` overrides the plan's scripted faults
    for mock.
    """
    spec = dict(getattr(plan, "launcher", None) or {})
    kind = kind or spec.get("kind") or "local"
    if kind not in LAUNCHER_KINDS:
        raise FleetError(f"unknown launcher kind {kind!r}; "
                         f"one of {list(LAUNCHER_KINDS)}")
    if kind == "local":
        # silently dropping this would run a mock-shaped request as plain
        # local subprocesses
        if mock_script is not None:
            raise FleetError("--mock-script applies to the mock launcher; "
                             "pass --launcher mock (or declare launcher in "
                             "the plan)")
        return LocalLauncher(in_process=in_process
                             or bool(spec.get("in_process", False)))
    if in_process:
        raise FleetError(f"--in-process applies to the local launcher only, "
                         f"not {kind!r}")
    return MockClusterLauncher(mock_script if mock_script is not None
                               else spec.get("script"))
