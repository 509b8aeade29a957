"""Pluggable shard launchers — how a fleet's worker processes come to exist.

``run_fleet`` (executor.py) decides WHAT still needs launching from the
stores; a ``Launcher`` decides HOW a shard becomes a running worker. The
protocol is small — spawn shard(s), stream their output, report a
returncode per shard — so the executor's retry/merge/classify spine is the
same whether workers run as local subprocesses, over ssh on a cluster, or
inside a deterministic fault-injection mock:

  * ``LocalLauncher``        — subprocess fan-out on this machine (the
    default), or sequential in-process execution (``run --in-process``);
  * ``SSHLauncher``          — one worker per remote host from a declarative
    ``hosts.json`` spec ({addr, python, workdir, env}); pushes the plan (and
    any partial worker store) to the host, runs the standard worker entry
    there, and copies the worker store back so ``merge_stores`` works
    unchanged. Refuses to start, printing ``MANUAL_RECIPE``, when ssh or
    scp/rsync are missing;
  * ``MockClusterLauncher``  — deterministic fault injection: a script maps
    shard index -> per-attempt actions ("crash", "drop-point", "timeout",
    "dead", "ok"), so tests exercise the retry/heal path without hosts, in
    either store layout.

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
import posixpath
import shlex
import shutil
import subprocess
import sys
import threading
from typing import Mapping, Optional, Sequence

from repro_torch.fleet.plan import SweepPlan

log = logging.getLogger("repro_torch.fleet")

LAUNCHER_KINDS = ("local", "ssh", "mock")
MOCK_ACTIONS = ("ok", "crash", "drop-point", "timeout", "dead")

MANUAL_RECIPE = """\
ssh/scp not found on PATH — fall back to the manual multi-host recipe (the
plan file is the only coordination needed):
  1. copy the plan JSON to every host (same bytes => same digest => same grid)
  2. on host i of N:
       PYTHONPATH=src python -m repro_torch.launch.probe --plan plan.json \\
           --shard i/N
  3. copy each host's store.wIofN.jsonl back next to the local canonical store
  4. PYTHONPATH=src python -m repro_torch.fleet run --plan plan.json --resume
     (nothing left to launch, so it merges, classifies, writes the report)
A host that died mid-sweep just re-runs its step-2 command: the worker store
heals its torn tail and only the missing points are re-measured."""


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
# SSHLauncher — one worker per remote host from a hosts.json spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One remote host in an ``SSHLauncher`` fleet.

    ``addr``    — the ssh destination (``user@host`` or an ssh_config alias);
    ``python``  — the interpreter to run there (a venv path works);
    ``workdir`` — remote directory to cd into; the plan file is copied here
                  and the plan's (relative) store path resolves under it;
    ``env``     — extra environment exported before the worker starts
                  (e.g. ``{"PYTHONPATH": "src"}`` for a checkout).
    """
    addr: str
    python: str = "python3"
    workdir: str = "."
    env: tuple = ()          # tuple of (key, value) pairs; hashable

    @classmethod
    def from_dict(cls, d: Mapping) -> "HostSpec":
        """Build from one hosts.json entry; only ``addr`` is required."""
        if not d.get("addr"):
            raise FleetError(f"host spec {dict(d)!r} needs an 'addr'")
        unknown = sorted(set(d) - {"addr", "python", "workdir", "env"})
        if unknown:
            raise FleetError(f"host {d['addr']!r}: unknown key(s) {unknown}; "
                             "known: addr, python, workdir, env")
        return cls(addr=str(d["addr"]), python=str(d.get("python", "python3")),
                   workdir=str(d.get("workdir", ".")),
                   env=tuple(sorted((str(k), str(v))
                             for k, v in dict(d.get("env", {})).items())))


def load_hosts(path: str) -> list[HostSpec]:
    """Parse a hosts.json file: either a bare list of host specs or an
    object ``{"hosts": [...]}`` (see ``HostSpec`` for the entry keys)."""
    with open(path) as f:
        data = json.load(f)
    entries = data.get("hosts") if isinstance(data, dict) else data
    if not isinstance(entries, list) or not entries:
        raise FleetError(f"{path}: expected a non-empty list of host specs "
                         "(or {\"hosts\": [...]})")
    return [HostSpec.from_dict(h) for h in entries]


class SSHLauncher(Launcher):
    """One worker per remote host, coordinated only by the plan file.

    Per shard i: pick host ``hosts[i % len(hosts)]``, push the plan (and the
    shard's partial worker store, if any — so retries on a different host
    still re-measure only missing points), run the standard worker entry
    under the handshake env, stream its output line-prefixed, then copy the
    worker store (+ stats) back through a per-host staging name
    (``repro_torch.core.campaign.host_store``) and atomically rename it into
    place. ``merge_stores`` and classification see exactly the same files a
    local fan-out produces.

    Requires a RELATIVE plan store path (it must resolve under each host's
    workdir). When ssh/scp are missing this launcher refuses to start and
    prints ``MANUAL_RECIPE`` instead — the documented by-hand flow.
    """

    name = "ssh"

    def __init__(self, hosts: Sequence[HostSpec]):
        """``hosts``: the fleet's host ring (shard i -> hosts[i % len])."""
        if not hosts:
            raise FleetError("SSHLauncher needs at least one host "
                             "(--hosts hosts.json)")
        self.hosts = list(hosts)

    # -- availability -------------------------------------------------------
    @staticmethod
    def available() -> bool:
        """True when both ssh and a file-copy tool (rsync or scp) exist."""
        return bool(shutil.which("ssh")
                    and (shutil.which("rsync") or shutil.which("scp")))

    def _require_available(self) -> None:
        """Degrade loudly: no ssh/scp -> FleetError carrying the manual
        multi-host recipe."""
        if not self.available():
            raise FleetError(MANUAL_RECIPE)

    # -- host/shard geometry ------------------------------------------------
    def host_for(self, index: int) -> HostSpec:
        """The host shard ``index`` runs on (round-robin over the ring)."""
        return self.hosts[index % len(self.hosts)]

    # -- command construction (unit-testable without a live host) -----------
    @staticmethod
    def _copy_cmd(src: str, dst: str) -> list[str]:
        """rsync (preferred) or scp argv copying ``src`` to ``dst``; either
        side may be a ``host:path`` remote."""
        if shutil.which("rsync"):
            return ["rsync", "-az", "-e", "ssh -o BatchMode=yes", src, dst]
        return ["scp", "-q", "-o", "BatchMode=yes", src, dst]

    def _remote_command(self, host: HostSpec, plan: SweepPlan,
                        plan_base: str, index: int) -> list[str]:
        """The full ssh argv that runs shard ``index`` on ``host``: cd into
        the workdir, export the handshake + host env, exec the worker."""
        ws = plan.worker_stores()[index]
        # handshake keys merge LAST: a hosts.json env block must never be
        # able to clobber the digest check the handshake exists to enforce
        exports = {**dict(host.env),
                   "REPRO_FLEET_EXPECT_DIGEST": plan.digest(),
                   "REPRO_FLEET_HOST": host.addr}
        parts = [f"cd {shlex.quote(host.workdir)}"]
        d = posixpath.dirname(ws)
        if d:
            parts.append(f"mkdir -p {shlex.quote(d)}")
        # a stale stats file from a previous attempt on this host must not
        # be pulled back and credited to an attempt whose worker never
        # finished (run_worker writes stats only on completion)
        parts.append(f"rm -f {shlex.quote(ws + '.stats.json')}")
        env_str = " ".join(f"{k}={shlex.quote(v)}"
                           for k, v in sorted(exports.items()))
        parts.append(f"env {env_str} {host.python} -m "
                     "repro_torch.launch.probe "
                     f"--plan {shlex.quote(plan_base)} "
                     f"--shard {index}/{plan.shards}")
        return ["ssh", "-o", "BatchMode=yes", host.addr, " && ".join(parts)]

    # -- file movement ------------------------------------------------------
    @staticmethod
    def _run_quiet(cmd: list[str]) -> int:
        """Run a copy/setup command, logging (not raising) on failure."""
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            log.warning("ssh launcher: %s failed (rc=%d): %s",
                        " ".join(cmd[:2]), res.returncode,
                        (res.stdout or "").strip()[-500:])
        return res.returncode

    def _push(self, host: HostSpec, plan_path: str, plan: SweepPlan,
              index: int) -> int:
        """Stage the plan (and any partial worker store) onto the host."""
        ws = plan.worker_stores()[index]
        rdir = posixpath.join(host.workdir, posixpath.dirname(ws)) \
            if posixpath.dirname(ws) else host.workdir
        rc = self._run_quiet(["ssh", "-o", "BatchMode=yes", host.addr,
                              f"mkdir -p {shlex.quote(rdir)}"])
        if rc:
            return rc
        remote_plan = posixpath.join(host.workdir,
                                     os.path.basename(plan_path))
        rc = self._run_quiet(self._copy_cmd(
            plan_path, f"{host.addr}:{remote_plan}"))
        if rc:
            return rc
        if os.path.exists(ws):      # partial store: let the host heal/resume
            rc = self._run_quiet(self._copy_cmd(
                ws, f"{host.addr}:{posixpath.join(host.workdir, ws)}"))
        return rc

    def _pull(self, host: HostSpec, plan: SweepPlan, index: int) -> int:
        """Fetch the worker store (+ stats) back through the per-host
        staging name, then atomically rename over the local path."""
        from repro_torch.core.campaign import host_store

        ws = plan.worker_stores()[index]
        d = os.path.dirname(ws)
        if d:
            os.makedirs(d, exist_ok=True)
        for remote, local in ((ws, ws), (ws + ".stats.json",
                                         ws + ".stats.json")):
            stage = host_store(local, host.addr)
            rc = self._run_quiet(self._copy_cmd(
                f"{host.addr}:{posixpath.join(host.workdir, remote)}", stage))
            if rc and local == ws:
                return rc           # no store came back: the attempt failed
            if not rc and os.path.exists(stage):
                os.replace(stage, local)
        return 0

    # -- the protocol -------------------------------------------------------
    def launch(self, plan_path: str, plan: SweepPlan,
               indices: Sequence[int], *,
               attempts: Optional[Mapping[int, int]] = None
               ) -> dict[int, ShardOutcome]:
        """Push plan+store, run the worker over ssh, pull the store back —
        one thread per shard, concurrently across hosts."""
        self._require_available()
        if os.path.isabs(plan.store):
            raise FleetError(
                f"SSHLauncher needs a RELATIVE plan store path (it resolves "
                f"under each host's workdir); got {plan.store!r} — rebuild "
                "the plan with a relative --store")
        plan_base = os.path.basename(plan_path)
        out: dict[int, ShardOutcome] = {}
        lock = threading.Lock()

        def one(i: int) -> None:
            host = self.host_for(i)
            rc = self._push(host, plan_path, plan, i)
            if rc:
                with lock:
                    out[i] = ShardOutcome(255, host.addr)
                return
            p = subprocess.Popen(self._remote_command(host, plan, plan_base,
                                                      i),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 bufsize=1)
            _pump(p.stdout, f"[shard {i}/{plan.shards} @ {host.addr}] ")
            rc = p.wait()
            pull_rc = self._pull(host, plan, i)
            if pull_rc and rc == 0:
                rc = 255            # worker "succeeded" but store never landed
            with lock:
                out[i] = ShardOutcome(rc, host.addr)

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in indices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
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


def _store_segment_files(path: str) -> tuple[dict, list]:
    """A segmented store's ``(manifest, [(name, entry_or_None, lines)])`` in
    replay order — manifest segments first, then unfolded orphans by name."""
    from repro_torch.core.segments import load_manifest, segments_dir

    sdir = segments_dir(path)
    m = load_manifest(sdir)
    listed = {e["file"] for e in m["segments"]}
    folded = set(m["folded"])
    order = [(e["file"], e) for e in m["segments"]]
    order += [(n, None) for n in sorted(os.listdir(sdir))
              if n.endswith(".jsonl") and n not in listed
              and n[:-len(".jsonl")] not in folded]
    out = []
    for name, ent in order:
        with open(os.path.join(sdir, name)) as f:
            out.append((name, ent,
                        [ln for ln in f.read().split("\n") if ln]))
    return m, out


def _torn(lines: Sequence[str]) -> Optional[bytes]:
    """The torn-tail byte image of ``lines``: last ``done`` marker dropped,
    then truncated mid-way into the (now) trailing record. None when there
    is no done marker to tear."""
    done_idx = max((i for i, ln in enumerate(lines)
                    if _loads(ln).get("kind") == "done"), default=None)
    if done_idx is None:
        return None
    rest = [ln for i, ln in enumerate(lines) if i != done_idx]
    return ("\n".join(rest) + "\n").encode()[:-9]


def tear_store_tail(path: str) -> None:
    """Reproduce the damage a SIGKILL mid-append leaves in a worker store:
    drop the final ``done`` marker, then truncate mid-way into the (now)
    trailing record. ``read_store_records`` heals exactly this shape.

    On a segmented store the same crash leaves a different artifact: the
    writer dies before SEALING, so its done-bearing segment must lose its
    manifest entry (becoming an unsealed orphan) as well as its tail — the
    shape the next writable open heals."""
    from repro_torch.core.segments import (is_segmented, save_manifest,
                                           segments_dir)

    if not is_segmented(path):
        lines = [ln for ln in open(path).read().split("\n") if ln]
        data = _torn(lines)
        if data is None:
            raise FleetError(f"{path}: no done-marked sweep to tear")
        with open(path, "wb") as f:
            f.write(data)
        return
    sdir = segments_dir(path)
    m, files = _store_segment_files(path)
    for name, ent, lines in reversed(files):
        data = _torn(lines)
        if data is None:
            continue
        with open(os.path.join(sdir, name), "wb") as f:
            f.write(data)
        if ent is not None:     # un-seal: the crash shape is an orphan
            m["segments"] = [e for e in m["segments"] if e is not ent]
            save_manifest(sdir, m)
        return
    raise FleetError(f"{path}: no done-marked sweep to tear")


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
    marker — the store shape a lost append or partial merge leaves behind.
    ``pair_status`` then names exactly which (pair, k) is missing, and a
    relaunch re-measures only that point. On a segmented store the victim's
    segment is rewritten and its manifest entry (bytes/records/coverage)
    updated, so the store still loads cleanly — the damage is semantic, not
    structural."""
    from repro_torch.core import segments as seg_mod

    if not seg_mod.is_segmented(path):
        lines = [ln for ln in open(path).read().split("\n") if ln]
        victim = _done_point_victim([_loads(ln) for ln in lines])
        if victim is None:
            raise FleetError(f"{path}: no done-promised point to drop")
        del lines[victim]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return
    sdir = seg_mod.segments_dir(path)
    m, files = _store_segment_files(path)
    flat = [(fi, li) for fi, (_, _, lines) in enumerate(files)
            for li in range(len(lines))]
    victim = _done_point_victim(
        [_loads(files[fi][2][li]) for fi, li in flat])
    if victim is None:
        raise FleetError(f"{path}: no done-promised point to drop")
    fi, li = flat[victim]
    name, ent, lines = files[fi]
    del lines[li]
    fp = os.path.join(sdir, name)
    with open(fp, "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    if ent is not None:         # keep the sealed entry honest about the file
        ent["bytes"] = os.path.getsize(fp)
        ent["records"] = len(lines)
        ent["pairs"] = seg_mod._coverage(_loads(ln) for ln in lines)
        seg_mod.save_manifest(sdir, m)


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
                     hosts_path: Optional[str] = None,
                     mock_script: Optional[Mapping] = None,
                     in_process: bool = False) -> Launcher:
    """Build the Launcher a fleet run should use.

    Explicit arguments (CLI flags) override the plan's declarative
    ``launcher`` spec; with neither, the default is a subprocess
    ``LocalLauncher``. ``hosts_path`` loads a hosts.json for ssh;
    ``mock_script`` overrides the plan's scripted faults for mock.
    """
    spec = dict(getattr(plan, "launcher", None) or {})
    kind = kind or spec.get("kind") or "local"
    if kind not in LAUNCHER_KINDS:
        raise FleetError(f"unknown launcher kind {kind!r}; "
                         f"one of {list(LAUNCHER_KINDS)}")
    if kind == "local":
        # silently dropping these would run an ssh/mock-shaped request as
        # plain local subprocesses — the sweep would land on the wrong hosts
        if hosts_path or mock_script is not None:
            raise FleetError(
                "--hosts/--mock-script apply to the ssh/mock launchers; "
                "pass --launcher ssh|mock (or declare launcher in the plan)")
        return LocalLauncher(in_process=in_process
                             or bool(spec.get("in_process", False)))
    if in_process:
        raise FleetError(f"--in-process applies to the local launcher only, "
                         f"not {kind!r}")
    if kind == "ssh":
        if hosts_path:
            hosts = load_hosts(hosts_path)
        else:
            hosts = [HostSpec.from_dict(h) for h in spec.get("hosts", [])]
        if not hosts:
            raise FleetError("ssh launcher needs hosts: pass --hosts "
                             "hosts.json or declare launcher.hosts in the "
                             "plan")
        return SSHLauncher(hosts)
    return MockClusterLauncher(mock_script if mock_script is not None
                               else spec.get("script"))
