"""Fleet executor — plan in, classified report out, no hands in between.

``run_fleet`` drives the whole pipeline:

  spawn    N worker shards through a pluggable ``Launcher``
           (repro_torch.fleet.launchers: local subprocesses or the mock
           fault-injection cluster), each measuring its slice of the plan's
           grid into its own worker store, output streamed line-prefixed;
  retry    a ``RetryBudget`` gives failed/incomplete shards more launch
           rounds within one run; completeness is re-derived from the stores
           between rounds, so a retried shard heals its torn store and
           re-measures only missing points, and every attempt lands in the
           ledger (launcher, host, rc, heal stats);
  survive  a killed shard leaves a truncated worker store; resume re-launches
           ONLY the shards whose slice is incomplete, and the campaign layer
           heals the torn tail and re-measures only the missing points;
  merge    worker stores fold into the plan's canonical store
           (``merge_stores`` — idempotent, atomic);
  classify one ``Campaign.characterize`` per region replays the merged store
           (a complete fleet classifies with ZERO new measurements) and the
           cross-region report lands in ``<store>.report.json``.

Ground truth is the stores, not the bookkeeping: shard completeness is
decided by ``CampaignStore.grid_status`` against the plan's grid, so a lying
or lost ``fleet.json`` can never cause double measurement or a hole.
``fleet.json`` (next to the store) records the plan digest, per-shard
status/attempts/attempt-log/stats, the merge manifest, and the final
classification.

The reference's static noise audit (``repro.analysis``, run before any
measurement) is not ported: the audit policy takes "off" only, its default;
"gate" and "warn" raise rather than skip the audit without saying so.
Classification uses the paper-default thresholds (calibration is not
ported).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import time
from typing import Optional, Sequence

from repro_torch.fleet.launchers import (FleetError, Launcher,  # noqa: F401  (FleetError re-exported)
                                         RetryBudget, resolve_launcher)
from repro_torch.fleet.plan import SweepPlan

log = logging.getLogger("repro_torch.fleet")

FLEET_SCHEMA = 1


# ---------------------------------------------------------------------------
# reporting helpers (shared by the executor, the fleet CLI, and probe)
# ---------------------------------------------------------------------------


def finish_stats(stats, expect_no_measure: bool) -> None:
    """The campaign tail every entry point prints; ``--expect-no-measure``
    turns "the store fully covers this run" into an exit code."""
    print(f"  [{stats.measured} points measured, "
          f"{stats.cached} replayed from store]")
    if expect_no_measure and stats.measured:
        raise SystemExit(
            f"--expect-no-measure: store was incomplete, {stats.measured} "
            "fresh measurements were needed")


def print_report(rep, *, name_line: bool = False) -> None:
    """Human-readable per-mode summary of one RegionReport (one line per
    mode: Abs^raw, fit params, payload verification; then the verdict)."""
    if name_line:
        print(f"  -- {rep.region} (|body|={rep.body_size})")
    for m, r in rep.results.items():
        inj = r.injection
        pay = (f"payload={inj.payload}/{inj.expected} overhead={inj.overhead}"
               if inj else "payload=n/a")
        print(f"  {m:14s} Abs^raw={r.fit.k1:7.1f} t0={r.fit.t0*1e3:8.2f}ms "
              f"slope={r.fit.slope*1e6:9.2f}us/pat {pay}")
    print(f"  => {rep.bottleneck}")


def report_json(reports: dict) -> str:
    """Canonical serialization of {region: RegionReport} — sorted keys and
    regions, so two runs of the same plan produce byte-comparable files."""
    return json.dumps({name: json.loads(rep.to_json())
                       for name, rep in sorted(reports.items())},
                      indent=1, sort_keys=True)


def write_report(path: str, reports: dict) -> str:
    """Atomically write ``report_json(reports)`` to ``path``; returns it."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(report_json(reports) + "\n")
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# policies: the static audit (not ported) and the runtime quality gate
# ---------------------------------------------------------------------------

AUDIT_CHOICES = ("off",)
AUDIT_NOT_PORTED = "static audit not ported yet (ROADMAP queue 1 item 9)"

# the runtime measurement-quality gate runs AFTER the merge: "gate" refuses
# a fleet whose classification was refused (majority-quarantined curves),
# "warn" reports and proceeds, "off" skips evidence attachment entirely
QUALITY_CHOICES = ("gate", "warn", "off")


def _check_audit_choice(audit: str) -> None:
    if audit in ("gate", "warn"):
        raise FleetError(AUDIT_NOT_PORTED)
    if audit not in AUDIT_CHOICES:
        raise FleetError(f"audit policy {audit!r}: one of {AUDIT_CHOICES}")


def _check_quality_choice(quality: str) -> None:
    if quality not in QUALITY_CHOICES:
        raise FleetError(
            f"quality policy {quality!r}: one of {QUALITY_CHOICES}")


def _plan_quality(plan: SweepPlan):
    """The plan's declared (QualityPolicy, RemeasureBudget), or (None, None)
    when the plan doesn't opt into the measurement-integrity guard."""
    if plan.quality is None:
        return None, None
    from repro_torch.core.quality import quality_from_dict

    return quality_from_dict(plan.quality)


def _attach_quality_evidence(rep, store):
    """Fold the store's runtime measurement-quality records into one
    RegionReport's classification (per-mode aggregate of quarantined points
    and why — ``apply_quality_evidence`` decides the downgrade or the label
    refusal). A no-op for regions with no quarantined points, so a clean
    guarded run serializes byte-identically to an unguarded one."""
    from repro_torch.core.classifier import apply_quality_evidence

    agg = {}
    any_quarantined = False
    for (r, m), per_k in store.quality.items():
        if r != rep.region or m not in rep.results:
            continue
        reasons: dict[str, int] = {}
        quarantined = 0
        for rec in per_k.values():
            if rec.get("verdict") == "quarantine":
                quarantined += 1
                reason = rec.get("reason") or "unknown"
                reasons[reason] = reasons.get(reason, 0) + 1
        agg[m] = {"points": len(per_k), "quarantined": quarantined,
                  "reasons": reasons}
        any_quarantined = any_quarantined or bool(quarantined)
    if not any_quarantined:
        return rep
    return dataclasses.replace(
        rep, bottleneck=apply_quality_evidence(rep.bottleneck, agg))


def _gate_quality(reports: dict, quality: str) -> None:
    """The runtime quality gate: a region whose label was REFUSED by
    ``apply_quality_evidence`` (majority-quarantined curve) fails the fleet
    under ``"gate"``, is printed and tolerated under ``"warn"``."""
    from repro_torch.core.classifier import UNRELIABLE

    if quality == "off":
        return
    bad = {name: rep for name, rep in sorted(reports.items())
           if rep.bottleneck.label == UNRELIABLE}
    if not bad:
        return
    lines = "\n".join(f"  {name}: {rep.bottleneck.explanation}"
                      for name, rep in bad.items())
    msg = (f"quality gate: {len(bad)} region(s) are majority-quarantined — "
           f"the measurements cannot back a label:\n{lines}")
    if quality == "gate":
        raise FleetError(
            msg + "\nre-measure under a quieter clock with `fleet run --plan "
            "... --resume`, or report anyway with --quality warn")
    print(f"!! {msg}\n!! --quality warn: reporting anyway")


def _classify_regions(plan: SweepPlan, camp, quality: str) -> dict:
    """One RegionReport per planned region from ``camp`` (replaying what
    the store holds), with the store's quality evidence attached unless
    ``quality`` is "off"."""
    reports = {}
    for spec, regions in plan.resolve():
        for region in regions:
            rep = camp.characterize(region, list(spec.modes))
            if quality != "off":
                rep = _attach_quality_evidence(rep, camp.store)
            reports[region.name] = rep
    return reports


# ---------------------------------------------------------------------------
# the single-process worker entry (probe --plan lands here)
# ---------------------------------------------------------------------------


def _stats_path(store: str) -> str:
    return store + ".stats.json"


def _write_worker_stats(store: str, stats) -> None:
    """The shard's tally: points measured and replayed, and this process's
    kernel launches ({kernel: [CUDA, plain]})."""
    from repro_torch.kernels.region import launch_counts

    with open(_stats_path(store), "w") as f:
        json.dump({"measured": stats.measured, "cached": stats.cached,
                   "launches": launch_counts()}, f)


def _read_worker_stats(store: str) -> Optional[dict]:
    try:
        with open(_stats_path(store)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _handshake(plan: SweepPlan) -> str:
    """The launcher->worker handshake: a launcher exports the plan digest it
    is driving (``REPRO_FLEET_EXPECT_DIGEST``); a worker whose own plan file
    resolves to a different digest refuses to measure. Returns the host
    label to echo in the worker banner."""
    expect = os.environ.get("REPRO_FLEET_EXPECT_DIGEST")
    if expect and expect != plan.digest():
        raise FleetError(
            f"worker handshake failed: the launcher expects plan digest "
            f"{expect} but this worker's plan file resolves to "
            f"{plan.digest()} — the plan copies are out of sync; "
            "re-distribute the plan file (same bytes => same digest)")
    return os.environ.get("REPRO_FLEET_HOST") or socket.gethostname()


def run_worker(plan: SweepPlan, *, index: Optional[int] = None,
               count: Optional[int] = None, fresh: bool = False,
               expect_no_measure: bool = False,
               header: Optional[str] = None, audit: str = "off",
               quality: str = "gate"):
    """Execute a plan (or one shard of it) in THIS process.

    ``index``/``count`` given: measure shard ``index`` of ``count``'s slice
    of the plan's pair grid into its worker store and stop — classification
    happens after the merge. Without a shard: run the whole grid into the
    canonical store, classify every region, and write the report file.

    ``audit``: "off" only (the static audit is not ported). A plan that
    declares a ``quality`` policy measures under the runtime integrity
    guard on both paths; ``quality`` then governs the classification side
    on the whole-plan path: "gate" refuses a majority-quarantined region,
    "warn" reports it, "off" attaches no quality evidence.

    Returns ``(results_or_reports, CampaignStats)``.
    """
    from repro_torch.core.campaign import (Campaign, CampaignStore,
                                           remove_store, worker_store)
    from repro_torch.core.controller import Controller

    _check_audit_choice(audit)
    _check_quality_choice(quality)

    if index is not None:
        count = plan.shards if count is None else count
        if count != plan.shards:
            raise FleetError(f"--shard I/N count {count} does not match the "
                             f"plan's shards={plan.shards}; the slice "
                             "assignment is part of the plan")
        store = worker_store(plan.store, index, count)
    else:
        store = plan.store
    if fresh:
        remove_store(store)
    host = _handshake(plan)
    title = header or f"fleet plan {plan.name!r} [{plan.digest()}]"
    plan.grid()     # rejects plans whose targets enumerate duplicate pairs
    # the regions first: a missing card fails before any store is created
    pairs = plan.pairs()
    ctl = Controller(reps=plan.reps, compile_once=plan.compile_once)
    qpolicy, qbudget = _plan_quality(plan)
    camp = Campaign(CampaignStore(store), ctl, workers=plan.workers,
                    quality=qpolicy, remeasure=qbudget)
    try:
        if index is not None:
            print(f"== {title} [shard {index}/{count}] ({len(pairs)}-pair "
                  f"grid; worker store: {store})")
            print(f"  [worker handshake: plan {plan.digest()}, host {host}, "
                  f"pid {os.getpid()}]")
            res = camp.measure_pairs(pairs, index=index, count=count)
            for (r, m), mr in sorted(res.items()):
                print(f"  {r}/{m}: Abs^raw={mr.fit.k1:7.1f} "
                      f"t0={mr.fit.t0*1e3:8.2f}ms")
            if not res:
                print(f"  (no pairs land on shard {index} of {count})")
            print("  [classification happens after the merge; a shard sees "
                  "only its slice]")
            _write_worker_stats(store, camp.stats)
            finish_stats(camp.stats, expect_no_measure)
            return res, camp.stats

        print(f"== {title} (campaign store: {store})")
        many = sum(len(regions) for _, regions in plan.resolve()) > 1
        reports = _classify_regions(plan, camp, quality)
        for rep in reports.values():
            print_report(rep, name_line=many)
        _gate_quality(reports, quality)
        write_report(plan.report_path(), reports)
        finish_stats(camp.stats, expect_no_measure)
        return reports, camp.stats
    finally:
        camp.store.close()


# ---------------------------------------------------------------------------
# fleet state (fleet.json)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardState:
    """One shard's ledger entry in ``fleet.json``.

    ``attempts`` counts LIFETIME launches (across resumes — what
    ``RetryBudget.per_shard_cap`` is checked against) and ``attempt_log``
    records each one: {attempt, launcher, host, rc, measured, cached}.
    Status vocabulary: pending | running | done | failed | exhausted."""
    index: int
    store: str
    status: str = "pending"
    returncode: Optional[int] = None
    attempts: int = 0
    measured: Optional[int] = None
    cached: Optional[int] = None
    host: Optional[str] = None
    attempt_log: list = dataclasses.field(default_factory=list)


class FleetState:
    """The durable fleet ledger. Advisory (stores are ground truth), but it
    is what ``status`` shows and what resume uses to report history."""

    def __init__(self, path: str, plan_digest: str,
                 shard_stores: Sequence[str]):
        self.path = path
        self.plan_digest = plan_digest
        self.shards = {i: ShardState(i, s)
                       for i, s in enumerate(shard_stores)}
        self.merge: Optional[dict] = None
        self.classification: Optional[dict] = None
        self.stats: Optional[dict] = None

    def to_dict(self) -> dict:
        """The JSON form written to ``fleet.json`` (schema-versioned)."""
        return {"fleet": FLEET_SCHEMA, "plan": self.plan_digest,
                "shards": {str(i): dataclasses.asdict(s)
                           for i, s in self.shards.items()},
                "merge": self.merge, "classification": self.classification,
                "stats": self.stats}

    def save(self) -> None:
        """Atomically rewrite ``fleet.json`` with the current state."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)

    @classmethod
    def load(cls, path: str) -> "FleetState":
        """Load a ``fleet.json``."""
        with open(path) as f:
            d = json.load(f)
        if d.get("fleet") != FLEET_SCHEMA:
            raise FleetError(f"{path}: not a fleet state file "
                             f"(fleet={d.get('fleet')!r})")
        state = cls(path, d.get("plan", ""), [])
        state.shards = {int(i): ShardState(**s)
                        for i, s in d.get("shards", {}).items()}
        state.merge = d.get("merge")
        state.classification = d.get("classification")
        state.stats = d.get("stats")
        return state


# ---------------------------------------------------------------------------
# the fleet pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetResult:
    """What ``run_fleet`` hands back: the plan, one RegionReport per region,
    the finalize replay's CampaignStats, the saved FleetState ledger, and
    the shard indices that were (re)launched during this run."""
    plan: SweepPlan
    reports: dict
    stats: object                    # CampaignStats of the finalize replay
    state: FleetState
    launched: list[int]              # shard indices (re)launched this run


def _incomplete_shards(plan: SweepPlan, grid, *,
                       heal: bool = False) -> list[int]:
    """Which shards still owe measurements — decided from the stores alone.

    The canonical store is consulted first: once a fleet has merged (or the
    same plan ran single-process), a complete canonical store means NO shard
    has anything left to do, even if worker stores were deleted.

    ``heal``: treat a complete pair that carries QUARANTINED points as still
    owing, so a resume re-launches its shard and the worker re-measures the
    condemned points."""
    from repro_torch.core.campaign import CampaignStore, store_exists

    def ok(ps) -> bool:
        return ps.complete and not (heal and ps.quarantined)

    if store_exists(plan.store):
        st = CampaignStore(plan.store, readonly=True)
        if all(ok(ps) for ps in st.grid_status(grid).values()):
            return []
    out = []
    for i in range(plan.shards):
        mine = grid[i::plan.shards]
        if not mine:
            continue
        ws = plan.worker_stores()[i]
        if not store_exists(ws):
            out.append(i)
            continue
        # readonly: completeness probing must not heal anything — the worker
        # owns its store and heals the torn tail itself on relaunch
        st = CampaignStore(ws, readonly=True)
        if not all(ok(ps) for ps in st.grid_status(mine).values()):
            out.append(i)
    return out


def _classify(plan: SweepPlan, quality: str = "gate"):
    """Merge-side finalize: replay the canonical store into one RegionReport
    per region (a complete store measures nothing here; quarantined points
    are NOT healed by finalize — it classifies what the fleet measured)."""
    from repro_torch.core.campaign import Campaign, CampaignStore
    from repro_torch.core.controller import Controller

    qpolicy, qbudget = _plan_quality(plan)
    ctl = Controller(reps=plan.reps, compile_once=plan.compile_once)
    camp = Campaign(CampaignStore(plan.store), ctl, workers=plan.workers,
                    quality=qpolicy, remeasure=qbudget,
                    heal_quarantined=False)
    try:
        reports = _classify_regions(plan, camp, quality)
    finally:
        camp.store.close()
    return reports, camp.stats


def _clean_fleet(plan: SweepPlan) -> None:
    from repro_torch.core.campaign import remove_store

    for s in [plan.store] + plan.worker_stores():
        remove_store(s)
    paths = [plan.fleet_path(), plan.report_path()]
    paths += [_stats_path(ws) for ws in plan.worker_stores()]
    for p in paths:
        if os.path.exists(p):
            os.unlink(p)


def run_fleet(plan_path: str, *, resume: bool = False, fresh: bool = False,
              expect_no_measure: bool = False,
              launcher: Optional[Launcher] = None,
              retry: Optional[RetryBudget] = None,
              audit: str = "off", quality: str = "gate") -> FleetResult:
    """Plan → spawn (with retries) → merge → classify, resumably.

    * first run: launches every shard whose slice is incomplete (all of
      them), merges, classifies;
    * within one call, the ``retry`` budget (or the plan's ``retry``
      settings) governs how many launch rounds failed/incomplete shards get
      — completeness is re-derived from the STORES after every round, so a
      retried shard heals its torn store and re-measures only missing
      points; every attempt lands in ``fleet.json``'s attempt log;
    * a plan that declares a ``quality`` policy measures every point under
      the runtime integrity guard; after the merge, ``quality="gate"``
      refuses a fleet whose classification was refused, ``"warn"`` reports
      it and writes the report anyway, ``"off"`` attaches no evidence;
    * ``resume`` after a crash: re-launches ONLY incomplete shards (and
      shards whose complete pairs carry quarantined points), then merges
      and classifies as usual;
    * ``resume`` on a completed fleet: launches nothing and the classify
      step replays the canonical store with ZERO new measurements;
    * ``fresh``: delete every store/state file of this plan first.

    ``launcher``: a ``Launcher``, or None to resolve from the plan's
    ``launcher`` spec (default: local subprocesses). ``audit``: "off" only.

    Raises ``FleetError`` when fleet state exists for a different plan
    digest, when state exists and neither flag was given, when shards still
    owe measurements after the last allowed attempt round, or when a shard
    has exhausted its lifetime ``per_shard_cap``.
    """
    _check_audit_choice(audit)
    _check_quality_choice(quality)
    plan = SweepPlan.load(plan_path)
    if fresh:
        _clean_fleet(plan)
    fleet_path = plan.fleet_path()
    state = None
    if os.path.exists(fleet_path):
        state = FleetState.load(fleet_path)
        if state.plan_digest != plan.digest():
            raise FleetError(
                f"{fleet_path} belongs to plan digest {state.plan_digest}, "
                f"this plan is {plan.digest()}; a changed plan must not "
                "splice into old shards — use --fresh to restart")
        if not resume:
            raise FleetError(
                f"{fleet_path} already exists; use --resume to continue (or "
                "replay) this fleet, or --fresh to restart it")
    grid = plan.grid()
    if state is None:
        state = FleetState(fleet_path, plan.digest(), plan.worker_stores())
    budget = retry if retry is not None \
        else RetryBudget.from_dict(plan.retry)
    lch = launcher if launcher is not None else resolve_launcher(plan=plan)

    incomplete = sorted(_incomplete_shards(plan, grid, heal=resume))
    for i, ss in state.shards.items():
        ss.status = "pending" if i in incomplete else "done"
    state.save()

    launched: list[int] = []
    round_no = 0
    while incomplete:
        capped = [i for i in incomplete
                  if budget.per_shard_cap
                  and state.shards[i].attempts >= budget.per_shard_cap]
        for i in capped:
            state.shards[i].status = "exhausted"
        runnable = [i for i in incomplete if i not in capped]
        if not runnable:
            state.save()
            raise FleetError(
                f"shard(s) {sorted(capped)} exhausted the lifetime "
                f"per-shard attempt cap ({budget.per_shard_cap}); "
                "fleet.json records every attempt (launcher, host, rc); fix "
                "the cause, then raise --per-shard-cap or restart with "
                "--fresh")
        if round_no >= budget.max_attempts:
            break
        round_no += 1
        delay = budget.delay(round_no)
        if delay:
            print(f"== retry backoff: sleeping {delay:.1f}s before attempt "
                  f"round {round_no}/{budget.max_attempts}")
            time.sleep(delay)
        print(f"== fleet {plan.name!r} [{plan.digest()}]: "
              f"{len(grid)}-pair grid, launching shard(s) {runnable} of "
              f"{plan.shards} (round {round_no}/{budget.max_attempts}, "
              f"launcher {lch.name})")
        attempts_map = {}
        for i in runnable:
            ss = state.shards[i]
            ss.status = "running"
            ss.attempts += 1
            attempts_map[i] = ss.attempts
            # a stale stats file from a previous attempt must not be
            # misattributed to this one
            try:
                os.unlink(_stats_path(ss.store))
            except OSError:
                pass
        state.save()
        outcomes = lch.launch(plan_path, plan, runnable,
                              attempts=attempts_map)
        still = set(_incomplete_shards(plan, grid, heal=resume))
        for i in runnable:
            ss = state.shards[i]
            o = outcomes.get(i)
            ss.returncode = None if o is None else o.rc
            ss.host = None if o is None else o.host
            ss.status = "failed" if i in still else "done"
            wstats = _read_worker_stats(ss.store)
            if wstats:
                ss.measured = wstats.get("measured")
                ss.cached = wstats.get("cached")
            ss.attempt_log.append({
                "attempt": ss.attempts, "launcher": lch.name,
                "host": ss.host, "rc": ss.returncode,
                "measured": (wstats or {}).get("measured"),
                "cached": (wstats or {}).get("cached")})
            if i not in launched:
                launched.append(i)
        state.save()
        incomplete = sorted(still)
    if incomplete:
        codes = {i: state.shards[i].returncode for i in incomplete}
        raise FleetError(
            f"shard(s) {sorted(incomplete)} did not complete after "
            f"{round_no} attempt round(s) (returncodes {codes}); completed "
            "work is preserved in the worker stores — re-running with "
            "--resume (or a higher --max-attempts) heals and finishes them")
    if not launched:
        print(f"== fleet {plan.name!r} [{plan.digest()}]: all "
              f"{plan.shards} shard slice(s) already complete, "
              "nothing to launch")

    from repro_torch.core.campaign import merge_stores, store_exists

    sources = [ws for ws in plan.worker_stores() if store_exists(ws)]
    if sources:
        # the canonical store (when present) streams FIRST so freshly
        # re-measured worker records supersede any stale merged ones
        if store_exists(plan.store):
            sources = [plan.store] + sources
        mstats = merge_stores(plan.store, sources)
        state.merge = {"dest": plan.store, "sources": sources,
                       "records_in": mstats.records_in,
                       "records_out": mstats.records_out,
                       "conflicts": [list(c) for c in
                                     sorted(set(map(tuple,
                                                    mstats.conflicts)))]}
        print(f"== merge: {mstats}")

    reports, cstats = _classify(plan, quality)
    state.classification = {
        name: {"label": rep.bottleneck.label,
               "confidence": rep.bottleneck.confidence,
               "abs": rep.absorptions()}
        for name, rep in sorted(reports.items())}
    state.stats = {"measured": cstats.measured, "cached": cstats.cached}
    state.save()
    # the ledger records a refused classification, but the gate refuses to
    # WRITE a report a majority-quarantined fleet cannot back
    _gate_quality(reports, quality)
    write_report(plan.report_path(), reports)
    print(f"== classification ({plan.report_path()}):")
    for name, rep in sorted(reports.items()):
        print(f"  {name}: {rep.bottleneck}")
    finish_stats(cstats, expect_no_measure)
    return FleetResult(plan=plan, reports=reports, stats=cstats, state=state,
                       launched=launched)
