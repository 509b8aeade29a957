"""Fleet CLI — build plans, run fleets (with pluggable launchers and retry
budgets), diagnose, watch and show fleet state.

    # declare a whole size family as one plan (2 subprocess shards)
    PYTHONPATH=src python -m repro_torch.fleet plan --out plan.json \\
        --pallas attention --sizes 256,512 --modes fp,mxu,vmem \\
        --shards 2 --reps 2 [--backend cuda|cpu] [--store-format segments]

    # a model step, or the paged serving engine's two regions (smoke config)
    PYTHONPATH=src python -m repro_torch.fleet plan --out serve.json \\
        --arch gemma-2b --serve [--seq 128 --batch 4 --max-new 8]

    # plan -> spawn -> merge -> classify (resumable; stores are ground truth)
    PYTHONPATH=src python -m repro_torch.fleet run --plan plan.json
    PYTHONPATH=src python -m repro_torch.fleet run --plan plan.json --resume \\
        --expect-no-measure          # assert a completed fleet replays free

    # real hosts: one worker per host from a declarative hosts.json,
    # flaky shards re-launched automatically up to the retry budget
    PYTHONPATH=src python -m repro_torch.fleet run --plan plan.json \\
        --launcher ssh --hosts hosts.json --max-attempts 3 --backoff 2

    # deterministic fault injection on one machine
    PYTHONPATH=src python -m repro_torch.fleet run --plan plan.json \\
        --launcher mock --max-attempts 2

    # why is my fleet incomplete?  (per shard: missing ks per pair, torn
    # store to be healed, attempts exhausted; plus any audit failures);
    # --explain: each region's decision path, measurement-free
    PYTHONPATH=src python -m repro_torch.fleet doctor --plan plan.json \\
        [--explain]
    PYTHONPATH=src python -m repro_torch.fleet status --plan plan.json

    # live progress while workers run: segmented stores are polled through
    # their manifests alone (no record data is read); --once prints one
    # frame and exits (1 while the grid is incomplete)
    PYTHONPATH=src python -m repro_torch.fleet watch --plan plan.json --once

    # the static noise audit alone (no measurement): every planned pair's
    # SASS at two static k; exit 1 on a dead pair (--expect-clean: on any
    # pair not intact); `run` audits first by default (--audit gate)
    PYTHONPATH=src python -m repro_torch.fleet audit --plan plan.json \
        [--expect-clean] [--force]

    # fit per-hardware classification thresholds (synthetic clock), show
    # them, copy them into another store
    PYTHONPATH=src python -m repro_torch.fleet calibrate run
    PYTHONPATH=src python -m repro_torch.fleet calibrate inspect
    PYTHONPATH=src python -m repro_torch.fleet calibrate apply --to S.jsonl

``--backend cuda`` (the default) measures the CUDA kernels on the card and
fails without one; ``--backend cpu`` runs their plain PyTorch versions
(which carry no compiled noise: the audit reports every pair
unauditable). ``--launcher ssh`` takes a hosts.json (a list, or
``{"hosts": [...]}``, of ``{addr, python, workdir, env}`` objects) and a
relative ``--store``; without ssh and scp/rsync it refuses to start and
prints the manual multi-host recipe.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

CAMPAIGN_DIR = "experiments/campaigns/fleet"


def _csv(text: str, cast) -> list:
    return [cast(p.strip()) for p in text.split(",") if p.strip()]


def _parse_json_arg(flag: str, text: Optional[str]) -> Optional[dict]:
    """A flag that takes inline JSON or a path to a JSON file."""
    if text is None:
        return None
    if os.path.exists(text):
        with open(text) as f:
            return json.load(f)
    try:
        return json.loads(text)
    except ValueError:
        raise SystemExit(f"{flag}: {text!r} is neither a JSON object nor a "
                         "path to one")


def _launcher_spec(args) -> Optional[dict]:
    """The plan-embedded launcher spec the ``plan`` subcommand's flags
    describe (None when no launcher flag was given)."""
    from repro_torch.fleet.launchers import FleetError, load_hosts

    if not args.launcher:
        if args.hosts or args.mock_script:
            raise SystemExit("plan: --hosts/--mock-script need --launcher")
        return None
    spec: dict = {"kind": args.launcher}
    if args.mock_script and args.launcher != "mock":
        raise SystemExit("plan: --mock-script needs --launcher mock")
    if args.hosts and args.launcher != "ssh":
        raise SystemExit("plan: --hosts needs --launcher ssh")
    if args.launcher == "ssh":
        if not args.hosts:
            raise SystemExit("plan: --launcher ssh needs --hosts hosts.json")
        try:
            hosts = load_hosts(args.hosts)
        except (OSError, ValueError, FleetError) as e:
            raise SystemExit(f"plan: {e}")
        spec["hosts"] = [
            {"addr": h.addr, "python": h.python, "workdir": h.workdir,
             **({"env": dict(h.env)} if h.env else {})}
            for h in hosts]
    elif args.launcher == "mock":
        script = _parse_json_arg("--mock-script", args.mock_script)
        if script is not None:
            spec["script"] = script
    return spec


def _retry_spec(args, base: Optional[dict] = None) -> Optional[dict]:
    """The retry dict described by the retry flags, over ``base``."""
    spec = dict(base or {})
    if args.max_attempts is not None:
        spec["max_attempts"] = args.max_attempts
    if args.backoff is not None:
        spec["backoff"] = args.backoff
    if args.per_shard_cap is not None:
        spec["per_shard_cap"] = args.per_shard_cap
    return spec or None


def _build_plan(args):
    from repro_torch.fleet.plan import PlanError, SweepPlan, TargetSpec

    if bool(args.pallas) == bool(args.arch):
        raise SystemExit("plan: give exactly one of --pallas KERNEL or "
                         "--arch ARCH")
    if args.serve and not args.arch:
        raise SystemExit("plan: --serve needs --arch ARCH")
    if args.pallas:
        from repro_torch.kernels.region import KERNEL_MODES, SIZE_DEFAULT
        if args.pallas not in KERNEL_MODES:
            raise SystemExit(f"unknown pallas kernel {args.pallas!r}; one "
                             f"of {', '.join(sorted(KERNEL_MODES))}")
        modes = (_csv(args.modes, str) if args.modes
                 else list(KERNEL_MODES[args.pallas]))
        params = {"kernel": args.pallas,
                  "sizes": (_csv(args.sizes, int) if args.sizes
                            else [SIZE_DEFAULT[args.pallas]])}
        if args.qs:
            params["qs"] = _csv(args.qs, float)
        if args.nnz_per_row is not None:
            params["nnz_per_row"] = args.nnz_per_row
        spec = TargetSpec("pallas", tuple(modes), params)
        default_name = f"fleet_{args.pallas}"
    else:
        from repro_torch.launch.probe import DEFAULT_GRAPH_MODES
        modes = (_csv(args.modes, str) if args.modes
                 else list(DEFAULT_GRAPH_MODES))
        if args.serve:
            spec = TargetSpec("serve", tuple(modes),
                              {"arch": args.arch, "slots": args.batch,
                               "prompt": args.seq,
                               "max_new": args.max_new})
            default_name = f"fleet_{args.arch}_serve"
        else:
            spec = TargetSpec("step", tuple(modes),
                              {"arch": args.arch, "kind": args.kind,
                               "seq": args.seq, "batch": args.batch})
            default_name = f"fleet_{args.arch}_{args.kind}"
    name = args.name or default_name
    plan = SweepPlan(name=name,
                     store=args.store or os.path.join(CAMPAIGN_DIR,
                                                      f"{name}.jsonl"),
                     targets=[spec],
                     reps=args.reps, shards=args.shards,
                     workers=args.workers,
                     compile_once=not args.no_compile_once,
                     backend=args.backend,
                     launcher=_launcher_spec(args),
                     retry=_retry_spec(args),
                     store_format=args.store_format,
                     quality=_parse_json_arg("--quality-policy",
                                             args.quality_policy))
    try:
        plan.validate()
    except PlanError as e:
        raise SystemExit(f"plan: {e}")
    return plan


def _cmd_plan(args) -> int:
    from repro_torch.fleet.plan import PlanError

    plan = _build_plan(args)
    try:
        grid = plan.grid()       # reject (e.g. duplicate pairs) BEFORE the
    except PlanError as e:       # invalid plan file lands on disk
        raise SystemExit(f"plan: {e}")
    plan.save(args.out)
    print(f"wrote plan {plan.name!r} [{plan.digest()}] -> {args.out}")
    print(f"  {len(grid)} (region, mode) pair(s) over {plan.shards} "
          f"shard(s); store: {plan.store}; backend: {plan.backend}")
    for label, value in (("store format", plan.store_format),
                         ("launcher", plan.launcher), ("retry", plan.retry),
                         ("quality", plan.quality)):
        if value:
            print(f"  {label}: {value}")
    for r, m in grid:
        print(f"    {r}/{m}")
    print(f"run it:   PYTHONPATH=src python -m repro_torch.fleet run "
          f"--plan {args.out}")
    return 0


def _cmd_run(args) -> int:
    from repro_torch.fleet.executor import FleetError, run_fleet
    from repro_torch.fleet.launchers import RetryBudget, resolve_launcher
    from repro_torch.fleet.plan import PlanError, SweepPlan

    try:
        plan = SweepPlan.load(args.plan)
    except (OSError, PlanError) as e:
        raise SystemExit(f"fleet: {e}")
    if args.in_process and args.launcher and args.launcher != "local":
        raise SystemExit("run: --in-process conflicts with "
                         f"--launcher {args.launcher}")
    try:
        launcher = None
        if args.launcher or args.in_process or args.hosts \
                or args.mock_script:
            launcher = resolve_launcher(
                args.launcher, plan=plan, hosts_path=args.hosts,
                mock_script=_parse_json_arg("--mock-script",
                                            args.mock_script),
                in_process=args.in_process)
        rd = _retry_spec(args, plan.retry)
        retry = RetryBudget.from_dict(rd) if rd else None
        res = run_fleet(args.plan, resume=args.resume, fresh=args.fresh,
                        expect_no_measure=args.expect_no_measure,
                        launcher=launcher, retry=retry, audit=args.audit,
                        quality=args.quality)
    except FleetError as e:
        raise SystemExit(f"fleet: {e}")
    print(f"fleet {res.plan.name!r} complete: {len(res.reports)} region(s) "
          f"classified, shard(s) launched this run: "
          f"{res.launched or 'none'}")
    return 0


def _cmd_audit(args) -> int:
    """Static noise audit of a plan, standalone: build every planned pair
    at the audit's two k points, persist the verdicts into the plan's
    canonical store, and exit 1 when any pair is statically dead
    (``--expect-clean``: when any pair is not fully intact)."""
    from repro_torch.fleet.executor import FleetError, audit_fleet_plan
    from repro_torch.fleet.plan import PlanError, SweepPlan

    try:
        plan = SweepPlan.load(args.plan)
        # gate="warn" so every pair is printed before the exit-code verdict
        records = audit_fleet_plan(plan, gate="warn", force=args.force)
    except (OSError, PlanError, FleetError) as e:
        raise SystemExit(f"audit: {e}")
    grid = plan.grid()
    dead = [k for k in grid
            if records.get(k, {}).get("verdict") == "dead"]
    not_intact = [k for k in grid
                  if records.get(k, {}).get("verdict") != "intact"]
    print(f"== audit verdict: {len(grid) - len(not_intact)}/{len(grid)} "
          f"pair(s) intact, {len(dead)} dead (records -> {plan.store})")
    if args.expect_clean and not_intact:
        print("--expect-clean: not intact: "
              + ", ".join(f"{r}/{m}" for r, m in not_intact))
        return 1
    return 1 if dead else 0


def _cmd_doctor(args) -> int:
    from repro_torch.fleet.executor import FleetError, fleet_doctor
    from repro_torch.fleet.plan import PlanError, SweepPlan

    try:
        plan = SweepPlan.load(args.plan)
        code, report = fleet_doctor(plan, explain=args.explain)
    except (OSError, PlanError, FleetError) as e:
        raise SystemExit(f"doctor: {e}")
    print(report)
    return code


def _cmd_calibrate(args) -> int:
    """Run, inspect or apply a threshold-calibration campaign (the
    known-regime synthetic sweep that fits per-hardware LOW/HIGH —
    ``core.calibration``)."""
    from repro_torch.core.absorption import SYNTH_MEASURE_VAR
    from repro_torch.core.calibration import EXPECTED, run_calibration
    from repro_torch.core.campaign import CampaignStore

    store = args.store or os.path.join(CAMPAIGN_DIR, "calibrate.jsonl")
    if args.action == "run":
        from repro_torch.core.calibration import CALIB_MODES
        from repro_torch.fleet.executor import finish_stats
        from repro_torch.fleet.plan import PlanError, SweepPlan, TargetSpec

        # calibration is definitionally synthetic: the known regimes are
        # forced clock shapes, so make sure the deterministic clock is on
        os.environ.setdefault(SYNTH_MEASURE_VAR, args.base)
        plan = SweepPlan(name="calibrate", store=store, shards=1,
                         reps=args.reps, backend=args.backend,
                         targets=[TargetSpec("calibrate",
                                             tuple(CALIB_MODES), {})])
        try:
            plan.validate()
        except PlanError as e:
            raise SystemExit(f"calibrate: {e}")
        plan_path = args.out or os.path.splitext(store)[0] + ".plan.json"
        plan.save(plan_path)
        res = run_calibration(store, reps=args.reps, device=args.backend)
        tag = ("fitted" if res.fitted
               else "regimes did not separate; FALLBACK to paper defaults")
        print(f"== calibration [{res.hw}]: low={res.low:g} "
              f"high={res.high:g} ({tag})")
        print(f"  plan -> {plan_path}  (status --plan shows its grid)")
        ok = True
        for name, rep in sorted(res.reports.items()):
            b = rep.bottleneck
            good = b.label == EXPECTED[name]
            ok = ok and good
            verdict = "ok" if good else f"WRONG (expected {EXPECTED[name]})"
            print(f"  {name}: {b.label} "
                  f"(confidence {b.confidence:.3f}) [{verdict}]")
        finish_stats(res.stats, args.expect_no_measure)
        return 0 if ok else 1

    try:   # inspect/apply read an existing store; never create one
        st = CampaignStore(store, readonly=True)
    except FileNotFoundError as e:
        print(e)
        return 2
    if not st.calib:
        print(f"{store}: no calib record — run "
              "`python -m repro_torch.fleet calibrate run` first")
        return 1
    if args.action == "inspect":
        for hw, rec in sorted(st.calib.items()):
            tag = "fitted" if rec.get("fitted") else "FALLBACK"
            print(f"calib hw={hw}: low={rec.get('low'):g} "
                  f"high={rec.get('high'):g} [{tag}] "
                  f"(reps={rec.get('reps')})")
            for s in rec.get("samples", []):
                print(f"  {s['region']}/{s['mode']} [{s['role']}]: "
                      f"Abs^raw={s['k1']:g}")
        return 0
    # apply: copy the calib record(s) into another store, so its future
    # classifications resolve the fitted thresholds
    if not args.to:
        raise SystemExit("calibrate apply needs --to DEST_STORE")
    dest = CampaignStore(args.to)
    for _hw, rec in sorted(st.calib.items()):
        dest.append(rec)
    dest.close()
    print(f"applied {len(st.calib)} calib record(s) -> {args.to}")
    return 0


def _segment_line(path: str) -> Optional[str]:
    """A segmented store's manifest summary for ``status`` (None for a
    single-file store): sealed segments, records and bytes, and unsealed
    segments — a live writer's, or a killed one's that the next writable
    open heals."""
    from repro_torch.core.segments import is_segmented, manifest_status

    if not is_segmented(path):
        return None
    ms = manifest_status(path)
    return (f"    segments: {ms['segments']} sealed, {ms['records']} "
            f"record(s), {ms['bytes']} B; {ms['orphans']} unsealed "
            f"(live or orphan, {ms['orphan_bytes']} B)")


def _cmd_status(args) -> int:
    from repro_torch.core.campaign import CampaignStore, store_exists
    from repro_torch.fleet.executor import FleetState
    from repro_torch.fleet.plan import PlanError, SweepPlan

    try:
        plan = SweepPlan.load(args.plan)
    except (OSError, PlanError) as e:
        raise SystemExit(f"status: {e}")
    grid = plan.grid()
    print(f"plan {plan.name!r} [{plan.digest()}]: {len(grid)} pair(s), "
          f"{plan.shards} shard(s), store {plan.store}")
    fleet_path = plan.fleet_path()
    if os.path.exists(fleet_path):
        state = FleetState.load(fleet_path)
        tag = ("" if state.plan_digest == plan.digest()
               else f" (STALE: fleet built by {state.plan_digest})")
        print(f"fleet state {fleet_path}{tag}:")
        for i, ss in sorted(state.shards.items()):
            extra = ""
            if ss.measured is not None:
                extra = f", {ss.measured} measured / {ss.cached} replayed"
            if ss.host:
                extra += f", host {ss.host}"
            print(f"  shard {i}: {ss.status} (attempts={ss.attempts}"
                  f"{extra})")
        if state.classification:
            for name, c in sorted(state.classification.items()):
                print(f"  {name}: {c['label']} ({c['confidence']})")
    else:
        print(f"fleet state {fleet_path}: not created yet")
    if store_exists(plan.store):
        st = CampaignStore(plan.store, readonly=True)
        status = st.grid_status(grid)
        incomplete_pairs = sum(not ps.complete for ps in status.values())
        print(f"canonical store: {len(grid) - incomplete_pairs}/{len(grid)} "
              "pair(s) complete")
        seg = _segment_line(plan.store)
        if seg:
            print(seg)
    else:
        incomplete_pairs = len(grid)
        print("canonical store: absent")
    for i, ws in enumerate(plan.worker_stores()):
        mine = grid[i::plan.shards]
        if not store_exists(ws):
            print(f"  worker store {i}: absent ({len(mine)} pair slice)")
            continue
        st = CampaignStore(ws, readonly=True)
        done = sum(ps.complete for ps in st.grid_status(mine).values())
        print(f"  worker store {i}: {done}/{len(mine)} slice pair(s) "
              "complete")
        seg = _segment_line(ws)
        if seg:
            print("  " + seg)
    return 1 if incomplete_pairs else 0


def _watch_frame(plan, grid) -> tuple[str, bool]:
    """One rendered ``fleet watch`` frame plus grid completeness.

    Segmented stores are summarized from their MANIFESTs alone (sealed
    segment/record/byte totals, live-or-orphan unsealed segments, and the
    aggregated per-pair ``done`` coverage) — no record data is read, so a
    2-second poll never contends with active writers. Legacy single-file
    stores fall back to a full readonly load. ``done`` markers are trusted
    as-is here; ``doctor``/``status`` own the precise per-k check.
    """
    from repro_torch.core.campaign import CampaignStore, store_exists
    from repro_torch.core.segments import is_segmented, manifest_status

    out = [f"== fleet watch: plan {plan.name!r}, {len(grid)} pair(s)"]
    done: set = set()
    stores = [("canonical", plan.store)]
    stores += [(f"worker {i}", ws)
               for i, ws in enumerate(plan.worker_stores())]
    for label, path in stores:
        if not store_exists(path):
            out.append(f"  {label} ({path}): absent")
            continue
        if is_segmented(path):
            st = manifest_status(path)
            seen = sorted((str(r), str(m)) for (r, m), p
                          in st["pairs"].items() if p.get("done"))
            done.update((r, m) for (r, m), p in st["pairs"].items()
                        if p.get("done"))
            extra = (f", {st['orphans']} unsealed segment(s) "
                     f"[{st['orphan_bytes']} B live/orphan]"
                     if st["orphans"] else "")
            out.append(f"  {label} ({path}): {st['segments']} sealed "
                       f"segment(s), {st['records']} record(s), "
                       f"{st['bytes']} B{extra}")
            if seen:
                out.append("    done: " + ", ".join(f"{r}/{m}"
                                                    for r, m in seen))
            quar = sorted((str(r), str(m), p["quarantined"])
                          for (r, m), p in st["pairs"].items()
                          if p.get("quarantined"))
            if quar:
                out.append("    quarantined: " + ", ".join(
                    f"{r}/{m} ({n} point(s))" for r, m, n in quar)
                    + " — doctor names each point and why")
        else:
            st = CampaignStore(path, readonly=True)
            gs = st.grid_status(grid)
            comp = {k for k, ps in gs.items() if ps.complete}
            done.update(comp)
            out.append(f"  {label} ({path}): legacy file, "
                       f"{os.path.getsize(path)} B, {len(comp)}/{len(grid)} "
                       "grid pair(s) complete")
            quar = sorted((r, m, len(ps.quarantined))
                          for (r, m), ps in gs.items() if ps.quarantined)
            if quar:
                out.append("    quarantined: " + ", ".join(
                    f"{r}/{m} ({n} point(s))" for r, m, n in quar)
                    + " — doctor names each point and why")
    missing = [k for k in grid if k not in done]
    line = (f"  grid: {len(grid) - len(missing)}/{len(grid)} "
            "pair(s) done")
    if missing:
        head = ", ".join(f"{r}/{m}" for r, m in missing[:6])
        line += (f" — waiting on {head}"
                 + (f" (+{len(missing) - 6} more)" if len(missing) > 6
                    else ""))
    out.append(line)
    return "\n".join(out), not missing


def _cmd_watch(args) -> int:
    import time

    from repro_torch.fleet.plan import PlanError, SweepPlan

    try:
        plan = SweepPlan.load(args.plan)
        grid = plan.grid()
    except (OSError, PlanError) as e:
        raise SystemExit(f"watch: {e}")
    while True:
        frame, complete = _watch_frame(plan, grid)
        print(frame, flush=True)
        if complete:
            return 0
        if args.once:
            return 1
        time.sleep(max(0.2, args.interval))


def _add_launcher_flags(p, *, for_plan: bool) -> None:
    """The launcher/retry flag set shared by ``plan`` (serialize into the
    plan) and ``run`` (override the plan for this invocation)."""
    where = "serialize into the plan" if for_plan else "override the plan"
    p.add_argument("--launcher", default=None,
                   choices=("local", "ssh", "mock"),
                   help=f"shard launcher kind ({where}); default: local "
                        "subprocesses")
    p.add_argument("--hosts", default=None, metavar="HOSTS.json",
                   help="ssh host specs: a JSON list (or {\"hosts\": [...]})"
                        " of {addr, python, workdir, env} objects")
    p.add_argument("--mock-script", default=None, metavar="JSON",
                   help="mock launcher fault script (inline JSON or a file):"
                        " {shard: [action per attempt]}, actions ok|crash|"
                        "drop-point|timeout|dead")
    p.add_argument("--max-attempts", type=int, default=None,
                   help="launch rounds per run before giving up (retry "
                        "budget; default 1)")
    p.add_argument("--backoff", type=float, default=None,
                   help="seconds to sleep before retry round r, doubling "
                        "each round (default 0)")
    p.add_argument("--per-shard-cap", type=int, default=None,
                   help="LIFETIME attempts one shard may consume across "
                        "resumes (0 = unlimited)")


def build_parser() -> argparse.ArgumentParser:
    """The fleet CLI's argparse tree."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="fleet orchestrator: plan, spawn (local/ssh/mock "
                    "launchers with retry budgets), merge, classify")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("plan", help="build a SweepPlan JSON")
    pp.add_argument("--out", required=True, help="plan JSON path to write")
    pp.add_argument("--name", default=None,
                    help="plan name (default: derived from the target)")
    pp.add_argument("--store", default=None,
                    help=f"campaign store (default: under {CAMPAIGN_DIR}/)")
    pp.add_argument("--store-format", default=None,
                    choices=("jsonl", "segments"),
                    help="store layout: one legacy JSONL file (default) or "
                         "an append-only segment directory with a "
                         "checksummed manifest (incremental merges, "
                         "manifest-driven fleet watch)")
    pp.add_argument("--pallas", default=None, metavar="KERNEL",
                    help="kernel family target (matmul|spmxv|attention|"
                         "probe)")
    pp.add_argument("--arch", default=None,
                    help="model-step target (smoke config; exclusive with "
                         "--pallas)")
    pp.add_argument("--serve", action="store_true",
                    help="with --arch: a serve target (the paged serving "
                         "engine's prefill + decode regions; --seq is the "
                         "prompt length, --batch the slot count)")
    pp.add_argument("--max-new", type=int, default=8,
                    help="decode budget per request (--serve)")
    pp.add_argument("--kind", default="train", choices=("train", "decode"),
                    help="which model step (--arch without --serve)")
    pp.add_argument("--seq", type=int, default=128,
                    help="sequence (prompt) length of the model target")
    pp.add_argument("--batch", type=int, default=4,
                    help="batch size (slot count) of the model target")
    pp.add_argument("--sizes", default=None,
                    help="comma list for the kernel's size knob "
                         "(rows / seq / grid steps)")
    pp.add_argument("--qs", default=None,
                    help="comma list of swap probabilities (spmxv only)")
    pp.add_argument("--nnz-per-row", type=int, default=None,
                    help="spmxv nonzeros per row")
    pp.add_argument("--modes", default=None,
                    help="comma list (default: the kernel's full mode set, "
                         "or the graph-level default set for --arch)")
    pp.add_argument("--reps", type=int, default=2,
                    help="timing repetitions per measured point")
    pp.add_argument("--shards", type=int, default=2,
                    help="how many workers the grid splits across")
    pp.add_argument("--workers", type=int, default=1,
                    help="threads per shard")
    pp.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                    help="where the regions compute: cuda (default; the "
                         "kernels on the card) or cpu (their plain "
                         "PyTorch versions)")
    pp.add_argument("--no-compile-once", action="store_true",
                    help="force the trace-per-k fallback sweep path")
    pp.add_argument("--quality-policy", default=None, metavar="JSON",
                    help="serialize a runtime measurement-integrity policy "
                         "into the plan (inline JSON or a file): "
                         "QualityPolicy keys plus RemeasureBudget keys")
    _add_launcher_flags(pp, for_plan=True)
    pp.set_defaults(fn=_cmd_plan)

    rp = sub.add_parser("run", help="plan -> spawn shards (retrying up to "
                                    "the budget) -> merge -> classify")
    rp.add_argument("--plan", required=True,
                    help="the SweepPlan JSON to execute")
    rp.add_argument("--resume", action="store_true",
                    help="continue an existing fleet: re-launch only "
                         "incomplete shards; a clean complete fleet replays "
                         "with zero new measurements")
    rp.add_argument("--fresh", action="store_true",
                    help="delete this plan's stores and fleet state first")
    rp.add_argument("--expect-no-measure", action="store_true",
                    help="exit non-zero if the finalize replay had to "
                         "measure anything")
    rp.add_argument("--in-process", action="store_true",
                    help="run shards sequentially in this process instead "
                         "of spawning subprocesses")
    rp.add_argument("--audit", default="gate",
                    choices=("gate", "warn", "off"),
                    help="static noise-audit policy before launch: gate "
                         "(default) refuses statically-dead pairs, warn "
                         "measures anyway, off skips the audit")
    rp.add_argument("--quality", default="gate",
                    choices=("gate", "warn", "off"),
                    help="runtime measurement-quality policy after the "
                         "merge: gate (default) refuses a majority-"
                         "quarantined classification, warn reports it, off "
                         "attaches no quality evidence")
    _add_launcher_flags(rp, for_plan=False)
    rp.set_defaults(fn=_cmd_run)

    audp = sub.add_parser("audit", help="statically verify every planned "
                                        "(region, mode) pair against the "
                                        "compiler — no measurements; exit 1 "
                                        "on any dead pair")
    audp.add_argument("--plan", required=True,
                      help="the SweepPlan JSON to audit")
    audp.add_argument("--expect-clean", action="store_true",
                      help="exit 1 unless EVERY pair is fully intact "
                           "(degraded and unauditable pairs also fail)")
    audp.add_argument("--force", action="store_true",
                      help="re-audit pairs that already carry audit records "
                           "(fresh records supersede)")
    audp.set_defaults(fn=_cmd_audit)

    dp = sub.add_parser("doctor", help="explain per shard why the fleet is "
                                       "incomplete: missing ks per pair, "
                                       "torn store to be healed, attempts "
                                       "exhausted (exit 1 while incomplete)")
    dp.add_argument("--plan", required=True,
                    help="the SweepPlan JSON to diagnose")
    dp.add_argument("--explain", action="store_true",
                    help="for a covered grid, also replay each region's "
                         "classification (measurement-free) and print the "
                         "strategy tree's decision path: which node fired, "
                         "under which thresholds (calibrated or default), "
                         "plus any audit/quality downgrades")
    dp.set_defaults(fn=_cmd_doctor)

    cal = sub.add_parser("calibrate",
                         help="threshold calibration: run the known-regime "
                              "synthetic sweep and fit per-hardware "
                              "LOW/HIGH, inspect the fitted record, or "
                              "apply it to another store")
    cal.add_argument("action", choices=("run", "inspect", "apply"),
                     help="run: sweep the four known-regime kernels under "
                          "the deterministic synthetic clock and persist a "
                          "calib record; inspect: print the store's calib "
                          "record(s); apply: copy them into --to DEST")
    cal.add_argument("--store", default=None,
                     help="calibration campaign store (default: "
                          f"{CAMPAIGN_DIR}/calibrate.jsonl)")
    cal.add_argument("--out", default=None, metavar="PLAN.json",
                     help="where `run` writes the calibrate SweepPlan "
                          "(default: next to the store)")
    cal.add_argument("--reps", type=int, default=2,
                     help="timing repetitions per measured point")
    cal.add_argument("--base", default="1e-3",
                     help="synthetic-clock base seconds exported as "
                          "REPRO_SYNTH_MEASURE when it is not already set")
    cal.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                     help="where the calibration regions' buffers live: "
                          "cuda (default) or cpu")
    cal.add_argument("--to", default=None, metavar="DEST_STORE",
                     help="apply: the store that receives the calib "
                          "record(s)")
    cal.add_argument("--expect-no-measure", action="store_true",
                     help="run: exit non-zero if the calibration had to "
                          "measure anything (replay contract)")
    cal.set_defaults(fn=_cmd_calibrate)

    sp = sub.add_parser("status", help="show fleet/shard/store completeness "
                                       "(exit 1 while incomplete)")
    sp.add_argument("--plan", required=True,
                    help="the SweepPlan JSON to summarize")
    sp.set_defaults(fn=_cmd_status)

    wp = sub.add_parser("watch", help="live store progress: manifest-driven "
                                      "for segmented stores (no record "
                                      "reads), polled until the grid is "
                                      "done")
    wp.add_argument("--plan", required=True,
                    help="the SweepPlan JSON to watch")
    wp.add_argument("--interval", type=float, default=2.0,
                    help="seconds between frames (default 2)")
    wp.add_argument("--once", action="store_true",
                    help="print one frame and exit (1 while incomplete)")
    wp.set_defaults(fn=_cmd_watch)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: dispatch to the plan/run/audit/doctor/calibrate/status/
    watch subcommand."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
