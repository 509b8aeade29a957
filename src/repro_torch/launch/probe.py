"""Noise-injection bottleneck probe over the port's kernels — the paper's
experiment at kernel granularity, on the card — and the FLEET's
single-process worker entry.

Every measured path runs through the fleet spine (``repro_torch.fleet``):
the CLI flags build a one-target ``SweepPlan`` and hand it to
``run_worker`` — the same code path a fleet shard executes — so ad-hoc
probes, subprocess shards and plan files all measure through one campaign
tail (store naming, shard dispatch, reporting). Every (mode, k, t) point
persists to a JSONL store (default ``experiments/campaigns/<region>.jsonl``)
and re-running replays it with zero new measurements. The sweep uses the
compile-once path (one runtime-k CUDA function per mode, plus one static-k
build for the payload check):

    PYTHONPATH=src python -m repro_torch.launch.probe --pallas attention \\
        --pallas-n 1024 [--modes fp,mxu,vmem] [--store PATH] \\
        [--expect-no-measure] [--shard I/N] [--device cuda|cpu]

Fleet worker mode executes a slice of a saved ``SweepPlan`` — what
``python -m repro_torch.fleet run`` spawns:

    PYTHONPATH=src python -m repro_torch.launch.probe --plan plan.json \\
        --shard 0/2

Model-step mode probes one step of a model at its smoke config — the
forward loss (``--kind train``; no gradient, as the reference's) or one
decode step — with the graph-level noise modes forked beside it
(``core/injector.py``; a CUDA graph on the card):

    PYTHONPATH=src python -m repro_torch.launch.probe --arch gemma-2b \\
        --kind decode [--seq 128] [--batch 4] [--modes fp_add32,hbm_stream]

Serve mode probes the paged serving engine as TWO regions — the batched
prefill and the decode tick — under one campaign:

    PYTHONPATH=src python -m repro_torch.launch.probe --serve \\
        --arch gemma-2b [--seq 128] [--batch 4] [--max-new 8]

Region names are the reference's, letter for letter, so stores carry over.

Analytic mode (full config, the H100 SXM's data-sheet peaks, reads the
port's dry-run record of the cell, ``launch/dryrun.py``) runs through the
same campaign machinery: predictions persist as ``pred`` records (curve +
fit + HardwareConfig/terms/settings) and replay on re-run; nothing runs on
any device:

    PYTHONPATH=src python -m repro_torch.launch.probe --arch gemma-2b \
        --shape train_4k --analytic \
        [--dryrun-dir experiments/dryrun_torch/16x16] [--store PATH] [--fresh]

``--device cpu`` (the plan's ``backend``) runs the plain PyTorch versions
(tests, a card-less box); the default ``cuda`` refuses to run without a
card.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

CAMPAIGN_DIR = "experiments/campaigns"

# default graph-level mode set for the model-step and serve probes
DEFAULT_GRAPH_MODES = ("fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream")

ENCDEC_DECODE_REFUSED = (
    "a decode step of the encdec family is refused: the reference's "
    "build_step_region calls decode_init(params, {'tokens', 'max_seq'}) "
    "without 'frames', and encdec_decode_init reads batch['frames'], so it "
    "fails with KeyError: 'frames' (ROADMAP queue 3)")


def step_region_name(cfg_name: str, kind: str, seq: int, batch: int) -> str:
    """The model-step region's name, the reference's letter for letter."""
    return f"{cfg_name}_{kind}_s{seq}_b{batch}"


def build_step_region(arch: str, kind: str, modes: Sequence[str], *,
                      seq: int, batch: int, device="cuda"):
    """The graph-level model-step RegionTarget the measured probe and
    "step" fleet TargetSpecs share: the smoke config, params drawn from
    seed 0 on ``device``, noise forked beside the whole step (the forward
    loss for ``kind="train"``, one decode step at position seq // 2
    otherwise; an encdec decode step is refused, as the reference fails
    it)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.injector import step_modes, step_region
    from repro_torch.kernels.region import resolve_device
    from repro_torch.models.model import build

    dev = resolve_device(device)
    registry = step_modes(dev)
    unknown = [m for m in modes if m not in registry]
    if unknown:
        raise SystemExit(f"unknown mode(s) {unknown}; available: "
                         f"{', '.join(sorted(registry))}")

    cfg = get_smoke_config(arch)
    if kind == "decode" and cfg.family == "encdec":
        raise NotImplementedError(ENCDEC_DECODE_REFUSED)
    api = build(cfg)
    params = api.init(0, dev)
    shape = ShapeConfig("probe", kind, seq, batch)

    if kind == "train":
        batch_data = api.dummy_batch(shape, device=dev)

        def step(p, b):
            return api.loss(p, b)[0]
        args = (params, batch_data)
    else:
        cache = api.decode_init(params, {"tokens": torch.zeros((batch, 1)),
                                         "max_seq": seq})
        toks = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        pos = torch.tensor(seq // 2, dtype=torch.int32, device=dev)

        def step(p, c, t):
            return api.decode_step(p, c, t, pos)[0]
        args = (params, cache, toks)

    return step_region(step_region_name(cfg.name, kind, seq, batch), step,
                       args,
                       {m: registry[m] for m in modes})


def _run_adhoc(spec, *, reps: int, store: Optional[str], fresh: bool,
               workers: int, compile_once: bool,
               shard: Optional[tuple[int, int]], expect_no_measure: bool,
               header: str, device: str, quality: str = "gate",
               audit: str = "gate"):
    """Build a one-target SweepPlan from CLI flags and execute it through
    the fleet worker."""
    from repro_torch.fleet.executor import FleetError, run_worker
    from repro_torch.fleet.plan import PlanError, SweepPlan
    from repro_torch.kernels.region import resolve_device

    try:
        resolve_device(device)      # no card: fail before any store exists
    except RuntimeError as e:
        raise SystemExit(str(e))
    plan = SweepPlan(name=header, store=store or "", targets=[spec],
                     reps=reps, shards=(shard[1] if shard else 1),
                     workers=workers, compile_once=compile_once,
                     backend=device)
    if not plan.store:
        plan.store = os.path.join(CAMPAIGN_DIR,
                                  f"{spec.region_names()[0]}.jsonl")
    try:
        plan.validate()
        return run_worker(plan, index=(shard[0] if shard else None),
                          count=(shard[1] if shard else None), fresh=fresh,
                          expect_no_measure=expect_no_measure, header=header,
                          audit=audit, quality=quality)
    except (FleetError, PlanError) as e:
        raise SystemExit(str(e))


def measured_probe(arch: str, kind: str, modes: list[str], *, seq: int,
                   batch: int, reps: int, store: Optional[str] = None,
                   fresh: bool = False, workers: int = 1,
                   compile_once: bool = True,
                   shard: Optional[tuple[int, int]] = None,
                   expect_no_measure: bool = False, device: str = "cuda",
                   quality: str = "gate", audit: str = "gate"):
    """Measured graph-level probe of one model step (smoke config): a
    one-target SweepPlan run through the fleet worker."""
    from repro_torch.fleet.plan import TargetSpec

    spec = TargetSpec("step", tuple(modes),
                      {"arch": arch, "kind": kind, "seq": seq,
                       "batch": batch})
    return _run_adhoc(spec, reps=reps, store=store, fresh=fresh,
                      workers=workers, compile_once=compile_once,
                      shard=shard, expect_no_measure=expect_no_measure,
                      header=f"measured probe: {arch} {kind} seq={seq} "
                             f"batch={batch} on {device}",
                      device=device, quality=quality, audit=audit)


def serve_probe(arch: str, modes: list[str], *, slots: int, prompt: int,
                max_new: int, reps: int, store: Optional[str] = None,
                fresh: bool = False, workers: int = 1,
                compile_once: bool = True,
                shard: Optional[tuple[int, int]] = None,
                expect_no_measure: bool = False, device: str = "cuda",
                quality: str = "gate", audit: str = "gate"):
    """Measured probe of the paged serving engine (smoke config): one plan,
    TWO regions — the batched prefill and the decode tick
    (``serve.load.build_serve_regions``) — classified separately."""
    from repro_torch.fleet.plan import TargetSpec

    spec = TargetSpec("serve", tuple(modes),
                      {"arch": arch, "slots": slots, "prompt": prompt,
                       "max_new": max_new})
    return _run_adhoc(spec, reps=reps, store=store, fresh=fresh,
                      workers=workers, compile_once=compile_once,
                      shard=shard, expect_no_measure=expect_no_measure,
                      header=f"serve probe: {arch} slots={slots} "
                             f"prompt={prompt} on {device}",
                      device=device, quality=quality, audit=audit)


def pallas_probe(kernel: str, modes: Optional[list[str]], *, reps: int,
                 n: Optional[int] = None, store: Optional[str] = None,
                 fresh: bool = False, workers: int = 1,
                 compile_once: bool = True,
                 shard: Optional[tuple[int, int]] = None,
                 expect_no_measure: bool = False, device: str = "cuda",
                 quality: str = "gate", audit: str = "gate"):
    """Characterize one kernel region through the fleet worker; returns
    ``run_worker``'s ``(reports or shard results, CampaignStats)``."""
    from repro_torch.fleet.plan import TargetSpec
    from repro_torch.kernels.region import (KERNEL_MODES, SIZE_DEFAULT,
                                            validate_size)

    if kernel not in KERNEL_MODES:
        raise SystemExit(f"unknown pallas kernel {kernel!r}; one of "
                         f"{', '.join(sorted(KERNEL_MODES))}")
    modes = modes or list(KERNEL_MODES[kernel])
    unknown = [m for m in modes if m not in KERNEL_MODES[kernel]]
    if unknown:
        raise SystemExit(f"kernel {kernel!r} supports modes "
                         f"{KERNEL_MODES[kernel]}, not {unknown}")
    n = SIZE_DEFAULT[kernel] if n is None else n
    try:
        validate_size(kernel, n)
    except ValueError as e:
        raise SystemExit(f"--pallas-n: {e}")
    spec = TargetSpec("pallas", tuple(modes), {"kernel": kernel,
                                               "sizes": [n]})
    return _run_adhoc(spec, reps=reps, store=store, fresh=fresh,
                      workers=workers, compile_once=compile_once,
                      shard=shard, expect_no_measure=expect_no_measure,
                      header=f"pallas probe: {kernel} on {device}",
                      device=device, quality=quality, audit=audit)


def plan_probe(plan_path: str, *, shard: Optional[tuple[int, int]],
               fresh: bool, expect_no_measure: bool, quality: str = "gate",
               audit: str = "gate"):
    """The fleet worker entry: execute (a shard of) a saved SweepPlan."""
    from repro_torch.fleet.executor import FleetError, run_worker
    from repro_torch.fleet.plan import PlanError, SweepPlan

    try:
        plan = SweepPlan.load(plan_path)
    except (OSError, ValueError) as e:       # PlanError is a ValueError
        raise SystemExit(f"--plan {plan_path}: {e}")
    try:
        return run_worker(plan, index=(shard[0] if shard else None),
                          count=(shard[1] if shard else None), fresh=fresh,
                          expect_no_measure=expect_no_measure, audit=audit,
                          quality=quality)
    except (FleetError, PlanError) as e:
        raise SystemExit(str(e))


def analytic_probe(arch: str, shape_name: str, dryrun_dir: str,
                   modes: list[str], *, tol: float,
                   store: Optional[str] = None, fresh: bool = False,
                   expect_no_measure: bool = False, hw=None):
    """Analytic probe of one (arch, shape) dry-run cell: push its roofline
    terms through the saturation model as a resumable prediction campaign
    (``pred`` records replay byte-identically on re-run). ``hw``: the
    hardware the predictions are for (default ``H100_SXM``). Returns the
    RegionReport and the CampaignStats."""
    from repro_torch.configs import canonical
    from repro_torch.configs.base import H100_SXM
    from repro_torch.core.analytic import StepTerms, pattern_deltas
    from repro_torch.core.campaign import AnalyticCampaign
    from repro_torch.core.classifier import classify
    from repro_torch.core.noise import make_modes
    from repro_torch.fleet.executor import finish_stats

    hw = H100_SXM if hw is None else hw
    cell = os.path.join(dryrun_dir, f"{canonical(arch)}_{shape_name}.json")
    with open(cell) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        raise SystemExit(f"dry-run cell {cell} status={rec.get('status')}")
    r = rec["roofline"]
    terms = StepTerms(compute=r["t_compute"], memory=r["t_memory"],
                      ici=r["t_ici"])
    registry = make_modes(device="cpu")
    unknown = [m for m in modes if m not in registry]
    if unknown:
        raise SystemExit(f"unknown mode(s) {unknown}; available: "
                         f"{', '.join(sorted(registry))}")
    region_name = f"{canonical(arch)}_{shape_name}"
    store = store or os.path.join(CAMPAIGN_DIR, f"{region_name}_pred.jsonl")
    if fresh and os.path.exists(store):
        os.unlink(store)
    camp = AnalyticCampaign(store, hw=hw, tol=tol, k_max=1 << 44)
    print(f"== analytic probe: {arch} {shape_name} [{rec['mesh']}] "
          f"(terms from dry-run: Tc={terms.compute*1e3:.2f}ms "
          f"Tm={terms.memory*1e3:.2f}ms Ti={terms.ici*1e3:.2f}ms, "
          f"dominant={r['dominant']}; campaign store: {store})")
    t0 = terms.bound()

    def absorbed(m, res) -> float:
        # absorbed-work fraction: what share of the step time each mode's
        # noise occupies before detection — the step-scale-free absorption
        # (bound resource ~= tol; slack resources >> tol)
        delta = max(pattern_deltas(registry[m], hw).values())
        return 100.0 * res.fit.k1 * delta / t0

    def classify_fracs(results):
        return classify({m: absorbed(m, res) for m, res in results.items()},
                        low=2.0 * 100 * tol, high=6.0 * 100 * tol)

    rep = camp.characterize(region_name, terms,
                            {m: registry[m] for m in modes},
                            classify_fn=classify_fracs)
    for m, res in rep.results.items():
        print(f"  {m:14s} Abs^raw={res.fit.k1:14.0f} patterns "
              f"(~{absorbed(m, res):6.1f}% of step absorbable)")
    print(f"  => {rep.bottleneck}")
    finish_stats(camp.stats, expect_no_measure)
    return rep, camp.stats


def _parse_shard(text: str) -> tuple[int, int]:
    try:
        idx, cnt = (int(p) for p in text.split("/"))
    except ValueError:
        raise SystemExit(f"--shard wants I/N (e.g. 0/2), got {text!r}")
    if not (0 <= idx < cnt):
        raise SystemExit(f"--shard index {idx} not in [0, {cnt})")
    return idx, cnt


def build_parser() -> argparse.ArgumentParser:
    """The probe CLI's argparse tree."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.probe",
        description="noise-injection bottleneck probe of one kernel region "
                    "or model step (CUDA kernels on the card, or their "
                    "plain PyTorch versions with --device cpu), and the "
                    "fleet worker entry (--plan)")
    ap.add_argument("--arch", default=None,
                    help="model architecture (required unless --pallas or "
                         "--plan)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced smoke config (model-step and serve "
                         "probes always use it; flag kept for "
                         "explicitness)")
    ap.add_argument("--kind", default="train", choices=("train", "decode"),
                    help="which model step to probe")
    ap.add_argument("--shape", default="train_4k",
                    help="dry-run shape cell to read under --analytic")
    ap.add_argument("--analytic", action="store_true",
                    help="predict absorption from the dry-run roofline "
                         "terms instead of measuring")
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch/16x16",
                    help="where the dry-run records live (--analytic)")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="absorption-fit detection tolerance (--analytic)")
    ap.add_argument("--serve", action="store_true",
                    help="probe the paged serving engine instead of a bare "
                         "model step: two regions (batched prefill + decode "
                         "tick) under one campaign; --seq is the prompt "
                         "length, --batch the slot count")
    ap.add_argument("--max-new", type=int, default=8,
                    help="decode budget per request of the probed serve "
                         "workload (--serve)")
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length of the probed step")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size of the probed step")
    ap.add_argument("--pallas", default=None,
                    metavar="{matmul,spmxv,attention,probe}",
                    help="probe a kernel region instead of a model step")
    ap.add_argument("--pallas-n", type=int, default=None,
                    help="kernel size knob (rows for matmul/spmxv, seq for "
                         "attention, grid steps for probe)")
    ap.add_argument("--plan", default=None, metavar="PLAN.json",
                    help="execute a repro_torch.fleet SweepPlan: with "
                         "--shard I/N measure that slice into its worker "
                         "store (the fleet worker entry); without, run the "
                         "whole plan, classify, and write the report")
    ap.add_argument("--shard", default=None, metavar="I/N",
                    help="measure only worker I's slice of the grid into a "
                         "per-worker store (N must match the plan's shards "
                         "under --plan)")
    ap.add_argument("--modes", default=None,
                    help="noise modes (default: "
                         f"{','.join(DEFAULT_GRAPH_MODES)}, or the kernel's "
                         "fp/mxu/vmem set under --pallas)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions per measured point")
    ap.add_argument("--store", default=None,
                    help="campaign JSONL path (default: derived under "
                         f"{CAMPAIGN_DIR}/)")
    ap.add_argument("--fresh", action="store_true",
                    help="discard any existing campaign store first")
    ap.add_argument("--workers", type=int, default=1,
                    help="fan independent mode sweeps over N threads")
    ap.add_argument("--expect-no-measure", action="store_true",
                    help="exit non-zero if any fresh measurement was needed "
                         "(assert a complete store replays fully)")
    ap.add_argument("--no-compile-once", action="store_true",
                    help="force the trace-per-k fallback (one static-k "
                         "build per sweep point)")
    ap.add_argument("--quality", default="gate",
                    choices=("gate", "warn", "off"),
                    help="runtime measurement-quality policy for whole-plan/"
                         "ad-hoc runs: gate (default) refuses a majority-"
                         "quarantined classification, warn reports it, off "
                         "attaches no quality evidence")
    ap.add_argument("--audit", default="gate", choices=("gate", "warn", "off"),
                    help="static noise-audit policy for whole-plan and "
                         "ad-hoc runs (shards never audit): gate (default) "
                         "refuses statically-dead pairs, warn measures "
                         "anyway, off skips the audit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the region computes (the plan's backend): "
                         "cuda (default; fails without a card) or cpu "
                         "(plain PyTorch versions)")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """CLI entry; returns ``run_worker``'s ``(reports or shard results,
    CampaignStats)``."""
    args = build_parser().parse_args(argv)
    modes = ([m.strip() for m in args.modes.split(",") if m.strip()]
             if args.modes else None)
    shard = _parse_shard(args.shard) if args.shard is not None else None
    if args.plan is not None:
        # the plan carries all of these; silently ignoring one would let a
        # user believe they changed the measurement settings
        overridden = [flag for flag, given in (
            ("--arch", args.arch), ("--serve", args.serve),
            ("--analytic", args.analytic),
            ("--kind", args.kind != "train"), ("--seq", args.seq != 128),
            ("--batch", args.batch != 4), ("--max-new", args.max_new != 8),
            ("--pallas", args.pallas), ("--pallas-n", args.pallas_n),
            ("--modes", modes), ("--store", args.store),
            ("--reps", args.reps != 3), ("--workers", args.workers != 1),
            ("--no-compile-once", args.no_compile_once),
            ("--device", args.device != "cuda")) if given]
        if overridden:
            raise SystemExit("--plan carries its own targets, modes and "
                             "settings; drop the conflicting flag(s): "
                             + ", ".join(overridden))
        return plan_probe(args.plan, shard=shard, fresh=args.fresh,
                          expect_no_measure=args.expect_no_measure,
                          quality=args.quality, audit=args.audit)
    common = dict(reps=args.reps, store=args.store, fresh=args.fresh,
                  workers=args.workers,
                  compile_once=not args.no_compile_once, shard=shard,
                  expect_no_measure=args.expect_no_measure,
                  device=args.device, quality=args.quality, audit=args.audit)
    if args.pallas is not None:
        if args.analytic or args.serve:
            raise SystemExit("--pallas excludes --serve and --analytic")
        return pallas_probe(args.pallas, modes, n=args.pallas_n, **common)
    if args.arch is None:
        raise SystemExit("--arch is required unless --pallas or --plan "
                         "is given")
    if args.serve:
        if args.analytic:
            raise SystemExit("--serve and --analytic are mutually exclusive")
        return serve_probe(args.arch, modes or list(DEFAULT_GRAPH_MODES),
                           slots=args.batch, prompt=args.seq,
                           max_new=args.max_new, **common)
    if args.analytic:
        if shard is not None:
            raise SystemExit("--shard applies to measured mode only "
                             "(predictions are too cheap to fan out)")
        return analytic_probe(args.arch, args.shape, args.dryrun_dir,
                              modes or list(DEFAULT_GRAPH_MODES),
                              tol=args.tol, store=args.store,
                              fresh=args.fresh,
                              expect_no_measure=args.expect_no_measure)
    return measured_probe(args.arch, args.kind,
                          modes or list(DEFAULT_GRAPH_MODES), seq=args.seq,
                          batch=args.batch, **common)


if __name__ == "__main__":
    main()
