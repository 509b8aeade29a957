"""Noise-injection bottleneck probe over the port's kernels — the paper's
experiment at kernel granularity, on the card.

One kernel region is characterized through a resumable campaign: every
(mode, k, t) point persists to a JSONL store (default
``experiments/campaigns/<region>.jsonl``) and re-running replays it with
zero new measurements. The sweep uses the compile-once path (one runtime-k
CUDA function per mode, plus one static-k build for the payload check):

    PYTHONPATH=src python -m repro_torch.launch.probe --pallas spmxv \\
        --pallas-n 2097152 [--modes fp,vmem] [--store PATH] \\
        [--expect-no-measure] [--device cuda|cpu]

``--device cpu`` runs the plain PyTorch versions (tests, a card-less box);
the default ``cuda`` refuses to run without a card. The reference's fleet
plan, sharding, serving, analytic and model-step probes are not ported.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

CAMPAIGN_DIR = "experiments/campaigns"


def finish_stats(stats, expect_no_measure: bool) -> None:
    """The campaign tail: how much was measured and replayed;
    ``--expect-no-measure`` turns "the store covers this run" into an exit
    code."""
    print(f"  [{stats.measured} points measured, "
          f"{stats.cached} replayed from store]")
    if expect_no_measure and stats.measured:
        raise SystemExit(
            f"--expect-no-measure: store was incomplete, {stats.measured} "
            "fresh measurements were needed")


def pallas_probe(kernel: str, modes: Optional[list[str]], *, reps: int,
                 n: Optional[int] = None, store: Optional[str] = None,
                 fresh: bool = False, compile_once: bool = True,
                 expect_no_measure: bool = False, device: str = "cuda"):
    """Characterize one kernel region through a campaign, print its report
    and the measured/replayed tally; returns the RegionReport."""
    from repro_torch.core.campaign import Campaign
    from repro_torch.core.controller import Controller
    from repro_torch.kernels.region import (ATTENTION_NOT_PORTED,
                                            KERNEL_MODES, SIZE_DEFAULT,
                                            SIZE_KW, pallas_region,
                                            resolve_device, validate_size)

    if kernel not in KERNEL_MODES:
        raise SystemExit(f"unknown pallas kernel {kernel!r}; one of "
                         f"{', '.join(sorted(KERNEL_MODES))}")
    if kernel == "attention":
        raise SystemExit(ATTENTION_NOT_PORTED)
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
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    region = pallas_region(kernel, device=dev, **{SIZE_KW[kernel]: n})
    store = store or os.path.join(CAMPAIGN_DIR, f"{region.name}.jsonl")
    if fresh and os.path.exists(store):
        os.unlink(store)
    camp = Campaign(store, Controller(reps=reps, compile_once=compile_once))
    try:
        print(f"== pallas probe: {kernel} on {dev} (campaign store: {store})")
        rep = camp.characterize(region, modes)
        print(rep.summary())
        finish_stats(camp.stats, expect_no_measure)
    finally:
        camp.store.close()
    return rep


def build_parser() -> argparse.ArgumentParser:
    """The probe CLI's argparse tree."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.probe",
        description="noise-injection bottleneck probe of one kernel region "
                    "(CUDA kernels on the card, or their plain PyTorch "
                    "versions with --device cpu)")
    ap.add_argument("--pallas", required=True,
                    metavar="{matmul,spmxv,probe}",
                    help="the kernel region to probe")
    ap.add_argument("--pallas-n", type=int, default=None,
                    help="kernel size knob (rows for matmul/spmxv, grid "
                         "steps for probe)")
    ap.add_argument("--modes", default=None,
                    help="noise modes (default: the kernel's fp/mxu/vmem set)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions per measured point")
    ap.add_argument("--store", default=None,
                    help="campaign JSONL path (default: derived under "
                         f"{CAMPAIGN_DIR}/)")
    ap.add_argument("--fresh", action="store_true",
                    help="discard any existing campaign store first")
    ap.add_argument("--expect-no-measure", action="store_true",
                    help="exit non-zero if any fresh measurement was needed "
                         "(assert a complete store replays fully)")
    ap.add_argument("--no-compile-once", action="store_true",
                    help="force the trace-per-k fallback (one static-k "
                         "build per sweep point)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the region computes: cuda (default; fails "
                         "without a card) or cpu (plain PyTorch versions)")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """CLI entry; returns the RegionReport."""
    args = build_parser().parse_args(argv)
    modes = ([m.strip() for m in args.modes.split(",") if m.strip()]
             if args.modes else None)
    return pallas_probe(args.pallas, modes, reps=args.reps, n=args.pallas_n,
                        store=args.store, fresh=args.fresh,
                        compile_once=not args.no_compile_once,
                        expect_no_measure=args.expect_no_measure,
                        device=args.device)


if __name__ == "__main__":
    main()
