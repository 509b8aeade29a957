"""Synthetic-traffic load harness for the serving engine, and the probe's
serve RegionTargets.

PyTorch port of the reference's ``repro.serve.load``: the same mixes,
request streams (numpy, from ``seed``) and report. The harness drives a
``ServeEngine`` with a reproducible request stream — closed-loop (keep N
requests outstanding) or Poisson arrivals (exponential inter-arrival gaps
measured in engine ticks) — over prompt/decode length mixes, and reports
tokens/sec plus page-pool occupancy:

    PYTHONPATH=src python -m repro_torch.serve.load --arch gemma-2b \\
        --mix quick [--smoke] [--dense] [--slots 4] [--json out.json] \\
        [--device cuda|cpu]

``build_serve_regions`` turns the same engine into the fleet's ``"serve"``
TargetSpec kind: it snapshots the engine's batched prefill and decode tick
as two cells (``ServeEngine.probe_cells``) and wraps each as a
graph-level-noise RegionTarget (``core.injector.step_region``: a CUDA
graph on the card) — prefill and decode classify as SEPARATE regions of
one serving workload.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One reproducible traffic mix: request count, arrival process, and the
    prompt/decode length distributions (sampled with ``seed``)."""
    n_requests: int = 16
    arrival: str = "closed"          # "closed" | "poisson"
    concurrency: int = 8             # closed-loop: max outstanding requests
    mean_gap_ticks: float = 2.0      # poisson: mean inter-arrival (ticks)
    prompt_lens: tuple[int, ...] = (8, 16, 32)
    max_new: tuple[int, ...] = (4, 8, 16)
    seed: int = 0


# named mixes; prompt/decode lengths are clamped to the target config's
# max_seq by sample_requests, so one mix spans the whole configs/ zoo
MIXES: dict[str, LoadSpec] = {
    "quick": LoadSpec(n_requests=8, prompt_lens=(4, 8, 12),
                      max_new=(4, 6, 8), concurrency=8),
    "chat": LoadSpec(n_requests=24, prompt_lens=(16, 32, 64),
                     max_new=(8, 16, 32), concurrency=8),
    "long": LoadSpec(n_requests=12, prompt_lens=(64, 128, 256),
                     max_new=(32, 64), concurrency=4),
    "poisson": LoadSpec(n_requests=16, arrival="poisson",
                        mean_gap_ticks=3.0, prompt_lens=(8, 16, 32),
                        max_new=(4, 8, 16)),
}


def sample_requests(spec: LoadSpec, vocab_size: int, max_seq: int
                    ) -> list[dict]:
    """The mix's deterministic request stream: ``[{prompt, max_new,
    arrival_tick}, ...]`` sorted by arrival. Lengths clamp to the config's
    ``max_seq`` so a mix written for 4k contexts still drives a smoke
    config."""
    if spec.arrival not in ("closed", "poisson"):
        raise ValueError(f"arrival {spec.arrival!r}: one of "
                         "['closed', 'poisson']")
    rng = np.random.default_rng(spec.seed)
    reqs = []
    tick = 0.0
    for _ in range(spec.n_requests):
        plen = int(min(rng.choice(spec.prompt_lens), max_seq - 1))
        new = int(rng.choice(spec.max_new))
        if spec.arrival == "poisson":
            tick += float(rng.exponential(spec.mean_gap_ticks))
        reqs.append({
            "prompt": rng.integers(1, vocab_size, size=plen).tolist(),
            "max_new": new,
            "arrival_tick": int(tick),
        })
    return reqs


def run_load(engine, spec: LoadSpec, *, max_ticks: int = 10000) -> dict:
    """Drive ``engine`` with the mix and report throughput/occupancy.

    Closed-loop keeps at most ``spec.concurrency`` requests outstanding;
    Poisson releases requests by their arrival tick. Returns the engine's
    ``report()`` extended with per-request latency (in ticks) percentiles.
    """
    stream = sample_requests(spec, engine.cfg.vocab_size, engine.max_seq)
    pending = list(stream)
    born: dict[int, int] = {}
    latency: list[int] = []
    tracked = []
    t0 = time.perf_counter()
    tick = 0
    while (pending or engine.queue
           or any(r is not None for r in engine.slot_req)):
        if tick >= max_ticks:
            break
        while pending and _admissible(spec, pending[0], engine, tick):
            item = pending.pop(0)
            req = engine.submit(item["prompt"], max_new=item["max_new"])
            born[req.uid] = tick
            tracked.append(req)
        engine.step()
        tick += 1
        for r in tracked:
            if r.done and r.uid in born:
                latency.append(tick - born.pop(r.uid))
    wall = time.perf_counter() - t0
    engine.stats["wall_s"] += wall
    rep = engine.report()
    rep.update({
        "mix": dataclasses.asdict(spec),
        "requests_done": sum(r.done for r in tracked),
        "requests_total": len(stream),
        "latency_ticks_p50": float(np.percentile(latency, 50))
        if latency else None,
        "latency_ticks_p95": float(np.percentile(latency, 95))
        if latency else None,
    })
    return rep


def _admissible(spec: LoadSpec, item: dict, engine, tick: int) -> bool:
    if spec.arrival == "poisson":
        return item["arrival_tick"] <= tick
    outstanding = len(engine.queue) + sum(
        r is not None for r in engine.slot_req)
    return outstanding < spec.concurrency


# ---------------------------------------------------------------------------
# Probe integration: the "serve" TargetSpec kind's region builder
# ---------------------------------------------------------------------------

def serve_region_names(arch: str, *, slots: int = 4, prompt: int = 32,
                       max_new: int = 8, page_size: int = 16) -> list[str]:
    """The names ``build_serve_regions`` will produce, WITHOUT building a
    model (plan grid queries must stay cheap). Every engine parameter the
    builder varies over is encoded, as the reference's names are."""
    from repro_torch.configs import get_smoke_config
    return serve_names(get_smoke_config(arch).name, slots=slots,
                       prompt=prompt, max_new=max_new, page_size=page_size)


def serve_names(cfg_name: str, *, slots: int, prompt: int, max_new: int,
                page_size: int) -> list[str]:
    """The prefill and decode regions' names for the config ``cfg_name``
    (the reference's format)."""
    tag = f"s{prompt}_n{max_new}_p{page_size}_b{slots}"
    return [f"{cfg_name}_serve_prefill_{tag}",
            f"{cfg_name}_serve_decode_{tag}"]


def engine_for_probe(api, params, *, slots: int, prompt: int, max_new: int,
                     page_size: int):
    """A paged engine two ticks into a full-slot campaign (the state
    ``ServeEngine.probe_cells`` snapshots): ``slots`` prompts of ``prompt``
    tokens from ``np.random.default_rng(0)``."""
    from repro_torch.serve.engine import ServeEngine

    need = prompt + max_new + 2
    max_seq = page_size
    while max_seq < need:
        max_seq *= 2
    eng = ServeEngine(api, params, n_slots=slots, max_seq=max_seq,
                      paged=True, page_size=page_size)
    rng = np.random.default_rng(0)
    for _ in range(slots):
        eng.submit(rng.integers(1, api.cfg.vocab_size, size=prompt).tolist(),
                   max_new=max_new)
    eng.step()       # admission wave (the prefill cell's state) + tick 1
    eng.step()       # tick 2: a representative mid-decode state
    return eng


def serve_regions(eng, names: Sequence[str], registry: dict) -> list:
    """The engine's prefill and decode tick as two RegionTargets under the
    noise ``registry`` (``core.injector.step_region``)."""
    from repro_torch.core.injector import step_region

    pf_fn, pf_args, tk_fn, tk_args = eng.probe_cells()
    return [step_region(names[0], pf_fn, pf_args, registry),
            step_region(names[1], tk_fn, tk_args, registry)]


def build_serve_regions(arch: str, modes: Sequence[str], *, slots: int = 4,
                        prompt: int = 32, max_new: int = 8,
                        page_size: int = 16, device="cuda") -> list:
    """Build the serve workload's two RegionTargets at the smoke config:
    the paged engine's batched prefill and its decode tick, each
    snapshotted mid-campaign and wrapped with the graph-level noise
    registry on ``device`` (``core.injector.step_modes``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.injector import step_modes
    from repro_torch.kernels.region import resolve_device
    from repro_torch.models.model import build

    dev = resolve_device(device)
    registry = step_modes(dev)
    unknown = [m for m in modes if m not in registry]
    if unknown:
        raise SystemExit(f"unknown mode(s) {unknown}; available: "
                         f"{', '.join(sorted(registry))}")
    api = build(get_smoke_config(arch))
    eng = engine_for_probe(api, api.init(0, dev), slots=slots, prompt=prompt,
                           max_new=max_new, page_size=page_size)
    names = serve_region_names(arch, slots=slots, prompt=prompt,
                               max_new=max_new, page_size=page_size)
    return serve_regions(eng, names, {m: registry[m] for m in modes})


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.load",
        description="synthetic-traffic load harness for the serving engine")
    ap.add_argument("--arch", required=True, help="model architecture")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced smoke config (default: full config)")
    ap.add_argument("--mix", default="quick", choices=sorted(MIXES),
                    help="named traffic mix")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dense", action="store_true",
                    help="force the dense (non-paged) cache layout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the report as JSON")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs: cuda (default; fails "
                         "without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.region import resolve_device
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = build(cfg)
    params = api.init(0, dev)
    eng = ServeEngine(api, params, n_slots=args.slots, max_seq=args.max_seq,
                      page_size=args.page_size,
                      paged=False if args.dense else None, seed=args.seed)
    spec = dataclasses.replace(MIXES[args.mix], seed=args.seed)
    rep = run_load(eng, spec)
    print(f"== serve load: {cfg.name} mix={args.mix} "
          f"({'paged' if eng.paged else 'dense'}, slots={args.slots}, "
          f"{dev})")
    print(f"  {rep['requests_done']}/{rep['requests_total']} requests, "
          f"{rep['decode_tokens']} decode + {rep['prefill_tokens']} prefill "
          f"tokens in {rep['wall_s']:.2f}s")
    print(f"  decode {rep['decode_tok_s']:.1f} tok/s, total "
          f"{rep['total_tok_s']:.1f} tok/s, mean pool occupancy "
          f"{rep['mean_pool_occupancy']:.2f}")
    if rep["latency_ticks_p50"] is not None:
        print(f"  latency p50={rep['latency_ticks_p50']:.0f} "
              f"p95={rep['latency_ticks_p95']:.0f} ticks")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
        print(f"  report -> {args.json}")
    return rep


if __name__ == "__main__":
    main()
