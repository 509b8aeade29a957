"""Serving launcher: batched generation with continuous batching over the
paged KV-cache pool (``--dense`` forces the per-slot dense layout).

PyTorch port of the reference's ``repro.launch.serve``, with the same flags
and request stream (prompts of 2–11 tokens from ``RandomState(0)``) plus
``--device``. It serves the full config on the card by default; the
weights are random, drawn from seed 0 on the device, as the reference's:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        [--smoke] [--requests 8] [--slots 4] [--max-new 16] [--dense] \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--dense", action="store_true",
                    help="force the dense (non-paged) cache layout")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs: cuda (default; fails "
                         "without a card) or cpu")
    return ap


def serve(api, params, *, requests: int = 8, slots: int = 4,
          max_new: int = 16, max_seq: int = 256, page_size: int = 16,
          dense: bool = False, temperature: float = 0.0):
    """Serve ``requests`` prompts (2–11 tokens from ``RandomState(0)``)
    through a ``ServeEngine``; returns (engine, requests, seconds)."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(api, params, n_slots=slots, max_seq=max_seq,
                      temperature=temperature, page_size=page_size,
                      paged=False if dense else None)
    rng = np.random.RandomState(0)
    reqs = []
    for _ in range(requests):
        plen = int(rng.randint(2, 12))
        prompt = rng.randint(0, api.cfg.vocab_size, size=plen).tolist()
        reqs.append(eng.submit(prompt, max_new=max_new))
    t0 = time.perf_counter()
    eng.run(max_ticks=requests * (max_new + 4))
    return eng, reqs, time.perf_counter() - t0


def report(eng, reqs, dt: float) -> str:
    """The reference launcher's summary lines."""
    n_tok = sum(len(r.out) for r in reqs)
    layout = "paged" if eng.paged else "dense"
    rep = eng.report()
    lines = [f"{len(reqs)} requests on {eng.n_slots} slots ({layout}, "
             f"{eng.device}) -> {n_tok} tokens in {dt:.2f}s "
             f"({n_tok / dt:.1f} tok/s)",
             f"  prefill calls: {rep['prefill_calls']}, mean pool "
             f"occupancy: {rep['mean_pool_occupancy']:.2f}"]
    for r in reqs[:4]:
        lines.append(f"  req {r.uid}: prompt={r.prompt[:6]}... "
                     f"out={r.out[:8]}... done={r.done}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.region import resolve_device
    from repro_torch.models.model import build

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = build(cfg)
    params = api.init(0, dev)
    eng, reqs, dt = serve(api, params, requests=args.requests,
                          slots=args.slots, max_new=args.max_new,
                          max_seq=args.max_seq, page_size=args.page_size,
                          dense=args.dense, temperature=args.temperature)
    print(report(eng, reqs, dt))
    return eng, reqs


if __name__ == "__main__":
    main()
