#!/usr/bin/env python
"""Device cost of one noise pattern in each CUDA kernel of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.slot_cost [--modes mxu] \
        [--ks 0,4,8,16] [--cases noise_probes,noisy_matmul,flash_attention]

For every kernel wrapper of ``repro_torch`` (the probe at 1056 grid steps,
the matmul at n=4096, attention at Qwen3-30B-A3B's widths with head_dim 128
and the same with head_dim 256; f32, causal), or those ``--cases`` names,
and every mode, it times the runtime-k wrapper with CUDA events (median of
``--reps``) at each k of ``--ks`` and fits the time per pattern by least
squares. It uses only the
wrappers' public calls, so it measures any checkout of the port: run this
file with that checkout's ``src`` first on ``PYTHONPATH`` (``python
src/repro_torch/launch/slot_cost.py``) and compare two checkouts in one
session on one card. Needs a CUDA card; the last line is one JSON object
``{"card": ..., "costs": {case: {mode: {"t_ms": {k: ms}, "us_per_pattern":
us}}}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

ATTENTION = {"batch": 1, "heads": 32, "kv_heads": 4, "seq": 4096}


def _event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _cases(dev, kernels):
    """{case: fn(k, mode)} on seeded inputs, for the cases whose kernel is
    in ``kernels``."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_rt
    from repro_torch.kernels.noise_probes.kernel import probe_rt
    from repro_torch.kernels.noisy_matmul.kernel import matmul_rt

    rs = np.random.RandomState(0)

    def randn(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)
                                ).to(dev)

    noise = randn(128, 128)
    cases = {}
    if "noise_probes" in kernels:
        cases["noise_probes s1056"] = lambda k, m: probe_rt(
            k, noise, mode=m, n_steps=1056)
    if "noisy_matmul" in kernels:
        a, b = randn(4096, 4096), randn(4096, 4096)
        cases["noisy_matmul n4096"] = lambda k, m: matmul_rt(k, a, b, noise,
                                                             mode=m)
    B, H, KH, S = (ATTENTION[x] for x in ("batch", "heads", "kv_heads",
                                          "seq"))
    for hd in (128, 256) if "flash_attention" in kernels else ():
        q, kk, v = randn(B, H, S, hd), randn(B, KH, S, hd), randn(B, KH, S, hd)
        cases[f"flash_attention hd{hd} s{S}"] = (
            lambda k, m, q=q, kk=kk, v=v: flash_attention_rt(
                k, q, kk, v, noise, mode=m))
    return cases


def slot_costs(modes, ks, reps: int = 15,
               kernels=("noise_probes", "noisy_matmul", "flash_attention")
               ) -> dict:
    """{case: {mode: {"t_ms": {k: ms}, "us_per_pattern": us}}} on the
    current CUDA device; prints one line per (case, mode)."""
    costs: dict = {}
    for case, fn in _cases(torch.device("cuda"), kernels).items():
        for mode in modes:
            t = {k: _event_ms(lambda: fn(k, mode), reps) for k in ks}
            slope = float(np.polyfit(ks, [t[k] for k in ks], 1)[0]) * 1e3
            costs.setdefault(case, {})[mode] = {"t_ms": t,
                                                "us_per_pattern": slope}
            print(f"{case} {mode}: " + ", ".join(f"k={k} {t[k]:.4f} ms"
                                                  for k in ks)
                  + f" -> {slope:.2f} us a pattern", flush=True)
    return costs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", default="mxu",
                    help="comma-separated noise modes (fp, mxu, vmem)")
    ap.add_argument("--ks", default="0,4,8,16",
                    help="comma-separated noise quantities to time")
    ap.add_argument("--cases", default="noise_probes,noisy_matmul,"
                    "flash_attention", help="comma-separated kernels to time")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slot_cost: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    costs = slot_costs(args.modes.split(","),
                       [int(x) for x in args.ks.split(",")], args.reps,
                       args.cases.split(","))
    print(card)
    print(json.dumps({"card": card, "costs": costs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
