#!/usr/bin/env python
"""Host and device cost of one kernel-wrapper call of the PyTorch port, on
the card.

    PYTHONPATH=src python -m repro_torch.launch.host_path [--calls 400] \
        [--top 12] [--cases probe,spmv_q0,spmv_q1] [--timing-only]

For the probe (1056 grid steps) and the ELL spmv (n=2^21, L=16, q=0 and
q=1), each runtime k at k=0 in fp mode (a sweep's t(0) point), it reports:

* timing: the median CUDA-event time of one call, and the device time of
  one call (the sum of its kernels in a torch.profiler trace) with the
  number of kernels it launched;
* dispatch: the host clock around the call alone (no synchronize), median
  over ``--calls`` calls, each followed by a synchronize outside the window;
* cProfile of the same calls: the functions with the most own time, in µs
  and calls per wrapper call;
* torch.profiler (CPU and CUDA activities) over the same calls: the host
  events (aten ops, CUDA runtime calls; nested ones counted in their
  parents too) and the kernels the card ran, in µs and count per call.

``--timing-only`` stops after the first item (to compare two checkouts in
turns).

It uses only the wrappers' public calls, so it profiles any checkout of the
port: run this file with that checkout's ``src`` first on ``PYTHONPATH``
(``python src/repro_torch/launch/host_path.py``). Needs a CUDA card; the
last line is one JSON object ``{"card": ..., "cases": {case: {...}}}``.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def _cases(dev, names):
    """{case: fn()} on the main path's inputs, made from seeds."""
    from repro_torch.kernels.noise_probes.kernel import probe_rt
    from repro_torch.kernels.noisy_matmul.ref import default_noise_operand
    from repro_torch.kernels.spmv_ell.kernel import spmv_ell_rt
    from repro_torch.kernels.spmv_ell.ref import make_band_ell

    cases = {}
    if "probe" in names:
        noise = default_noise_operand(dev)
        cases["noise_probes s1056 k0"] = lambda: probe_rt(
            0, noise, mode="fp", n_steps=1056)
    n = 2 ** 21
    for q in (0, 1):
        if f"spmv_q{q}" not in names:
            continue
        vals, cols = make_band_ell(n, 16, float(q), seed=0)
        x = np.random.RandomState(1).standard_normal(n).astype(np.float32)
        vals, cols, x = (torch.from_numpy(a).to(dev) for a in (vals, cols, x))
        cases[f"spmv_ell n2^21 L16 q{q} k0"] = (
            lambda v=vals, c=cols, xx=x: spmv_ell_rt(0, v, c, xx, mode="fp"))
    return cases


def _event_ms(fn, reps: int) -> float:
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


def _dispatch_us(fn, calls: int) -> float:
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _cprofile(fn, calls: int, top: int) -> list:
    """[(function, µs own time per call, calls per call)], most first."""
    prof = cProfile.Profile()
    for _ in range(calls):
        prof.enable()
        fn()
        prof.disable()
        torch.cuda.synchronize()
    rows = []
    for (path, line, func), (_, nc, tt, _, _) in \
            pstats.Stats(prof).stats.items():
        where = path.rsplit("/", 2)
        rows.append((f"{'/'.join(where[-2:])}:{line} {func}",
                     tt / calls * 1e6, nc / calls))
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def _torch_profile(fn, calls: int):
    """({host event: [µs per call, count per call]}, {kernel: [µs per call,
    count per call]})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    host: dict = {}
    device: dict = {}
    for e in prof.events():
        side = device if e.device_type == torch.autograd.DeviceType.CUDA \
            else host
        name = e.name.split("(")[0].replace("void ", "")
        us, n = side.get(name, (0.0, 0.0))
        side[name] = [us + e.time_range.elapsed_us() / calls, n + 1 / calls]
    host.pop("cudaDeviceSynchronize", None)
    return host, device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=400)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--cases", default="probe,spmv_q0,spmv_q1")
    ap.add_argument("--timing-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_path: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out: dict = {}
    for case, fn in _cases(torch.device("cuda"),
                           args.cases.split(",")).items():
        for _ in range(20):    # builds and first-call set-up
            fn()
        torch.cuda.synchronize()
        event = _event_ms(fn, args.calls)
        _, device = _torch_profile(fn, args.calls)
        out[case] = {"event_ms": event,
                     "device_ms": sum(us for us, _ in device.values()) / 1e3,
                     "kernels_per_call": sum(n for _, n in device.values())}
        print(f"== {case}: {event!r} ms by events, {out[case]['device_ms']!r} "
              f"ms on the device in {out[case]['kernels_per_call']:g} "
              f"kernels: " + ", ".join(f"{name} x{n:g} {us!r} us"
                                       for name, (us, n) in device.items()),
              flush=True)
        if args.timing_only:
            continue
        dispatch = _dispatch_us(fn, args.calls)
        top = _cprofile(fn, args.calls, args.top)
        host, _ = _torch_profile(fn, args.calls)
        out[case].update({"dispatch_us": dispatch, "cprofile_top": top,
                          "host_events": host})
        print(f"  dispatch {dispatch!r} us a call (median of {args.calls})")
        print("  cProfile, own time per call:")
        for name, us, n in top:
            print(f"    {us:9.3f} us  x{n:g}  {name}")
        print("  torch.profiler host events per call:")
        for name, (us, n) in sorted(host.items(), key=lambda kv: -kv[1][0]):
            print(f"    {us:9.3f} us  x{n:g}  {name}", flush=True)
    print(card)
    print(json.dumps({"card": card, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
