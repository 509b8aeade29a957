#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, ``nvcc`` and this checkout; imports nothing of
JAX or of the reference package. Phases, each of which fails the run:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off for the plain versions;
2. build: the runtime-k library and the static-k builds the check needs,
   one ``nvcc`` per library, all started together; the SASS FADD count of
   the static fp probe at k=8 and k=24 (the fp adds must survive);
3. check: every kernel, mode and k in {0, 1, 24, K_MAX+7} against its plain
   PyTorch version on the card at a moderate size, and every mode at k in
   {0, 1} at the main path's shapes; the K_MAX clamp; runtime k bitwise
   equal to static k at k=24;
4. the main path at full size, through the user's entry points
   (``repro_torch.launch.probe.main`` and ``Campaign.characterize``): spmxv
   n=2^21 L=16 q=0 and q=1, matmul n=4096, probe 1056 steps; every payload
   check must pass, and every store must replay with 0 measured;
5. the kernels' launch counters above 0 and the plain versions' at 0 on the
   main path;
6. timings with CUDA events (median of 25) at the main path's shapes, k=0:
   kernel, plain version, bound, and one PyTorch library call where one
   computes the same function.

The last lines are the card, one ``{"kernels": [...]}`` JSON object, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12

CHECK_KS = (0, 1, 24)           # plus K_MAX + 7 (the clamp)
STATIC_CHECK_K = 24
TIMING_REPS = 25

MAIN_SPMXV_N = 2 ** 21
MAIN_MATMUL_N = 4096
MAIN_PROBE_STEPS = 1056


def banner(title: str) -> None:
    print(f"\n=== {title}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def host_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median host-clock time of one call of ``fn`` and a synchronize —
    what a sweep point sees (``core/absorption.py`` times this way)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, reps: int = TIMING_REPS):
    """Device time of one call of ``fn`` from a torch.profiler trace (CUPTI):
    (ms per call summed over its kernels, {kernel: ms per call}); (None, {})
    when the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].replace("void ", "")
            per_kernel[name] = (per_kernel.get(name, 0.0)
                                + e.time_range.elapsed_us() / 1e3 / reps)
    if not per_kernel:
        return None, {}
    return sum(per_kernel.values()), per_kernel


def time_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn``."""
    import torch

    for _ in range(warmup):
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


class Kernels:
    """The three kernels of the path: their modules and counters."""

    def __init__(self):
        from repro_torch.kernels.noise_probes import kernel as probe_k
        from repro_torch.kernels.noisy_matmul import kernel as matmul_k
        from repro_torch.kernels.spmv_ell import kernel as spmv_k

        self.rows = {
            "noise_probes": {
                "cuda": probe_k.probe_cuda, "plain": probe_k.probe_plain,
                "source": "src/repro_torch/csrc/noise_probes.cu",
                "replaces": "src/repro/kernels/noise_probes/kernel.py:42"},
            "spmv_ell": {
                "cuda": spmv_k.spmv_ell_cuda, "plain": spmv_k.spmv_ell_plain,
                "source": "src/repro_torch/csrc/spmv_ell.cu",
                "replaces": "src/repro/kernels/spmv_ell/kernel.py:98"},
            "noisy_matmul": {
                "cuda": matmul_k.matmul_cuda, "plain": matmul_k.matmul_plain,
                "source": "src/repro_torch/csrc/noisy_matmul.cu",
                "replaces": "src/repro/kernels/noisy_matmul/kernel.py:87"},
        }

    def reset(self) -> None:
        for row in self.rows.values():
            row["cuda"].launches = 0
            row["plain"].launches = 0

    def counts(self) -> dict:
        return {name: (row["cuda"].launches, row["plain"].launches)
                for name, row in self.rows.items()}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env() -> str:
    import torch

    banner("1. environment")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} "
          f"(x{torch.cuda.device_count()})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("plain versions: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")
    return card


def _static_set():
    from repro_torch.kernels.noise_slots import MODE_IDS
    from repro_torch.kernels.region import KERNEL_MODES

    src = {"probe": "noise_probes", "spmxv": "spmv_ell",
           "matmul": "noisy_matmul"}
    want = [(src[kern], MODE_IDS[m], STATIC_CHECK_K)
            for kern in ("probe", "spmxv", "matmul")
            for m in KERNEL_MODES[kern]]
    return want + [("noise_probes", MODE_IDS["fp"], 8)]


def phase_build() -> None:
    from repro_torch.kernels import _build

    banner("2. build")

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(_static_set()) + 1) as pool:
        rt = pool.submit(timed, _build.runtime_lib)
        statics = [pool.submit(timed, _build.static_lib, *s)
                   for s in _static_set()]
        rt_s = rt.result()
        for f in statics:
            f.result()
    print(f"runtime-k library (3 sources, parallel nvcc + link): "
          f"{rt_s:.1f} s; with {len(statics)} static-k builds alongside: "
          f"{time.perf_counter() - t0:.1f} s")
    fp = _build.sass_count(_build.static_lib_path("noise_probes", 1, 8), "FADD")
    fp24 = _build.sass_count(
        _build.static_lib_path("noise_probes", 1, STATIC_CHECK_K), "FADD")
    print(f"SASS FADD in the static fp probe: k=8 -> {fp}, "
          f"k={STATIC_CHECK_K} -> {fp24}")
    if fp is not None and fp24 - fp < (STATIC_CHECK_K - 8) * 4:
        raise RuntimeError("fp noise adds were folded: the k=24 build has "
                           f"{fp24 - fp} more FADD than k=8, want >= "
                           f"{(STATIC_CHECK_K - 8) * 4}")


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _close(got, want, what, failures, tf32=False):
    import torch

    err = _max_err(got, want)
    if not torch.isfinite(got).all():
        failures.append(f"{what}: non-finite values")
    elif tf32:
        lim = 1e-2 * float(want.float().abs().max())
        if err > lim:
            failures.append(f"{what}: max|d|={err:.3g} > {lim:.3g} (TF32)")
    elif not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        failures.append(f"{what}: max|d|={err:.3g} beyond rtol 1e-5 atol 1e-6")
    return err


def _equal(a, b, what, failures):
    import torch

    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if not torch.equal(x, y):
            failures.append(f"{what}: not bitwise equal")


def _cases(noise, pnoise, n_steps, vals, cols, x, a, b):
    """name -> (modes, runtime-k call, static-k call, plain call)."""
    from repro_torch.kernels.noise_probes.kernel import (probe, probe_plain,
                                                         probe_rt)
    from repro_torch.kernels.noisy_matmul.kernel import (matmul, matmul_plain,
                                                         matmul_rt)
    from repro_torch.kernels.spmv_ell.kernel import (spmv_ell, spmv_ell_plain,
                                                     spmv_ell_rt)

    return {
        "noise_probes": (("fp", "mxu", "vmem"),
                         lambda m, k: probe_rt(k, pnoise, mode=m, n_steps=n_steps),
                         lambda m, k: probe(pnoise, mode=m, k_noise=k, n_steps=n_steps),
                         lambda m, k: probe_plain(pnoise, mode=m, k_noise=k,
                                                  n_steps=n_steps)),
        "spmv_ell": (("fp", "vmem"),
                     lambda m, k: spmv_ell_rt(k, vals, cols, x, mode=m),
                     lambda m, k: spmv_ell(vals, cols, x, mode=m, k_noise=k),
                     lambda m, k: spmv_ell_plain(vals, cols, x, mode=m, k_noise=k)),
        "noisy_matmul": (("fp", "mxu", "vmem"),
                         lambda m, k: matmul_rt(k, a, b, noise, mode=m),
                         lambda m, k: matmul(a, b, noise, mode=m, k_noise=k),
                         lambda m, k: matmul_plain(a, b, noise, mode=m, k_noise=k)),
    }


def _check_cases(cases, ks, failures, max_err, full: bool) -> None:
    """Hold every kernel, mode and k against the plain version; with
    ``full`` also the K_MAX clamp and runtime k == static k."""
    import torch

    from repro_torch.kernels import noise_slots as ns

    for name, (modes, rt, static, plain) in cases.items():
        worst = 0.0
        for mode in modes:
            for k in ks:
                got = rt(mode, k)
                want = plain(mode, ns.clip_k(k))
                torch.cuda.synchronize()
                got_t = got if isinstance(got, tuple) else (None, got)
                want_t = want if isinstance(want, tuple) else (None, want)
                what = f"{name}/{mode}/k={k}"
                if got_t[0] is not None:
                    worst = max(worst, _close(got_t[0], want_t[0],
                                              what + " out", failures,
                                              tf32=name == "noisy_matmul"))
                worst = max(worst, _close(got_t[1], want_t[1],
                                          what + " nacc", failures,
                                          tf32=mode == "mxu"))
            if full:
                _equal(rt(mode, ns.K_MAX + 7), rt(mode, ns.K_MAX),
                       f"{name}/{mode} clamp at K_MAX", failures)
                _equal(rt(mode, STATIC_CHECK_K), static(mode, STATIC_CHECK_K),
                       f"{name}/{mode} runtime k vs static k={STATIC_CHECK_K}",
                       failures)
        torch.cuda.synchronize()
        max_err[name] = max(max_err.get(name, 0.0), worst)
        print(f"{name}: modes {', '.join(modes)} x k in {list(ks)}: "
              f"max|kernel - plain| = {worst:.3g}"
              + (f"; clamp and runtime==static(k={STATIC_CHECK_K}) checked"
                 if full else ""))


def main_inputs() -> dict:
    """The main path's inputs, as its regions make them on the card."""
    from repro_torch.kernels.region import pallas_region

    vals, cols, x = pallas_region("spmxv", n=MAIN_SPMXV_N,
                                  nnz_per_row=16).args_for_rt("fp")
    a, b, noise = pallas_region("matmul", n=MAIN_MATMUL_N).args_for_rt("fp")
    return {"vals": vals, "cols": cols, "x": x, "a": a, "b": b,
            "noise": noise}


def phase_check(main: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.convert import to_torch
    from repro_torch.kernels import noise_slots as ns
    from repro_torch.kernels.noisy_matmul.ref import default_noise_operand
    from repro_torch.kernels.spmv_ell.ref import make_band_ell

    banner("3. kernels against their plain versions")
    failures: list[str] = []
    max_err: dict = {}
    dev = torch.device("cuda")
    noise = default_noise_operand(dev)
    vals, cols = make_band_ell(16384, 16, 0.5, seed=0)
    x = np.random.RandomState(1).standard_normal(16384).astype(np.float32)
    vals, cols, x = to_torch((vals, cols, x), dev)
    a, b = to_torch((np.random.RandomState(0).standard_normal((512, 512))
                     .astype(np.float32),
                     np.random.RandomState(1).standard_normal((512, 512))
                     .astype(np.float32)), dev)
    print("moderate size: probe 64 steps, spmv n=16384 L=16 q=0.5, "
          "matmul n=512")
    _check_cases(_cases(noise, noise, 64, vals, cols, x, a, b),
                 CHECK_KS + (ns.K_MAX + 7,), failures, max_err, full=True)
    print(f"main path's shapes: probe {MAIN_PROBE_STEPS} steps, spmv "
          f"n={MAIN_SPMXV_N} L=16 q=0, matmul n={MAIN_MATMUL_N}")
    _check_cases(_cases(main["noise"], main["noise"], MAIN_PROBE_STEPS,
                        main["vals"], main["cols"], main["x"], main["a"],
                        main["b"]),
                 (0, 1), failures, max_err, full=False)
    if failures:
        raise RuntimeError("kernel check failed:\n  " + "\n  ".join(failures))
    return max_err


def _payloads_ok(rep) -> None:
    for mode, res in rep.results.items():
        inj = res.injection
        if inj is None or inj.payload != inj.expected or not inj.expected:
            raise RuntimeError(f"{rep.region}/{mode}: payload check failed "
                               f"({inj})")
        fit = res.fit
        if not all(math.isfinite(v) for v in (fit.k1, fit.t0, fit.slope)):
            raise RuntimeError(f"{rep.region}/{mode}: non-finite fit {fit}")


def phase_main(tmp: str, kernels: Kernels) -> dict:
    from repro_torch.core.campaign import Campaign
    from repro_torch.core.controller import Controller
    from repro_torch.kernels.region import pallas_region
    from repro_torch.launch.probe import finish_stats, main as probe_main

    banner("4. main path at full size")
    stores = {name: os.path.join(tmp, f"{name}.jsonl")
              for name in ("spmxv_q0", "spmxv_q1", "matmul", "probe")}
    cli = {
        "spmxv_q0": ["--pallas", "spmxv", "--pallas-n", str(MAIN_SPMXV_N),
                     "--modes", "fp,vmem"],
        "matmul": ["--pallas", "matmul", "--pallas-n", str(MAIN_MATMUL_N),
                   "--modes", "fp,mxu,vmem"],
        "probe": ["--pallas", "probe", "--pallas-n", str(MAIN_PROBE_STEPS)],
    }
    seconds = {}
    kernels.reset()
    for name in ("spmxv_q0", "spmxv_q1", "matmul", "probe"):
        t0 = time.perf_counter()
        before = kernels.counts()
        if name == "spmxv_q1":
            region = pallas_region("spmxv", n=MAIN_SPMXV_N, nnz_per_row=16,
                                   q=1.0)
            camp = Campaign(stores[name], Controller(reps=3))
            print(f"== Campaign.characterize: {region.name} "
                  f"(campaign store: {stores[name]})")
            rep = camp.characterize(region, ["fp", "vmem"])
            print(rep.summary())
            finish_stats(camp.stats, False)
            camp.store.close()
        else:
            rep = probe_main(cli[name] + ["--reps", "3", "--store",
                                          stores[name]])
        _payloads_ok(rep)
        seconds[name] = time.perf_counter() - t0
        launched = {k: n - before[k][0] for k, (n, _) in kernels.counts().items()
                    if n - before[k][0]}
        print(f"  ({seconds[name]:.1f} s; kernel launches in this "
              f"characterization: {launched})")
    counts = kernels.counts()

    banner("5. launches on the main path")
    for name, (n_cuda, n_plain) in counts.items():
        print(f"{name}: kernel {n_cuda} launches, plain version {n_plain}")
        if n_cuda <= 0:
            raise RuntimeError(f"{name}: the main path never launched it")
        if n_plain:
            raise RuntimeError(f"{name}: the main path took the plain version")

    banner("4b. every store replays with 0 measured")
    for name in ("spmxv_q0", "matmul", "probe"):
        probe_main(cli[name] + ["--reps", "3", "--store", stores[name],
                                "--expect-no-measure"])
    region = pallas_region("spmxv", n=MAIN_SPMXV_N, nnz_per_row=16, q=1.0)
    camp = Campaign(stores["spmxv_q1"], Controller(reps=3))
    camp.characterize(region, ["fp", "vmem"])
    camp.store.close()
    finish_stats(camp.stats, True)
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


def phase_timing(main: dict, max_err: dict, launches: dict) -> list:
    import torch

    from repro_torch.kernels.noise_probes.kernel import probe_plain, probe_rt
    from repro_torch.kernels.noisy_matmul.kernel import matmul_plain, matmul_rt
    from repro_torch.kernels.spmv_ell.kernel import spmv_ell_plain, spmv_ell_rt

    banner("6. timings at the main path's shapes, k=0 (CUDA events, median "
           f"of {TIMING_REPS})")
    rows = []

    # spmv_ell, q=0
    vals, cols, x = main["vals"], main["cols"], main["x"]
    R, L = vals.shape
    order = torch.argsort(cols, dim=1)
    warnings.filterwarnings("ignore", message="Sparse")   # beta / invariants
    csr = torch.sparse_csr_tensor(
        torch.arange(0, R * L + 1, L, device=vals.device, dtype=torch.int64),
        torch.gather(cols, 1, order).flatten().long(),
        torch.gather(vals, 1, order).flatten(), size=(R, x.shape[0]))
    lib_err = _max_err(csr @ x, spmv_ell_plain(vals, cols, x)[0])
    spmv_bytes = 4 * (2 * R * L + x.shape[0] + R + 1024)
    rows.append(("spmv_ell", lambda: spmv_ell_rt(0, vals, cols, x, mode="fp"),
                 lambda: spmv_ell_plain(vals, cols, x, mode="fp", k_noise=0),
                 lambda: csr @ x, spmv_bytes, 2 * R * L, FP32_FLOPS,
                 f"torch.sparse_csr_tensor @ x (max|d| vs plain {lib_err:.3g})"))

    # noisy_matmul, n=4096
    a, b, noise = main["a"], main["b"], main["noise"]
    n = MAIN_MATMUL_N

    def tf32_matmul():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    rows.append(("noisy_matmul", lambda: matmul_rt(0, a, b, noise, mode="fp"),
                 lambda: matmul_plain(a, b, noise, mode="fp", k_noise=0),
                 tf32_matmul, 4 * (3 * n * n + 1024), 2 * n ** 3, TF32_FLOPS,
                 "torch.matmul with TF32 allowed"))

    # noise_probes, 1056 steps
    pnoise = main["noise"]
    rows.append(("noise_probes",
                 lambda: probe_rt(0, pnoise, mode="fp", n_steps=MAIN_PROBE_STEPS),
                 lambda: probe_plain(pnoise, mode="fp", k_noise=0,
                                     n_steps=MAIN_PROBE_STEPS),
                 None, 4 * (128 * 128 + 1024), 0, FP32_FLOPS, None))

    meta = Kernels().rows
    out = []
    for (name, kern, plain, lib, nbytes, nops, peak, lib_what) in rows:
        kernel_ms = time_ms(kern)
        kernel_host_ms = host_ms(kern)
        dev_ms, per_kernel = device_ms(kern)
        plain_ms = time_ms(plain)
        library_ms = time_ms(lib) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{name}: kernel_ms={kernel_ms!r} (host clock with "
              f"synchronize: {kernel_host_ms!r}) plain_ms={plain_ms!r} "
              f"bound_ms={bound_ms!r} ({bound_by}) library_ms={library_ms!r}"
              + (f" [{lib_what}]" if lib_what else "")
              + f" launches on the main path={launches[name]}")
        print(f"  device time per call (torch.profiler): {dev_ms!r} ms = "
              + ", ".join(f"{k} {v!r}" for k, v in per_kernel.items()))
        out.append({"name": name, "route": "cuda",
                    "source": meta[name]["source"],
                    "replaces": meta[name]["replaces"],
                    "launches": launches[name], "max_abs_err": max_err[name],
                    "ms": kernel_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)

    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    main_args = main_inputs()
    max_err = phase_check(main_args)
    kernels = Kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_main(tmp, kernels)
    rows = phase_timing(main_args, max_err, launches)
    print(f"\nchip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
