#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, ``nvcc`` and this checkout; imports nothing of
JAX or of the reference package. Phases, each of which fails the run:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off for the plain versions;
2. build: the runtime-k library and the static-k builds the check needs,
   one ``nvcc`` per library, all started together; the SASS FADD count of
   the static fp probe and fp attention at k=8 and k=24 (the fp adds must
   survive);
3. check: every kernel, mode and k in {0, 1, 24, K_MAX+7} against its plain
   PyTorch version on the card at moderate sizes (attention: B=2, H=8,
   KH=2, S=512, hd 64, 128 and 256, causal / non-causal / window 128, f32
   and bf16, and seq 24), and every mode at k in {0, 1} at the main path's
   shapes; the K_MAX clamp; runtime k bitwise equal to static k at k=24
   (attention: hd 128 f32, hd 256 f32 and bf16). Attention's output is held
   row by row (``row_excess``); the same check must refuse the kernel fed
   bf16-rounded q, k, v (a control that the tolerance is tight enough);
4. the main path, through the user's entry points, each path driven with
   every launch count set to 0 just before it and read just after:
   a. Qwen3-30B-A3B's attention (32 query heads, 4 KV heads, head_dim 128,
      batch 1, seq 4096, causal) as a one-shard SweepPlan run by
      ``python -m repro_torch.fleet run`` (a subprocess worker), then
      ``run --resume --expect-no-measure`` (must measure 0), then
      ``status``;
   b. an attention family at seq 256 and 512 (the region's default widths)
      on two subprocess shards, merged, then replayed;
   c. ``repro_torch.launch.probe --pallas attention --pallas-n 1024``;
   d. the first slice's paths through the same spine: spmxv n=2^21 L=16
      q=0 and q=1, matmul n=4096, probe 1056 steps;
   every payload check must pass, and every store must replay with 0
   measured;
5. each kernel's launch counter above 0 and its plain version's at 0 on the
   main path (fleet workers report their counts in their stats files);
6. timings with CUDA events (median of 25) at the main path's shapes, k=0:
   kernel, plain version, bound, and one PyTorch library call where one
   computes the same function (attention: SDPA in f32 as ``library_ms``,
   and beside it SDPA with TF32 allowed and SDPA in bf16).

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
# Qwen3-30B-A3B's attention widths (src/repro/configs/qwen3_moe_30b_a3b.py)
MAIN_ATTENTION = {"batch": 1, "heads": 32, "kv_heads": 4, "seq": 4096,
                  "head_dim": 128}
# (label, hd, dtype, seq, causal, window, static): the attention cases of
# phase 3 at B=2, H=8, KH=2; ``static`` also checks the clamp and static k
ATTENTION_CASES = (
    ("hd128 f32 causal", 128, "float32", 512, True, 0, True),
    ("hd64 f32 causal", 64, "float32", 512, True, 0, False),
    ("hd128 f32 non-causal", 128, "float32", 512, False, 0, False),
    ("hd128 f32 window 128", 128, "float32", 512, True, 128, False),
    ("hd128 bf16 causal", 128, "bfloat16", 512, True, 0, False),
    ("hd64 bf16 non-causal window 128", 64, "bfloat16", 512, False, 128,
     False),
    ("hd128 f32 causal seq 24", 128, "float32", 24, True, 0, False),
    ("hd256 f32 causal", 256, "float32", 512, True, 0, True),
    ("hd256 bf16 causal", 256, "bfloat16", 512, True, 0, True),
)


def attention_variant(hd: int, dtype: str) -> tuple:
    """The defines of one static attention build (``kernel.py``)."""
    return (("REPRO_STATIC_HD", hd),
            ("REPRO_STATIC_BF16", int(dtype == "bfloat16")))


def banner(title: str) -> None:
    print(f"\n=== {title}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card_state() -> str:
    """The card's SM clock, power draw and temperature (``nvidia-smi``):
    printed around the long sweeps, where a falling clock would read as
    saturation."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
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
    """The kernels of the path: their modules and counters, plus the counts
    fleet worker subprocesses report."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import kernel as fa_k
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
            "flash_attention": {
                "cuda": fa_k.flash_attention_cuda,
                "plain": fa_k.flash_attention_plain,
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:157"},
        }
        self.workers = {name: [0, 0] for name in self.rows}

    def reset(self) -> None:
        for name, row in self.rows.items():
            row["cuda"].launches = 0
            row["plain"].launches = 0
            self.workers[name] = [0, 0]

    def add_worker(self, stats_path: str) -> None:
        """Add the launches a fleet worker reported in its stats file."""
        with open(stats_path) as f:
            launches = json.load(f)["launches"]
        for name, (n_cuda, n_plain) in launches.items():
            self.workers[name][0] += n_cuda
            self.workers[name][1] += n_plain

    def counts(self) -> dict:
        return {name: (row["cuda"].launches + self.workers[name][0],
                       row["plain"].launches + self.workers[name][1])
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
    """(kernel source, mode id, k, variant defines) of every static build
    the check needs."""
    from repro_torch.kernels.noise_slots import MODE_IDS
    from repro_torch.kernels.region import KERNEL_MODES

    src = {"probe": "noise_probes", "spmxv": "spmv_ell",
           "matmul": "noisy_matmul", "attention": "flash_attention"}
    want = [(src[kern], MODE_IDS[m], STATIC_CHECK_K, ())
            for kern in ("probe", "spmxv", "matmul")
            for m in KERNEL_MODES[kern]]
    want += [("flash_attention", MODE_IDS[m], STATIC_CHECK_K,
              attention_variant(hd, dtype))
             for _, hd, dtype, _, _, _, static in ATTENTION_CASES if static
             for m in KERNEL_MODES["attention"]]
    return want + [("noise_probes", MODE_IDS["fp"], 8, ()),
                   ("flash_attention", MODE_IDS["fp"], 8,
                    attention_variant(128, "float32"))]


def _fadd_grows(kernel: str, defines: tuple, per_pattern: int) -> None:
    from repro_torch.kernels import _build

    fp8 = _build.sass_count(_build.static_lib_path(kernel, 1, 8, defines),
                            "FADD")
    fp24 = _build.sass_count(
        _build.static_lib_path(kernel, 1, STATIC_CHECK_K, defines), "FADD")
    print(f"SASS FADD in the static fp {kernel}: k=8 -> {fp8}, "
          f"k={STATIC_CHECK_K} -> {fp24}")
    want = (STATIC_CHECK_K - 8) * per_pattern
    if fp8 is not None and fp24 - fp8 < want:
        raise RuntimeError(f"{kernel}: fp noise adds were folded: the k=24 "
                           f"build has {fp24 - fp8} more FADD than k=8, "
                           f"want >= {want}")


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
        static_s = [f.result() for f in statics]
    print(f"runtime-k library ({len(_build.KERNEL_SOURCES)} sources, "
          f"parallel nvcc + link): {rt_s:.1f} s; {len(statics)} static-k "
          f"builds alongside (slowest {max(static_s):.1f} s): "
          f"{time.perf_counter() - t0:.1f} s in all")
    # 4 elements per thread and pattern: k=24 holds 16 patterns more
    _fadd_grows("noise_probes", (), 4)
    _fadd_grows("flash_attention", attention_variant(128, "float32"), 4)


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _close(got, want, what, failures, tol="exact"):
    """Hold ``got`` against ``want``: "exact" (rtol 1e-5, atol 1e-6),
    "tf32" (max|d| <= 1e-2 max|want|) or "rows" (attention's per-row limit,
    ``row_excess`` <= 1); returns max|d|."""
    import torch

    from repro_torch.kernels.flash_attention.ref import (TF32_ROW_TOL,
                                                         row_excess)

    err = _max_err(got, want)
    if not torch.isfinite(got.float()).all():
        failures.append(f"{what}: non-finite values")
    elif tol == "rows":
        excess = row_excess(got, want)
        if excess > 1:
            failures.append(f"{what}: max|d|={err:.3g}, {excess:.3g} times "
                            f"its per-row limit (TF32 rows, {TF32_ROW_TOL})")
    elif tol == "tf32":
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
    """name -> (modes, runtime-k call, static-k call, plain call, output
    tolerance)."""
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
                                                  n_steps=n_steps), "exact"),
        "spmv_ell": (("fp", "vmem"),
                     lambda m, k: spmv_ell_rt(k, vals, cols, x, mode=m),
                     lambda m, k: spmv_ell(vals, cols, x, mode=m, k_noise=k),
                     lambda m, k: spmv_ell_plain(vals, cols, x, mode=m, k_noise=k),
                     "exact"),
        "noisy_matmul": (("fp", "mxu", "vmem"),
                         lambda m, k: matmul_rt(k, a, b, noise, mode=m),
                         lambda m, k: matmul(a, b, noise, mode=m, k_noise=k),
                         lambda m, k: matmul_plain(a, b, noise, mode=m, k_noise=k),
                         "tf32"),
    }


def _attention_case(q, k, v, noise, **kw):
    """(modes, runtime-k call, static-k call, plain call, output tolerance)
    of the attention kernel on one input set."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_plain, flash_attention_rt)

    return (("fp", "mxu", "vmem"),
            lambda m, kn: flash_attention_rt(kn, q, k, v, noise, mode=m, **kw),
            lambda m, kn: flash_attention(q, k, v, noise, mode=m, k_noise=kn,
                                          **kw),
            lambda m, kn: flash_attention_plain(q, k, v, noise, mode=m,
                                                k_noise=kn, **kw),
            "rows")


def _check_cases(cases, ks, failures, max_err, full: bool) -> None:
    """Hold every kernel, mode and k against the plain version; with
    ``full`` also the K_MAX clamp and runtime k == static k."""
    import torch

    from repro_torch.kernels import noise_slots as ns

    for name, (modes, rt, static, plain, out_tol) in cases.items():
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
                                              tol=out_tol))
                worst = max(worst, _close(got_t[1], want_t[1],
                                          what + " nacc", failures,
                                          tol="tf32" if mode == "mxu"
                                          else "exact"))
            if full:
                _equal(rt(mode, ns.K_MAX + 7), rt(mode, ns.K_MAX),
                       f"{name}/{mode} clamp at K_MAX", failures)
                _equal(rt(mode, STATIC_CHECK_K), static(mode, STATIC_CHECK_K),
                       f"{name}/{mode} runtime k vs static k={STATIC_CHECK_K}",
                       failures)
        torch.cuda.synchronize()
        key = name.split(" ")[0]
        max_err[key] = max(max_err.get(key, 0.0), worst)
        print(f"{name}: modes {', '.join(modes)} x k in {list(ks)}: "
              f"max|kernel - plain| = {worst:.3g}"
              + (f"; clamp and runtime==static(k={STATIC_CHECK_K}) checked"
                 if full else ""), flush=True)


def main_inputs() -> dict:
    """The main path's inputs, as its regions make them on the card."""
    from repro_torch.kernels.region import pallas_region

    vals, cols, x = pallas_region("spmxv", n=MAIN_SPMXV_N,
                                  nnz_per_row=16).args_for_rt("fp")
    a, b, noise = pallas_region("matmul", n=MAIN_MATMUL_N).args_for_rt("fp")
    q, k, v, _ = pallas_region("attention",
                               **MAIN_ATTENTION).args_for_rt("fp")
    return {"vals": vals, "cols": cols, "x": x, "a": a, "b": b,
            "noise": noise, "q": q, "k": k, "v": v}


def _attention_inputs(dev, B, H, KH, S, hd, dtype, seed):
    import numpy as np

    from repro_torch.convert import to_torch

    rs = np.random.RandomState(seed)
    arrays = (rs.standard_normal((B, H, S, hd)), rs.standard_normal(
        (B, KH, S, hd)), rs.standard_normal((B, KH, S, hd)))
    return tuple(t.to(dtype) for t in
                 to_torch([a.astype(np.float32) for a in arrays], dev))


def _bf16_control(q, k, v, noise, label, failures) -> None:
    """The attention check must refuse what a kernel with bf16 operands
    would give: the TF32 kernel fed q, k, v rounded to bf16, held against
    the plain version on the unrounded inputs."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attention_rt)
    from repro_torch.kernels.flash_attention.ref import row_excess

    want = flash_attention_plain(q, k, v, noise)[0]
    tf32 = row_excess(flash_attention_rt(0, q, k, v, noise)[0], want)
    ctl = row_excess(flash_attention_rt(
        0, *(t.bfloat16().float() for t in (q, k, v)), noise)[0], want)
    print(f"flash_attention ({label}): per-row excess (<= 1 passes): TF32 "
          f"kernel {tf32:.3g}, bf16-operand control {ctl:.3g}", flush=True)
    if ctl <= 1:
        failures.append(f"flash_attention ({label}): the per-row check passes "
                        f"a bf16-operand control (excess {ctl:.3g})")


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
          "matmul n=512, attention B=2 H=8 KH=2 S=512")
    all_ks = CHECK_KS + (ns.K_MAX + 7,)
    _check_cases(_cases(noise, noise, 64, vals, cols, x, a, b), all_ks,
                 failures, max_err, full=True)
    for i, (label, hd, dtype, seq, causal, window, static) in enumerate(
            ATTENTION_CASES):
        q, k, v = _attention_inputs(dev, 2, 8, 2, seq, hd,
                                    getattr(torch, dtype), seed=i)
        _check_cases({f"flash_attention ({label})": _attention_case(
                         q, k, v, noise, causal=causal, window=window)},
                     all_ks, failures, max_err, full=static)
        if i == 0:
            _bf16_control(q, k, v, noise, label, failures)
    print(f"main path's shapes: probe {MAIN_PROBE_STEPS} steps, spmv "
          f"n={MAIN_SPMXV_N} L=16 q=0, matmul n={MAIN_MATMUL_N}, attention "
          f"{MAIN_ATTENTION}")
    main_cases = _cases(main["noise"], main["noise"], MAIN_PROBE_STEPS,
                        main["vals"], main["cols"], main["x"], main["a"],
                        main["b"])
    main_cases["flash_attention"] = _attention_case(
        main["q"], main["k"], main["v"], main["noise"])
    _check_cases(main_cases, (0, 1), failures, max_err, full=False)
    _bf16_control(main["q"], main["k"], main["v"], main["noise"],
                  "main shape", failures)
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


def _fleet(*args) -> None:
    """``python -m repro_torch.fleet ARGS`` as a user runs it, its output
    streamed; raises on a nonzero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, "-m", "repro_torch.fleet", *args],
                        env=env, timeout=900).returncode
    if rc:
        raise RuntimeError(f"python -m repro_torch.fleet {' '.join(args)}: "
                           f"exit {rc}")


def _fleet_plan_run(tmp: str, name: str, params: dict, shards: int,
                    kernels: Kernels) -> dict:
    """Save a plan, run it through the fleet CLI (subprocess workers), check
    its payloads and fits from the merged store and report, replay it with
    --expect-no-measure, print its status; returns its report."""
    from repro_torch.core.campaign import CampaignStore
    from repro_torch.fleet.plan import SweepPlan, TargetSpec

    plan = SweepPlan(name=name, store=os.path.join(tmp, name, "store.jsonl"),
                     targets=[TargetSpec("pallas", ("fp", "mxu", "vmem"),
                                         params)],
                     reps=2, shards=shards, backend="cuda")
    path = plan.save(os.path.join(tmp, f"{name}.plan.json"))
    _fleet("run", "--plan", path)
    for ws in plan.worker_stores():
        kernels.add_worker(ws + ".stats.json")
    store = CampaignStore(plan.store, readonly=True)
    for key in plan.grid():
        pay = (store.done.get(key) or {}).get("payload") or {}
        if not pay.get("expected") or pay.get("payload") != pay["expected"]:
            raise RuntimeError(f"{name} {key}: payload check failed ({pay})")
    for (region, mode), ts in sorted(store.points.items()):
        print(f"  {region}/{mode} t(k) ms: "
              + ", ".join(f"{k}: {t * 1e3:.4f}" for k, t in sorted(ts.items())))
    with open(plan.report_path()) as f:
        report = json.load(f)
    for region, rep in report.items():
        for mode, row in rep["modes"].items():
            if not all(math.isfinite(row[f]) for f in
                       ("abs_raw", "t0_s", "slope_s_per_pattern")):
                raise RuntimeError(f"{region}/{mode}: non-finite fit {row}")
    _fleet("run", "--plan", path, "--resume", "--expect-no-measure")
    _fleet("status", "--plan", path)
    return report


def phase_main(tmp: str, kernels: Kernels) -> dict:
    from repro_torch.fleet.executor import run_worker
    from repro_torch.fleet.plan import SweepPlan, TargetSpec
    from repro_torch.launch.probe import main as probe_main

    banner("4. main path")
    seconds, verdicts = {}, {}
    counts = {name: [0, 0] for name in kernels.rows}

    def timed(name, kernel, fn):
        """Drive one path with every count set to 0 just before it; read
        the counts just after, and fail unless it launched ``kernel``."""
        kernels.reset()
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        path_counts = kernels.counts()
        for k, (n_cuda, n_plain) in path_counts.items():
            counts[k][0] += n_cuda
            counts[k][1] += n_plain
        print(f"  ({name}: {seconds[name]:.1f} s; launches (kernel, plain): "
              f"{ {k: c for k, c in path_counts.items() if any(c)} })",
              flush=True)
        if path_counts[kernel][0] <= 0:
            raise RuntimeError(f"{name}: the path never launched {kernel}")
        return out

    print(f"== 4a. Qwen3-30B-A3B attention {MAIN_ATTENTION}, one shard; "
          f"card before (SM clock, power, temperature): {card_state()}",
          flush=True)
    report = timed("attention_qwen3", "flash_attention",
                   lambda: _fleet_plan_run(
        tmp, "qwen3_30b_a3b_attention",
        {"kernel": "attention", "sizes": [MAIN_ATTENTION["seq"]],
         **{k: v for k, v in MAIN_ATTENTION.items() if k != "seq"}},
        1, kernels))
    print(f"  card after: {card_state()}", flush=True)
    for region, rep in report.items():
        verdicts[region] = (rep["bottleneck"]["label"],
                            {m: row["abs_raw"] for m, row in
                             rep["modes"].items()},
                            {m: row["t0_s"] for m, row in
                             rep["modes"].items()})
    print("== 4b. attention family seq 256, 512 (default widths), two "
          "shards on one card", flush=True)
    timed("attention_family", "flash_attention", lambda: _fleet_plan_run(
        tmp, "attention_family", {"kernel": "attention",
                                  "sizes": [256, 512]}, 2, kernels))

    cli = {
        "attention_1024": ["--pallas", "attention", "--pallas-n", "1024"],
        "spmxv_q0": ["--pallas", "spmxv", "--pallas-n", str(MAIN_SPMXV_N),
                     "--modes", "fp,vmem"],
        "matmul": ["--pallas", "matmul", "--pallas-n", str(MAIN_MATMUL_N)],
        "probe": ["--pallas", "probe", "--pallas-n", str(MAIN_PROBE_STEPS)],
    }
    stores = {name: os.path.join(tmp, f"{name}.jsonl")
              for name in (*cli, "spmxv_q1")}
    q1_plan = SweepPlan(name="spmxv_q1", store=stores["spmxv_q1"],
                        targets=[TargetSpec("pallas", ("fp", "vmem"), {
                            "kernel": "spmxv", "sizes": [MAIN_SPMXV_N],
                            "qs": [1.0], "nnz_per_row": 16})],
                        reps=3, backend="cuda")

    def run(name, expect_no_measure=False):
        if name == "spmxv_q1":
            return run_worker(q1_plan, expect_no_measure=expect_no_measure)
        return probe_main(cli[name] + ["--reps", "3", "--store", stores[name]]
                          + (["--expect-no-measure"] if expect_no_measure
                             else []))

    path_kernel = {"attention_1024": "flash_attention",
                   "spmxv_q0": "spmv_ell", "spmxv_q1": "spmv_ell",
                   "matmul": "noisy_matmul", "probe": "noise_probes"}
    for name, kernel in path_kernel.items():
        print(f"== 4{'c' if name == 'attention_1024' else 'd'}. {name}",
              flush=True)
        reports, _ = timed(name, kernel, lambda: run(name))
        for rep in reports.values():
            _payloads_ok(rep)
            verdicts[rep.region] = (rep.bottleneck.label, rep.absorptions(),
                                    {m: r.fit.t0 for m, r in
                                     rep.results.items()})

    banner("5. launches on the main path")
    for name, (n_cuda, n_plain) in counts.items():
        print(f"{name}: kernel {n_cuda} launches, plain version {n_plain}")
        if n_cuda <= 0:
            raise RuntimeError(f"{name}: the main path never launched it")
        if n_plain:
            raise RuntimeError(f"{name}: the main path took the plain version")

    banner("4e. every store replays with 0 measured")
    for name in path_kernel:
        run(name, expect_no_measure=True)
    print("wall time per characterization (s): "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print("verdicts (label, Abs^raw per mode, t0 s per mode): "
          + json.dumps(verdicts))
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


def _attention_work(q, k, bq=64, bk=64):
    """Bytes and operations of one attention call: q, k, v read and out
    written once; two products of 2*bq*bk*hd per live block."""
    from repro_torch.kernels.flash_attention.kernel import live_blocks

    B, H, S, hd = q.shape
    live = int(live_blocks(S // bq, S // bk, bq, bk, True, 0).sum())
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes + 4 * 1024, 2 * 2 * bq * bk * hd * B * H * live


def phase_timing(main: dict, max_err: dict, launches: dict) -> list:
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attention_rt)
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

    # flash_attention, Qwen3-30B-A3B widths, seq 4096, causal
    q, k, v = main["q"], main["k"], main["v"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = _max_err(sdpa(q, k, v, is_causal=True, enable_gqa=True),
                       flash_attention_plain(q, k, v, noise)[0])
    fa_bytes, fa_ops = _attention_work(q, k)

    def tf32_sdpa():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    qh, kh, vh = (t.bfloat16() for t in (q, k, v))
    tf32_ms = time_ms(tf32_sdpa)
    bf16_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                   enable_gqa=True))
    rows.append(("flash_attention",
                 lambda: flash_attention_rt(0, q, k, v, noise, mode="fp"),
                 lambda: flash_attention_plain(q, k, v, noise, mode="fp",
                                               k_noise=0),
                 lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                 fa_bytes, fa_ops, TF32_FLOPS,
                 "scaled_dot_product_attention f32, is_causal, enable_gqa "
                 f"(max|d| vs plain {lib_err:.3g}); beside it the same call "
                 f"with TF32 allowed {tf32_ms!r} ms (the like-for-like "
                 f"yardstick: TF32 products, as the kernel's) and in bf16 "
                 f"{bf16_ms!r} ms"))

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
              f"bound_ms={bound_ms!r} ({bound_by}; {nbytes} bytes, {nops} "
              f"operations) library_ms={library_ms!r}"
              + (f" [{lib_what}]" if lib_what else "")
              + f" launches on the main path={launches[name]}", flush=True)
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
