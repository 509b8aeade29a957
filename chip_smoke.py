#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, ``nvcc`` and this checkout; imports nothing of
JAX or of the reference package. Phases, each of which fails the run:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 is switched off for the plain versions;
2. build: the runtime-k library and the static-k builds the check needs,
   one ``nvcc`` per library, all started together; the registers of every
   kernel (``nvcc -Xptxas -v``, no spills allowed), ``loop_regions.cu``
   included; the SASS FADD count of the static fp probe, matmul and
   attention at k=8 and k=24 (the fp adds must survive); the loop regions'
   SASS census between static k=8 and k=24: FADD for fp_add, FFMA for
   fp_fma, LDG for l1_ld, mem_ld and chase, at least 16 more in each of the
   six region kernels, and l1_ld's extra loads neither .STRONG nor volatile
   (they must stay L1 hits); the same census in each of the four DECAN loop
   kernels (``decan_loops.cu``: Table 3's token, stream and scatter_dep
   loops, Livermore), and each DECAN removal variant keeping only its class
   (the FP variant without the loop's LDG, the LS variant without the
   chains' FMUL or FADD); each graph-level noise mode's kernel
   (``graph_noise.cu``) growing by >= 16 of its pattern instruction (FADD,
   HMMA, LDS, LDG, LDG);
3. check: every kernel, mode and k in {0, 1, 24, K_MAX+7} against its plain
   PyTorch version on the card at moderate sizes (attention: B=2, H=8,
   KH=2, S=512, hd 64, 128 and 256, causal / non-causal / window 128, f32
   and bf16, and seq 24), and every mode at k in {0, 1} at the main path's
   shapes; the K_MAX clamp; runtime k bitwise equal to static k at k=24
   (attention: hd 128 f32, hd 256 f32 and bf16). The outputs of attention
   and the matmul are held row by row (``row_excess``); the same check must
   refuse each kernel fed bf16-rounded operands (a control that the
   tolerance is tight enough). The one-launch reduction of the probe and
   spmv: nacc bitwise equal to the plain versions (mxu to TF32) at 1, 31,
   33, 64 and 1056 probe CTAs and at 500 and 33 spmv CTAs (partial last
   chunks; spmv at L = 16, 112 and 128, the ring's three and two stages
   and the register path), after 200 calls back to back without a
   synchronize and on two streams at once; runtime k equal to static k
   (probe at 1056 steps, spmv at L=128); every workspace counter 0
   afterwards; every loop region (STREAM at chunk 512 and at an odd chunk,
   lat_mem_rd, HACCmk, SPMXV at L=16, 12 and 5, matmul O0 and O3) x
   every loop mode at k in {0, 1, 5, 24} against its plain version: outputs
   and aux bitwise equal (the plain versions add in the kernels' order),
   outputs bitwise equal across k (the noise leaves the region's result
   alone), runtime k bitwise equal to static k at k=24; the same at k in
   {0, 5} on the main path's own inputs (STREAM n=2^25 and SPMXV n=2^21,
   15.5 and 7.8 iterations a warp, grid-stride; lat_mem_rd on the 2^26
   table; HACCmk at width 135,168, 1,000 iterations; matmul n=192); every
   DECAN variant (3 x 4 Table 3 scenarios, 3 Livermore) at phase 4's shapes
   on seeded random inputs (N=2^25; token and scatter_dep at 200
   iterations, Livermore at 5,000, past its offset's wrap; the stream
   scenarios' whole triad buffer too) and the reference variant under
   every loop mode at k in {0, 5}, bitwise against its plain version
   (``plain=True``); every graph-level mode at the card's scale, static
   and run-time k in {0, 5}: aux and new state bitwise against the plain
   version, static equal to run-time k, the input state unchanged;
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
   e. the paper's studies on the loop kernels, each through
      ``python -m repro_torch.bench`` with a store directory: Fig. 7 (SPMXV
      n=2^21 and 2^17, q in {0, 0.25, 0.5, 1}, fp_add and l1_ld), Fig. 5
      (STREAM n=2^25, lat_mem_rd on a 2^26 table, HACCmk 60,000 iterations
      at width 135,168; fp_add, l1_ld, mem_ld) and Fig. 4 (matmul O0 and
      O3, n=192; with ``--pallas`` the tiled matmul kernel at n=128 and the
      compile-once vs trace-per-k sweep cost), Table 3 (the four scenarios,
      N=2^25, DECAN variants and fp_add / l1_ld sweeps), Fig. 6 (Livermore,
      width 135,168, 60,000 iterations), Table 1 (fig5's sweeps replayed,
      the analytic rows, every graph mode's cost a pattern on the card) and
      Table 4 (analytic); then ``python -m repro_torch.fleet calibrate
      run``;
   every payload check must pass, and every store must replay with 0
   measured (the studies and the calibration too);
5. each kernel's launch counter above 0 and its plain version's at 0 on the
   main path (fleet workers and the study processes report their counts in
   stats files);
6. timings with CUDA events (median of 25) at the main path's shapes, k=0
   (spmv at q=0 and q=1): kernel, plain version, bound, and one PyTorch
   library call where one computes the same function (spmv: CSR ``@ x`` on
   the same matrix; attention: SDPA in f32 as ``library_ms``, and beside it
   SDPA with TF32 allowed and SDPA in bf16); the kernel's and the library
   call's device time from a ``torch.profiler`` trace (each kernel averaged
   over its own records), the kernels each call launches (1 for the probe,
   spmv and the loop regions, or the run fails), each
   kernel's share of its bound and its ratio to the library call on both
   clocks; the launch floor (an empty kernel through ``_build.launch``);
   the probe's µs a pattern for fp, vmem and mxu (``launch/slot_cost.py``);
   each loop kernel at its phase-4 shape through the region's runtime-k
   call at k=0 (STREAM: torch.add with alpha 3 as the library call; SPMXV
   large at q=0: CSR ``@ x``), lat_mem_rd's ns a dependent hop beside it,
   and the noise slot's own cost: each mode's run-time kernel at k=0 and
   k=8 and its static build at k=8, against the clean kernel; the DECAN
   loops at their phase-4 shapes (Table 3's data-bound scenario with
   torch.add alpha 3 as the library call, Livermore); each graph-level
   mode's kernel at k=64 and its µs a pattern, the slope of event and
   device time over k in {0, 128, 256, 512}, beside
   ``pattern_cost(H100_SXM)``'s: hbm_stream and hbm_latency on lines the
   call before did not leave in the L2 (``studies.fresh_calls``), and
   beside that on the same lines every call.

7. serving, driven as phase 4's paths are (counts at 0 just before each,
   read just after; the graph-noise kernels' launches here join their
   rows'): gemma-2b at full width and depth in bf16 (random weights drawn
   on the card) through ``launch/serve.py``'s path at its defaults (8
   requests on 4 slots, prompts of 2-11 tokens, max_new 16, max_seq 256,
   page 16), paged, dense and paged again: greedy tokens equal, tok/s of
   the warm paged run; the engine's prefill and decode tick (4 slots of
   128 tokens, two ticks in) as step regions: the clean step a CUDA
   graph, the noisy output bitwise equal to the clean one and payload =
   k for fp_add32, mxu_fma128, vmem_ld and hbm_stream at k in {1, 64},
   static and run-time; a profiler trace of a noisy tick (mxu_fma128, k =
   512) with the noise kernel under ``NOISE_SCOPE`` on a stream of its
   own, overlapping the tick's kernels; t(0) of both regions from the
   graph and eagerly; both characterized over the four modes into a store
   and replayed with 0 measured; then ``python -m
   repro_torch.launch.probe --serve --arch gemma-2b`` and ``--arch
   gemma-2b --kind decode`` at the smoke config, each again with
   ``--expect-no-measure``.

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
from functools import partial

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


# the loop regions (csrc/loop_regions.cu) and their noise modes
LOOP_MODES = ("fp_add", "fp_fma", "l1_ld", "mem_ld", "chase")
LOOP_CHECK_KS = (0, 1, 5, 24)
LOOP_MAIN_CHECK_KS = (0, 5)     # at the main path's shapes
LOOP_SASS = {"fp_add": "FADD", "fp_fma": "FFMA", "l1_ld": "LDG",
             "mem_ld": "LDG", "chase": "LDG"}
# the six region kernels of csrc/loop_regions.cu
LOOP_KERNEL_FNS = ("stream_kernel", "lat_kernel", "haccmk_kernel",
                   "spmxv_kernel", "mm_o0_kernel", "mm_o3_kernel")
# the main path's loop shapes (src/repro_torch/bench/studies.py)
MAIN_STREAM_N = 2 ** 25
MAIN_LAT = {"table_len": 2 ** 26, "n_iter": 1024, "hops_per_iter": 8}
MAIN_HACC = {"n_iter": 60_000, "width": 132 * 1024}
MAIN_MM_N = 192
# the DECAN loops (csrc/decan_loops.cu) at phase 4's shapes
# (src/repro_torch/bench/studies.py T3_SIZES, FIG6_SIZES); the loops whose
# every lane group runs every iteration are checked at CHECK_DECAN_ITERS
# (Livermore at CHECK_LIV_ITERS: its stepped offset (i*64) % (n-64) wraps
# after 4,095 iterations at n = 2^18), on seeded random inputs
MAIN_T3 = {"n": 2 ** 25, "width": 132 * 512}
MAIN_LIV = {"n": 2 ** 18, "n_iter": 60_000, "width": 132 * 1024}
CHECK_DECAN_ITERS = 200
CHECK_LIV_ITERS = 5000
CHECK_DECAN_SEED = 0
DECAN_CHECK_KS = (0, 5)
# the graph-level noise modes (csrc/graph_noise.cu): their kernels, the SASS
# opcode of one pattern, the quantities of phase 3 and the timed k
GRAPH_MODES = ("fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream",
               "hbm_latency")
GRAPH_SASS = {"fp_add32": ("gfp_kernel", "FADD"),
              "mxu_fma128": ("gmxu_kernel", "HMMA"),
              "vmem_ld": ("gvmem_kernel", "LDS"),
              "hbm_stream": ("gstream_kernel", "LDG"),
              "hbm_latency": ("gchase_kernel", "LDG")}
GRAPH_CHECK_KS = (0, 5)
GRAPH_ROW_K = 64
GRAPH_SLOPE_KS = (0, 128, 256, 512)
BF16_FLOPS = 989e12


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


# a spin kernel of ~50 ms (at 1.98 GHz) opens every profiler window: the
# trace drops the kernels that start within the window's first X ms, X
# growing with the process's age as its host and device clocks drift apart
# (late in one run every window lost its first call's kernels, 24 records
# for 25 one-kernel calls; with a 5 ms spin the windows timed after ~9
# minutes still did), so the calls timed start after it. Later in a run the
# windows lose records behind the 50 ms spin too, and more behind a longer
# one (retries at 4x and 16x the spin lost every record of a row), so a
# window traced again spins SPIN_SHRINK times shorter than the one before,
# and the most complete window is kept
SPIN_CYCLES = 100_000_000
SPIN_SHRINK = 8


def device_ms(fn, reps: int = TIMING_REPS, windows: int = 3):
    """Device time of one call of ``fn`` from a torch.profiler trace (CUPTI):
    (ms per call summed over its kernels, {kernel: ms per call}, kernels
    launched per call, complete); (None, {}, 0, False) when the trace holds
    no device events. A kernel's ms per call is the mean of its own records
    times its launches a call (its records / reps, rounded), so a record the
    trace dropped leaves it unbiased. The window opens with a spin kernel
    (``SPIN_CYCLES``), left out; a window in which a kernel's records are
    not a whole number a call is traced again behind a spin
    ``SPIN_SHRINK`` times shorter, at most ``windows`` times; the first
    whole window, else the one with the most records, is kept, and
    ``complete`` says whether it was whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None     # (complete, records kept, {kernel: [ms, records]})
    for attempt in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES // SPIN_SHRINK ** attempt)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        records: dict = {}     # kernel -> [ms summed, records]
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" not in e.name):
                name = e.name.split("(")[0].replace("void ", "")
                rec = records.setdefault(name, [0.0, 0])
                rec[0] += e.time_range.elapsed_us() / 1e3
                rec[1] += 1
        per_call = {name: max(1, round(n / reps))
                    for name, (_, n) in records.items()}
        complete = bool(records) and all(
            n == per_call[name] * reps for name, (_, n) in records.items())
        window = (complete, sum(n for _, n in records.values()), records)
        if best is None or window[:2] > best[:2]:
            best = window
        if complete:
            break
    complete, _, records = best
    if not records:
        return None, {}, 0, False
    per_call = {name: max(1, round(n / reps))
                for name, (_, n) in records.items()}
    per_kernel = {name: ms / n * per_call[name]
                  for name, (ms, n) in records.items()}
    return (sum(per_kernel.values()), per_kernel, sum(per_call.values()),
            complete)


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
        from repro_torch.kernels.loop_regions.kernel import REGION_KERNELS

        replaces = {"stream_triad": 31, "lat_mem_rd": 58, "haccmk": 92,
                    "spmxv": 125, "matmul_O0": 160, "matmul_O3": 160}
        for name, (cuda, plain) in REGION_KERNELS.items():
            self.rows[name] = {
                "cuda": cuda, "plain": plain,
                "source": "src/repro_torch/csrc/loop_regions.cu",
                "replaces": f"src/repro/bench/kernels.py:{replaces[name]}"}
        from repro_torch.kernels.decan_loops.kernel import DECAN_KERNELS
        from repro_torch.kernels.graph_noise.kernel import GRAPH_KERNELS

        replaces = {"decan_table3": "benchmarks/table3_decan.py:46",
                    "decan_livermore": "benchmarks/fig6_overlap.py:27",
                    "graph_fp_add32": "src/repro/core/noise.py:101",
                    "graph_mxu_fma128": "src/repro/core/noise.py:132",
                    "graph_vmem_ld": "src/repro/core/noise.py:161",
                    "graph_hbm_stream": "src/repro/core/noise.py:200",
                    "graph_hbm_latency": "src/repro/core/noise.py:241"}
        for source, kernels in (("decan_loops", DECAN_KERNELS),
                                ("graph_noise", GRAPH_KERNELS)):
            for name, (cuda, plain) in kernels.items():
                self.rows[name] = {
                    "cuda": cuda, "plain": plain,
                    "source": f"src/repro_torch/csrc/{source}.cu",
                    "replaces": replaces[name]}
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
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS

    want += [(src, LOOP_IDS[m], k, ()) for src in ("loop_regions",
                                                   "decan_loops")
             for m in LOOP_MODES for k in (8, STATIC_CHECK_K)]
    from repro_torch.kernels.graph_noise.kernel import MODE_IDS as GRAPH_IDS

    want += [("graph_noise", GRAPH_IDS[m], k, ()) for m in GRAPH_MODES
             for k in sorted({*GRAPH_CHECK_KS, 8, STATIC_CHECK_K})]
    # phase 7: the serve regions' payload checks, and the largest k of a
    # robust sweep (controller._ks_for)
    want += [("graph_noise", GRAPH_IDS[m], k, ()) for m in GRAPH_MODES[:4]
             for k in (*SERVE_KS, 320)]
    return want + [("noise_probes", MODE_IDS["fp"], 8, ()),
                   ("noisy_matmul", MODE_IDS["fp"], 8, ()),
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


def _no_spills(usage: dict) -> None:
    """Print the registers of every kernel entry (``nvcc -Xptxas -v``); a
    spill in one of them fails the run."""
    spilled = []
    for kernel, entries in usage.items():
        names = []
        for entry, (regs, st, ld) in sorted(entries.items()):
            name = entry.replace("(int)", "").replace("void ", "")
            name = name[:name.rfind(">") + 1] or name.split("(")[0]
            names.append(f"{name} {regs}" + (f" SPILLS {st}/{ld}"
                                              if st or ld else ""))
            if st or ld:
                spilled.append(name)
        print(f"ptxas registers, {kernel}.cu: " + "; ".join(names))
    if spilled:
        raise RuntimeError(f"register spills in {spilled}")


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
    _no_spills({k: _build.ptxas_usage(k) for k in _build.KERNEL_SOURCES})
    # 4 elements per thread and pattern: k=24 holds 16 patterns more
    _fadd_grows("noise_probes", (), 4)
    _fadd_grows("noisy_matmul", (), 4)
    _fadd_grows("flash_attention", attention_variant(128, "float32"), 4)
    _loop_census()
    _decan_census()
    _graph_census()


def _loop_census() -> None:
    """Static loop_regions builds at k=8 and k=24: each mode's pattern
    instruction grows by >= 16 in each of the six region kernels; l1_ld's
    extra loads are plain cached loads (not .STRONG, which bypasses L1)."""
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS
    from repro_torch.kernels import _build

    want = STATIC_CHECK_K - 8
    failed = []
    for mode in LOOP_MODES:
        op = LOOP_SASS[mode]
        census = {}
        for k in (8, STATIC_CHECK_K):
            path = _build.static_lib_path("loop_regions", LOOP_IDS[mode], k)
            census[k] = _build.sass_census(path, op)
            if census[k] is None:
                raise RuntimeError("cuobjdump not found: no SASS census")
        growth, strong = {}, {}
        for kern in LOOP_KERNEL_FNS:
            # mangled: _Z13stream_kernelILi1ELi8EE...
            ops = {k: [c for fn, c in census[k].items()
                       if f"{len(kern)}{kern}I" in fn] for k in census}
            if any(len(v) != 1 for v in ops.values()):
                raise RuntimeError(f"loop_regions {mode}: {kern} is not one "
                                   f"function of the static builds")
            ops = {k: v[0] for k, v in ops.items()}
            growth[kern] = (sum(ops[STATIC_CHECK_K].values())
                            - sum(ops[8].values()))
            strong[kern] = [sum(c for o, c in v.items()
                                if "STRONG" in o or "VOL" in o)
                            for v in ops.values()]
            if growth[kern] < want:
                failed.append(f"{mode} {kern}: {growth[kern]} more {op}")
            if mode == "l1_ld" and strong[kern][0] != strong[kern][1]:
                failed.append(f"l1_ld {kern}: strong/volatile loads (they "
                              f"bypass L1) {strong[kern]}")
        print(f"SASS {op} in the static {mode} loop_regions, k=8 -> "
              f"k={STATIC_CHECK_K}, growth a kernel: {growth}")
    if failed:
        raise RuntimeError(f"loop_regions SASS census (want >= {want} more "
                           f"pattern instructions a kernel): {failed}")


def _growth(source: str, mode_id: int, op: str, fn_prefixes) -> dict:
    """{function: pattern instructions of ``op`` in the static k=24 build
    minus the k=8 build} for every function of ``source`` whose mangled
    name starts with one of ``fn_prefixes``."""
    from repro_torch.kernels import _build

    census = {}
    for k in (8, STATIC_CHECK_K):
        c = _build.sass_census(_build.static_lib_path(source, mode_id, k), op)
        if c is None:
            raise RuntimeError("cuobjdump not found: no SASS census")
        census[k] = c
    out = {}
    for fn in census[STATIC_CHECK_K]:
        if fn.startswith(tuple(fn_prefixes)):
            grown = sum(census[STATIC_CHECK_K][fn].values())
            out[fn] = grown - sum(census[8].get(fn, {}).values())
    return out


# the DECAN kernels by mangled name prefix: t3_kernel<KIND, ...>, liv_kernel
DECAN_FNS = {"t3 token": "_Z9t3_kernelILi0E", "t3 stream": "_Z9t3_kernelILi1E",
             "t3 scatter_dep": "_Z9t3_kernelILi2E", "livermore": "_Z10liv_kernelI"}


def _decan_census() -> None:
    """decan_loops.cu: (1) each loop mode's static k=24 build holds >= 16
    more pattern instructions than k=8 in each of the four loop kernels;
    (2) in the run-time library each removal variant keeps only its class:
    the FP variant lost the loop's loads (LDG), the LS variant the chains'
    FMUL (Livermore: FADD), against the reference variant."""
    from repro_torch.core.loopnoise import MODE_IDS as LOOP_IDS
    from repro_torch.kernels import _build

    want = STATIC_CHECK_K - 8
    failed = []
    for mode in LOOP_MODES:
        growth = _growth("decan_loops", LOOP_IDS[mode], LOOP_SASS[mode],
                         DECAN_FNS.values())
        per = {label: [g for fn, g in growth.items() if fn.startswith(pre)]
               for label, pre in DECAN_FNS.items()}
        for label, gs in per.items():
            if len(gs) != 1 or gs[0] < want:
                failed.append(f"{mode} {label}: growth {gs}")
        print(f"SASS {LOOP_SASS[mode]} in the static {mode} decan_loops, "
              f"k=8 -> k={STATIC_CHECK_K}, growth a kernel: {per}")
    lib = _build.runtime_lib_path()
    ldg = _build.sass_census(lib, "LDG")
    ops = {"FMUL": _build.sass_census(lib, "FMUL"),
           "FADD": _build.sass_census(lib, "FADD")}

    def count(census, prefix):
        hits = [sum(c.values()) for fn, c in census.items()
                if fn.startswith(prefix)]
        if len(hits) != 1:
            raise RuntimeError(f"decan census: {prefix} is {len(hits)} "
                               "functions of the run-time library")
        return hits[0]

    # (prefix, chain op, least loads an iteration, least chain ops a step)
    kernels = {f"t3 {kind}": (f"_Z9t3_kernelILi{i}E", "FMUL", loads, 8)
               for i, (kind, loads) in enumerate((("token", 2), ("stream", 2),
                                                  ("scatter_dep", 4)))}
    kernels["livermore"] = ("_Z10liv_kernelI", "FADD", 1, 12)
    variants = {"ref": "Lb1ELb1ELi0ELin1E", "fp": "Lb1ELb0ELi0ELin1E",
                "ls": "Lb0ELb1ELi0ELin1E"}
    for label, (prefix, op, loads, chain) in kernels.items():
        n = {v: (count(ldg, prefix + tail), count(ops[op], prefix + tail))
             for v, tail in variants.items()}
        ok = (n["ref"][0] - n["fp"][0] >= loads and n["ls"][0] >= loads
              and n["ref"][1] - n["ls"][1] >= chain and n["fp"][1] >= chain)
        print(f"decan variants, {label}: (LDG, {op}) ref {n['ref']}, fp "
              f"{n['fp']}, ls {n['ls']}: each keeps only its class: {ok}")
        if not ok:
            failed.append(f"variants of {label}: {n}")
    if failed:
        raise RuntimeError(f"decan_loops SASS census (want >= {want} more "
                           f"pattern instructions a kernel): {failed}")


def _graph_census() -> None:
    """graph_noise.cu: each mode's static k=24 build holds >= 16 more
    pattern instructions than k=8 in its kernel (fp FADD, mxu HMMA, vmem
    LDS, hbm_stream and hbm_latency LDG)."""
    from repro_torch.kernels.graph_noise.kernel import MODE_IDS as GRAPH_IDS

    want = STATIC_CHECK_K - 8
    failed = []
    growth = {}
    for mode in GRAPH_MODES:
        fn, op = GRAPH_SASS[mode]
        g = _growth("graph_noise", GRAPH_IDS[mode], op,
                    (f"_Z{len(fn)}{fn}I",))
        growth[mode] = (op, list(g.values()))
        if len(g) != 1 or min(g.values()) < want:
            failed.append(f"{mode}: {op} growth {g}")
    print(f"SASS in the static graph_noise builds, k=8 -> k={STATIC_CHECK_K}: "
          f"{growth}")
    if failed:
        raise RuntimeError(f"graph_noise SASS census (want >= {want} more "
                           f"pattern instructions): {failed}")


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _close(got, want, what, failures, tol="exact"):
    """Hold ``got`` against ``want``: "exact" (rtol 1e-5, atol 1e-6),
    "tf32" (max|d| <= 1e-2 max|want|, the mxu nacc) or a float: a per-row
    limit of that share of each row's largest value (``row_excess`` <= 1;
    attention's and the matmul's output); returns max|d|."""
    import torch

    from repro_torch.kernels.flash_attention.ref import row_excess

    err = _max_err(got, want)
    if not torch.isfinite(got.float()).all():
        failures.append(f"{what}: non-finite values")
    elif isinstance(tol, float):
        excess = row_excess(got, want, tol)
        if excess > 1:
            failures.append(f"{what}: max|d|={err:.3g}, {excess:.3g} times "
                            f"its per-row limit (TF32 rows, {tol})")
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
    from repro_torch.kernels.noisy_matmul.ref import TF32_ROW_TOL
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
                         TF32_ROW_TOL),
    }


def _attention_case(q, k, v, noise, **kw):
    """(modes, runtime-k call, static-k call, plain call, output tolerance)
    of the attention kernel on one input set."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_plain, flash_attention_rt)
    from repro_torch.kernels.flash_attention.ref import TF32_ROW_TOL

    return (("fp", "mxu", "vmem"),
            lambda m, kn: flash_attention_rt(kn, q, k, v, noise, mode=m, **kw),
            lambda m, kn: flash_attention(q, k, v, noise, mode=m, k_noise=kn,
                                          **kw),
            lambda m, kn: flash_attention_plain(q, k, v, noise, mode=m,
                                                k_noise=kn, **kw),
            TF32_ROW_TOL)


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


def _bf16_control(name, rt, plain, operands, row_tol, label,
                  failures) -> None:
    """The per-row output check of kernel ``name`` must refuse what a
    kernel with bf16 operands would give: the TF32 kernel (``rt``) fed
    ``operands`` rounded to bf16, held against the plain version on the
    unrounded inputs."""
    from repro_torch.kernels.flash_attention.ref import row_excess

    want = plain(*operands)[0]
    tf32 = row_excess(rt(*operands)[0], want, row_tol)
    ctl = row_excess(rt(*(t.bfloat16().float() for t in operands))[0], want,
                     row_tol)
    print(f"{name} ({label}): per-row excess (<= 1 passes): TF32 kernel "
          f"{tf32:.3g}, bf16-operand control {ctl:.3g}", flush=True)
    if ctl <= 1:
        failures.append(f"{name} ({label}): the per-row check passes a "
                        f"bf16-operand control (excess {ctl:.3g})")


def _attention_control(q, k, v, noise, label, failures) -> None:
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attention_rt)
    from repro_torch.kernels.flash_attention.ref import TF32_ROW_TOL

    _bf16_control("flash_attention",
                  lambda *qkv: flash_attention_rt(0, *qkv, noise),
                  lambda *qkv: flash_attention_plain(*qkv, noise),
                  (q, k, v), TF32_ROW_TOL, label, failures)


def _matmul_control(a, b, noise, label, failures) -> None:
    from repro_torch.kernels.noisy_matmul.kernel import matmul_plain, matmul_rt
    from repro_torch.kernels.noisy_matmul.ref import TF32_ROW_TOL

    _bf16_control("noisy_matmul", lambda *ab: matmul_rt(0, *ab, noise),
                  lambda *ab: matmul_plain(*ab, noise), (a, b), TF32_ROW_TOL,
                  label, failures)


FUSED_PROBE_CTAS = (1, 31, 33, 64, MAIN_PROBE_STEPS)
# (rows, L): 500 and 33 CTAs (one 128-row block each), a last chunk of 20
# and of 1, in the ring's three stages (L=16) and two (L=112), and in the
# register path (L=128)
FUSED_SPMV = ((128 * 500, 16), (128 * 33, 16), (128 * 40, 112), (128 * 40, 128))
FUSED_K = 5
BACK_TO_BACK = 200


def _check_fused(main: dict, failures: list) -> None:
    """The one-launch reduction of the probe and spmv (``reduce_fused`` in
    ``csrc/noise_slots.cuh``): nacc bitwise equal to the plain versions
    (mxu to TF32) at CTA counts that fill, split and leave partial chunks;
    200 calls back to back without a synchronize; two streams at once, each
    with its own inputs; runtime k bitwise equal to static k at the main
    probe size; every workspace counter 0 afterwards."""
    import numpy as np
    import torch

    from repro_torch.convert import to_torch
    from repro_torch.kernels import noise_slots as ns
    from repro_torch.kernels.noise_probes.kernel import (probe, probe_plain,
                                                         probe_rt)
    from repro_torch.kernels.spmv_ell.kernel import (spmv_ell, spmv_ell_plain,
                                                     spmv_ell_rt)
    from repro_torch.kernels.spmv_ell.ref import make_band_ell

    noise = main["noise"]
    for n_steps in FUSED_PROBE_CTAS:
        for mode in ("fp", "vmem", "mxu"):
            got = probe_rt(FUSED_K, noise, mode=mode, n_steps=n_steps)
            want = probe_plain(noise, mode=mode, k_noise=FUSED_K,
                               n_steps=n_steps)
            torch.cuda.synchronize()
            what = f"fused probe {n_steps} CTAs {mode}"
            if mode == "mxu":
                _close(got, want, what, failures, tol="tf32")
            else:
                _equal(got, want, what, failures)
    for mode in ("fp", "vmem", "mxu"):
        _equal(probe_rt(STATIC_CHECK_K, noise, mode=mode,
                        n_steps=MAIN_PROBE_STEPS),
               probe(noise, mode=mode, k_noise=STATIC_CHECK_K,
                     n_steps=MAIN_PROBE_STEPS),
               f"fused probe {MAIN_PROBE_STEPS} CTAs {mode} runtime k vs "
               f"static k={STATIC_CHECK_K}", failures)
    dev = noise.device
    spmv_in = {}
    for n, L in FUSED_SPMV:
        vals, cols = make_band_ell(n, L, 0.5, seed=n + L)
        x = np.random.RandomState(n + 1).standard_normal(n).astype(np.float32)
        spmv_in[n, L] = to_torch((vals, cols, x), dev)
        for mode in ("fp", "vmem"):
            got = spmv_ell_rt(FUSED_K, *spmv_in[n, L], mode=mode)
            want = spmv_ell_plain(*spmv_in[n, L], mode=mode, k_noise=FUSED_K)
            torch.cuda.synchronize()
            what = f"fused spmv n={n} L={L} ({n // 128} CTAs) {mode}"
            _equal(got[1], want[1], what + " nacc", failures)
            _close(got[0], want[0], what + " y", failures)
    for mode in ("fp", "vmem"):   # the register path's static build
        _equal(spmv_ell_rt(STATIC_CHECK_K, *spmv_in[FUSED_SPMV[-1]], mode=mode),
               spmv_ell(*spmv_in[FUSED_SPMV[-1]], mode=mode,
                        k_noise=STATIC_CHECK_K),
               f"fused spmv L=128 {mode} runtime k vs static k="
               f"{STATIC_CHECK_K}", failures)

    # back to back: no synchronize between the calls
    n_spmv = FUSED_SPMV[0]
    calls = {
        f"probe {MAIN_PROBE_STEPS} CTAs vmem": (
            lambda: probe_rt(FUSED_K, noise, mode="vmem",
                             n_steps=MAIN_PROBE_STEPS),
            probe_plain(noise, mode="vmem", k_noise=FUSED_K,
                        n_steps=MAIN_PROBE_STEPS)),
        f"spmv (n, L)={n_spmv} vmem": (
            lambda: spmv_ell_rt(FUSED_K, *spmv_in[n_spmv], mode="vmem")[1],
            spmv_ell_plain(*spmv_in[n_spmv], mode="vmem",
                           k_noise=FUSED_K)[1]),
    }
    for what, (call, want) in calls.items():
        torch.cuda.synchronize()
        outs = [call() for _ in range(BACK_TO_BACK)]
        torch.cuda.synchronize()
        bad = sum(not torch.equal(o, want) for o in outs)
        if bad:
            failures.append(f"fused {what}: {bad} of {BACK_TO_BACK} "
                            f"back-to-back calls differ from the plain "
                            f"version")
    # two streams at once, each with its own inputs
    noise_b = noise.flip(0).contiguous()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    wants = (probe_plain(noise, mode="vmem", k_noise=FUSED_K,
                         n_steps=MAIN_PROBE_STEPS),
             probe_plain(noise_b, mode="vmem", k_noise=FUSED_K,
                         n_steps=MAIN_PROBE_STEPS))
    spmv_wants = tuple(spmv_ell_plain(*spmv_in[FUSED_SPMV[i]], mode="fp",
                                      k_noise=FUSED_K) for i in range(2))
    torch.cuda.synchronize()
    outs = ([], [])
    for _ in range(BACK_TO_BACK // 4):
        for i, (st, nz) in enumerate(zip(streams, (noise, noise_b))):
            with torch.cuda.stream(st):
                outs[i].append((probe_rt(FUSED_K, nz, mode="vmem",
                                         n_steps=MAIN_PROBE_STEPS),
                                spmv_ell_rt(FUSED_K,
                                            *spmv_in[FUSED_SPMV[i]],
                                            mode="fp")))
    torch.cuda.synchronize()
    for i in range(2):
        bad = sum(not (torch.equal(p, wants[i])
                       and torch.equal(sp[1], spmv_wants[i][1]))
                  for p, sp in outs[i])
        if bad:
            failures.append(f"fused, stream {i}: {bad} of {len(outs[i])} "
                            f"probe + spmv calls differ from the plain "
                            f"versions")
    left = {f"{dev_}/{st:#x}": int(ws.counters.abs().sum())
            for (dev_, st), ws in ns.WORKSPACES.items()}
    if any(left.values()):
        failures.append(f"workspace counters not 0 after the phase: {left}")
    print(f"fused reduction: probe at {list(FUSED_PROBE_CTAS)} CTAs and spmv "
          f"at (CTAs, L) {[(n // 128, L) for n, L in FUSED_SPMV]} against "
          f"the plain versions (fp, vmem bitwise; mxu TF32), runtime == "
          f"static k at {MAIN_PROBE_STEPS} probe steps and spmv L=128, "
          f"{BACK_TO_BACK} back-to-back calls, two streams; {len(left)} "
          f"workspaces, counters {left}", flush=True)


def _loop_case(kernel, run, plain, *args, **kw):
    """(kernel, call(mode, k, static), plain(mode, k)) of one loop region
    on ``args``, with the modes' carries on the args' device."""
    from repro_torch.core.loopnoise import loop_carry

    dev = args[0].device

    def carry(mode):
        return None if mode == "none" else loop_carry(mode, dev)

    return (kernel,
            lambda m, k, static: run(*args, mode=m, k=k, carry=carry(m),
                                     static=static, **kw),
            lambda m, k: plain(*args, mode=m, k=k, carry=carry(m), **kw))


def _loop_cases(dev) -> dict:
    """label -> ``_loop_case`` of every loop region at moderate sizes: one
    iteration a warp at most, odd chunks and row widths."""
    import numpy as np
    import torch

    from repro_torch.convert import to_torch
    from repro_torch.core.loopnoise import chase_table
    from repro_torch.kernels.loop_regions import kernel as lk
    from repro_torch.kernels.loop_regions import ref as lref
    from repro_torch.kernels.spmv_ell.ref import make_band_ell

    rs = np.random.RandomState(7)

    def f32(*shape):
        return to_torch((rs.standard_normal(shape).astype(np.float32),),
                        dev)[0]

    table = chase_table(torch.from_numpy(
        rs.permutation(1 << 16).astype(np.int64))).to(torch.int32).to(dev)
    idx0 = torch.tensor([5], dtype=torch.int32, device=dev)
    spmv = {}
    for n, L in ((1 << 14, 16), (2000, 12), (1000, 5)):
        vals, cols = make_band_ell(n, L, 0.5, seed=n)
        x = rs.standard_normal(n).astype(np.float32)
        spmv[n] = (*to_torch((vals, cols, x), dev),
                   torch.zeros(n, dtype=torch.float32, device=dev))
    xs = to_torch((np.linspace(0.1, 0.9, 1000).astype(np.float32),), dev)[0]
    a32, b32 = f32(32, 32), f32(32, 32)
    return {
        "stream n=2^16 chunk 512": _loop_case(
            "stream_triad", lk.stream_triad, lref.stream_triad_plain,
            f32(1 << 16), f32(1 << 16), f32(1 << 16), chunk=512),
        "stream n=3000 chunk 100": _loop_case(
            "stream_triad", lk.stream_triad, lref.stream_triad_plain,
            f32(3000), f32(3000), f32(3000), chunk=100),
        "lat_mem_rd 2^16 table, 64 x 8 hops": _loop_case(
            "lat_mem_rd", lk.lat_mem_rd, lref.lat_mem_rd_plain, table, idx0,
            n_iter=64, hops=8),
        "haccmk width 1000, 200 iterations": _loop_case(
            "haccmk", lk.haccmk, lref.haccmk_plain, xs, n_iter=200),
        "spmxv n=2^14 L=16 q=0.5": _loop_case(
            "spmxv", lk.spmxv, lref.spmxv_plain, *spmv[1 << 14],
            rows_per_iter=64),
        "spmxv n=2000 L=12 q=0.5": _loop_case(
            "spmxv", lk.spmxv, lref.spmxv_plain, *spmv[2000],
            rows_per_iter=64),
        "spmxv n=1000 L=5 q=0.5": _loop_case(
            "spmxv", lk.spmxv, lref.spmxv_plain, *spmv[1000],
            rows_per_iter=64),
        "matmul_O0 n=32": _loop_case(
            "matmul_O0", lk.matmul_o0, lref.matmul_o0_plain, a32, b32,
            torch.zeros((1, 32), dtype=torch.float32, device=dev),
            n_iter=128),
        "matmul_O3 n=32": _loop_case(
            "matmul_O3", lk.matmul_o3, lref.matmul_o3_plain, a32, b32,
            n_iter=512),
    }


# HACCmk's iterations in the main-shape check (the main path runs 60,000;
# every thread runs every iteration, so the width sets the grouping)
CHECK_HACC_ITERS = 1000


def _loop_main_cases() -> dict:
    """label -> ``_loop_case`` of every loop region on the main path's own
    inputs (``repro_torch.bench.kernels``, phase 4's shapes): STREAM and
    SPMXV walk 15.5 and 7.8 iterations a warp, grid-stride, with a last
    round in which only some warps run; HACCmk at its full width."""
    from repro_torch.bench.kernels import (haccmk_region, lat_mem_rd_region,
                                           matmul_region, spmxv_region,
                                           stream_region)
    from repro_torch.kernels.loop_regions import kernel as lk
    from repro_torch.kernels.loop_regions import ref as lref

    def base(region):
        return region.args_for("", 0)

    n = MAIN_MM_N
    return {
        "stream n=2^25 chunk 512": _loop_case(
            "stream_triad", lk.stream_triad, lref.stream_triad_plain,
            *base(stream_region(n=MAIN_STREAM_N)), chunk=512),
        "lat_mem_rd 2^26 table, 1024 x 8 hops": _loop_case(
            "lat_mem_rd", lk.lat_mem_rd, lref.lat_mem_rd_plain,
            *base(lat_mem_rd_region(**MAIN_LAT)), n_iter=MAIN_LAT["n_iter"],
            hops=MAIN_LAT["hops_per_iter"]),
        f"haccmk width {MAIN_HACC['width']}, {CHECK_HACC_ITERS} iterations":
            _loop_case("haccmk", lk.haccmk, lref.haccmk_plain,
                       *base(haccmk_region(width=MAIN_HACC["width"])),
                       n_iter=CHECK_HACC_ITERS),
        "spmxv n=2^21 L=16 q=0.5": _loop_case(
            "spmxv", lk.spmxv, lref.spmxv_plain,
            *base(spmxv_region(n=MAIN_SPMXV_N, q=0.5)), rows_per_iter=64),
        f"matmul_O0 n={n}": _loop_case(
            "matmul_O0", lk.matmul_o0, lref.matmul_o0_plain,
            *base(matmul_region(n=n)), n_iter=32 * n // lref.UNROLL_O0),
        f"matmul_O3 n={n}": _loop_case(
            "matmul_O3", lk.matmul_o3, lref.matmul_o3_plain,
            *base(matmul_region(n=n, optimized=True)), n_iter=16 * n),
    }


def _check_loops(cases: dict, ks, failures: list, max_err: dict) -> None:
    """Every loop region x mode x k in ``ks`` against its plain version
    (outputs and aux bitwise), outputs unchanged across k, runtime k ==
    static k."""
    import torch

    for label, (kernel, run, plain) in cases.items():
        t0 = time.perf_counter()
        base = run("none", 0, False)[0]
        worst = _max_err(base, plain("none", 0)[0])
        _equal(base, plain("none", 0)[0], f"{label} none out", failures)
        for mode in LOOP_MODES:
            for k in ks:
                got, want = run(mode, k, False), plain(mode, k)
                torch.cuda.synchronize()
                what = f"{label} {mode} k={k}"
                worst = max(worst, _max_err(got[0], want[0]),
                            _max_err(got[1], want[1]))
                _equal(got, want, what + " (out, aux) vs plain", failures)
                _equal(got[0], base, what + " out vs k=0", failures)
            _equal(run(mode, STATIC_CHECK_K, False),
                   run(mode, STATIC_CHECK_K, True),
                   f"{label} {mode} runtime k vs static k={STATIC_CHECK_K}",
                   failures)
        max_err[kernel] = max(max_err.get(kernel, 0.0), worst)
        print(f"loop {label}: none + {', '.join(LOOP_MODES)} x k in "
              f"{list(ks)}: out and aux vs plain, out across k, "
              f"runtime == static k={STATIC_CHECK_K}; max|kernel - plain| = "
              f"{worst:.3g} ({time.perf_counter() - t0:.1f} s)", flush=True)


def _decan_targets(n_iter_replicated: int, n_iter_liv: int,
                   seed=None) -> dict:
    """label -> DecanTarget of every DECAN loop at phase 4's shapes; token
    and scatter_dep at ``n_iter_replicated`` iterations, Livermore at
    ``n_iter_liv`` (the stream scenarios at their own); the reference's
    inputs or, with ``seed``, seeded random ones."""
    from repro_torch.bench.kernels import livermore_target, table3_target
    from repro_torch.bench.studies import T3_SCENARIOS
    from repro_torch.kernels.decan_loops.ref import CHUNK

    out = {}
    for name, (kind, depth) in T3_SCENARIOS.items():
        stream = kind == "stream"
        out[f"t3 {name}"] = table3_target(
            f"t3_{name}", kind, depth,
            MAIN_T3["n"] // CHUNK if stream else n_iter_replicated,
            n=MAIN_T3["n"], width=None if stream else MAIN_T3["width"],
            seed=seed)
    out["livermore"] = livermore_target(n_iter_liv, n=MAIN_LIV["n"],
                                        width=MAIN_LIV["width"], seed=seed)
    return out


def _check_decan(failures: list, max_err: dict) -> None:
    """Every DECAN variant (3 x 4 scenarios + Livermore x 3) against its
    plain version at phase 4's shapes (token and scatter_dep at
    CHECK_DECAN_ITERS iterations, Livermore at CHECK_LIV_ITERS), on seeded
    random inputs, bitwise: the output and, for the stream scenarios, the
    whole triad buffer; the reference variant under every loop mode at k in
    DECAN_CHECK_KS (run-time k) against its plain version, out and aux
    bitwise, out unchanged by the noise; run-time k == static k at
    k=24."""
    import torch

    from repro_torch.bench.studies import T3_SCENARIOS
    from repro_torch.core.decan import VARIANTS
    from repro_torch.core.loopnoise import loop_carry, make_loop_modes
    from repro_torch.kernels.decan_loops import kernel as dk
    from repro_torch.kernels.decan_loops import ref as dref

    modes = make_loop_modes()
    targets = _decan_targets(CHECK_DECAN_ITERS, CHECK_LIV_ITERS,
                             seed=CHECK_DECAN_SEED)
    for label, target in targets.items():
        t0 = time.perf_counter()
        args = target.args_for()
        kernel = "decan_livermore" if label == "livermore" else "decan_table3"
        stream = label in ("t3 data-bound", "t3 full-overlap")
        worst = 0.0
        for vname, (fp, ls) in VARIANTS.items():
            got = target.build(fp, ls)(*args)
            want = target.build_plain(fp, ls)(*args)
            worst = max(worst, _max_err(got, want))
            _equal(got, want, f"decan {label} variant {vname} vs plain",
                   failures)
            if stream:     # the triad buffer, whole (from c: the reference's)
                kw = {"kind": "stream", "depth": T3_SCENARIOS[label[3:]][1],
                      "n_iter": target.n_iter, "fp": fp, "ls": ls}
                cout, cplain = args[2].clone(), args[2].clone()
                dk.table3(*args, cout=cout, **kw)
                dref.table3_plain(*args, cout=cplain, **kw)
                torch.cuda.synchronize()
                worst = max(worst, _max_err(cout, cplain))
                _equal(cout, cplain, f"decan {label} variant {vname} triad "
                       "buffer vs plain", failures)
                if ls and torch.equal(cout, args[2]):
                    failures.append(f"decan {label} {vname}: the triad "
                                    "wrote nothing")
        clean = target.build(True, True)(*args)
        for mode in LOOP_MODES:
            carry = loop_carry(mode, target.device)
            for k in DECAN_CHECK_KS:
                got = target.build_noisy(modes[mode], k, static=False)(
                    *args, carry)
                want = target.build_noisy(modes[mode], k, plain=True)(
                    *args, carry)
                torch.cuda.synchronize()
                worst = max(worst, _max_err(got[0], want[0]),
                            _max_err(got[1], want[1]))
                what = f"decan {label} {mode} k={k}"
                _equal(got, want, what + " (out, aux) vs plain", failures)
                _equal(got[0], clean, what + " out vs no noise", failures)
            if label == "t3 compute-bound":
                _equal(target.build_noisy(modes[mode], STATIC_CHECK_K,
                                          static=False)(*args, carry),
                       target.build_noisy(modes[mode], STATIC_CHECK_K)(
                           *args, carry),
                       f"decan {label} {mode} runtime k vs static "
                       f"k={STATIC_CHECK_K}", failures)
        max_err[kernel] = max(max_err.get(kernel, 0.0), worst)
        print(f"decan {label}: variants ref/fp/ls and ref x "
              f"{', '.join(LOOP_MODES)} x k in {list(DECAN_CHECK_KS)} vs "
              f"plain; max|kernel - plain| = {worst:.3g} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _graph_states() -> dict:
    """mode -> (NoiseMode, state) of every graph-level mode on the card at
    the card's scale (``core.noise.CARD_SCALE``), states from seed 0."""
    import torch

    from repro_torch.core.noise import make_modes

    return {name: (mode, mode.make_state(torch.Generator().manual_seed(0)))
            for name, mode in make_modes(device="cuda").items()}


def _check_graph(failures: list, max_err: dict) -> None:
    """Every graph-level mode's kernel at k in GRAPH_CHECK_KS, static
    (``apply``) and run-time (``apply_rt``), on the card's states: the aux
    and the new state bitwise equal to the plain version's; static k equal
    to run-time k for k >= 1; the input state unchanged."""
    import torch

    t0 = time.perf_counter()
    # the ici modes' no-mesh branch: fp_add32's kernel, or torch.sum (no
    # kernel: held against itself, as a check that it runs)
    kernel_of = {"ici_allreduce": "graph_fp_add32", "ici_allgather": None,
                 "ici_a2a": None}
    states = _graph_states()
    for name, (mode, state) in states.items():
        kernel = kernel_of.get(name, f"graph_{name}")
        before = {key: (tuple(t.clone() for t in v) if isinstance(v, tuple)
                        else v.clone()) for key, v in state.items()}
        worst = 0.0
        for k in GRAPH_CHECK_KS:
            for static, apply in ((True, mode.apply), (False, mode.apply_rt)):
                got = apply(state, k)
                want = apply(state, k, plain=True)
                torch.cuda.synchronize()
                worst = max(worst, _max_err(got[0], want[0]))
                what = f"graph {name} {'static' if static else 'runtime'} k={k}"
                _equal(got[0], want[0], what + " aux vs plain", failures)
                for key in state:
                    _equal(got[1][key], want[1][key],
                           f"{what} state[{key!r}] vs plain", failures)
            if k:
                _equal(mode.apply(state, k)[0], mode.apply_rt(state, k)[0],
                       f"graph {name} static vs runtime k={k}", failures)
        for key, v in before.items():
            _equal(state[key], v, f"graph {name} input state[{key!r}] kept",
                   failures)
        if kernel is not None:
            max_err[kernel] = max(max_err.get(kernel, 0.0), worst)
    print(f"graph modes: {', '.join(states)} x k in "
          f"{list(GRAPH_CHECK_KS)}, static and runtime, aux and state vs "
          f"plain ({time.perf_counter() - t0:.1f} s)", flush=True)


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
    _matmul_control(a, b, noise, "n=512", failures)
    for i, (label, hd, dtype, seq, causal, window, static) in enumerate(
            ATTENTION_CASES):
        q, k, v = _attention_inputs(dev, 2, 8, 2, seq, hd,
                                    getattr(torch, dtype), seed=i)
        _check_cases({f"flash_attention ({label})": _attention_case(
                         q, k, v, noise, causal=causal, window=window)},
                     all_ks, failures, max_err, full=static)
        if i == 0:
            _attention_control(q, k, v, noise, label, failures)
    print(f"main path's shapes: probe {MAIN_PROBE_STEPS} steps, spmv "
          f"n={MAIN_SPMXV_N} L=16 q=0, matmul n={MAIN_MATMUL_N}, attention "
          f"{MAIN_ATTENTION}")
    main_cases = _cases(main["noise"], main["noise"], MAIN_PROBE_STEPS,
                        main["vals"], main["cols"], main["x"], main["a"],
                        main["b"])
    main_cases["flash_attention"] = _attention_case(
        main["q"], main["k"], main["v"], main["noise"])
    _check_cases(main_cases, (0, 1), failures, max_err, full=False)
    _attention_control(main["q"], main["k"], main["v"], main["noise"],
                       "main shape", failures)
    _matmul_control(main["a"], main["b"], main["noise"], f"n={MAIN_MATMUL_N}",
                    failures)
    _check_fused(main, failures)
    _check_loops(_loop_cases(dev), LOOP_CHECK_KS, failures, max_err)
    _check_loops(_loop_main_cases(), LOOP_MAIN_CHECK_KS, failures, max_err)
    _check_decan(failures, max_err)
    _check_graph(failures, max_err)
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


def _bench(tmp: str, study: str, kernels, *extra) -> dict:
    """``python -m repro_torch.bench STUDY`` as a user runs it, with a store
    directory (its output streamed; raises on a nonzero exit). Adds the
    process's launches to ``kernels`` and prints the study's result."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    out = os.path.join(tmp, "bench_out")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, "-m", "repro_torch.bench", study,
                         "--store-dir", os.path.join(tmp, "bench_stores"),
                         "--out", out, *extra], env=env,
                        timeout=900).returncode
    if rc:
        raise RuntimeError(f"python -m repro_torch.bench {study}: exit {rc}")
    from repro_torch.bench.studies import STUDIES

    name = STUDIES[study][0]
    if kernels is not None:
        kernels.add_worker(os.path.join(out, f"{name}.stats.json"))
    with open(os.path.join(out, f"{name}.json")) as f:
        result = json.load(f)
    print(f"{study} result: {json.dumps(result)}", flush=True)
    return result


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


def drive(kernels: Kernels, counts: dict, seconds: dict, name: str, kernel,
          fn):
    """Drive one path with every count set to 0 just before it; read the
    counts just after (adding them to ``counts``), and fail unless it
    launched ``kernel`` (a name or a tuple of names)."""
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
    for kern in (kernel,) if isinstance(kernel, str) else kernel:
        if path_counts[kern][0] <= 0:
            raise RuntimeError(f"{name}: the path never launched {kern}")
    return out


def phase_main(tmp: str, kernels: Kernels) -> dict:
    from repro_torch.fleet.executor import run_worker
    from repro_torch.fleet.plan import SweepPlan, TargetSpec
    from repro_torch.launch.probe import main as probe_main

    banner("4. main path")
    seconds, verdicts = {}, {}
    counts = {name: [0, 0] for name in kernels.rows}

    def timed(name, kernel, fn):
        return drive(kernels, counts, seconds, name, kernel, fn)

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

    # (study, its extra arguments, the kernels it must launch): table1
    # replays fig5's sweeps from the shared store and launches the graph
    # noise kernels (its cost a pattern); table4 is analytic
    graph = tuple(k for k in kernels.rows if k.startswith("graph_"))
    study_kernels = (
        ("fig7", (), ("spmxv",)),
        ("fig5", (), ("stream_triad", "lat_mem_rd", "haccmk")),
        ("fig4", ("--pallas",), ("matmul_O0", "matmul_O3", "noisy_matmul")),
        ("table3", (), ("decan_table3",)),
        ("fig6", (), ("decan_livermore",)),
        ("table1", (), graph),
        ("table4", (), ()),
    )
    for study, extra, kerns in study_kernels:
        print(f"== 4e. python -m repro_torch.bench {study} {' '.join(extra)}"
              f"; card before: {card_state()}", flush=True)
        timed(f"bench_{study}", kerns,
              lambda: _bench(tmp, study, kernels, *extra))
    print(f"== 4f. python -m repro_torch.fleet calibrate run; card: "
          f"{card_state()}", flush=True)
    calib_store = os.path.join(tmp, "calibrate", "calibrate.jsonl")
    _fleet("calibrate", "run", "--store", calib_store)

    banner("5. launches on the main path")
    for name, (n_cuda, n_plain) in counts.items():
        print(f"{name}: kernel {n_cuda} launches, plain version {n_plain}")
        if n_cuda <= 0:
            raise RuntimeError(f"{name}: the main path never launched it")
        if n_plain:
            raise RuntimeError(f"{name}: the main path took the plain version")

    banner("4g. every store replays with 0 measured")
    for name in path_kernel:
        run(name, expect_no_measure=True)
    for study, extra, _ in study_kernels:
        _bench(tmp, study, None, *extra, "--expect-no-measure")
    _fleet("calibrate", "run", "--store", calib_store, "--expect-no-measure")
    print("wall time per characterization (s): "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print("verdicts (label, Abs^raw per mode, t0 s per mode): "
          + json.dumps(verdicts))
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


def _attention_work(q, k, causal=True, window=0):
    """Bytes and operations of one attention call: q, k, v read and out
    written once; two products of 2*hd per (query, key) pair the mask
    keeps (key <= query when causal, query - key < window when set), not
    the masked half of each diagonal block the kernel also computes."""
    B, H, S, hd = q.shape
    pairs = sum((i + 1 if causal else S) - (max(0, i - window + 1)
                                              if window else 0)
                for i in range(S))
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes + 4 * 1024, 2 * 2 * hd * B * H * pairs


def _map_encode_us(a, n: int, iters: int = 10000) -> float:
    """Host microseconds of the two tensor-map encodes (A and B^T) that
    every matmul launch makes, the mean of ``iters`` pairs."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    fn = _build.runtime_lib().repro_matmul_map_us
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_double
    bt = torch.empty_like(a)
    us = fn(a.data_ptr(), bt.data_ptr(), n, n, n, iters)
    if us < 0:
        raise RuntimeError("noisy_matmul: a tensor-map encode failed")
    print(f"noisy_matmul: two tensor-map encodes per launch take {us!r} us "
          f"on the host (mean of {iters})")
    return us


def phase_timing(main: dict, max_err: dict, launches: dict) -> list:
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attention_rt)
    from repro_torch.kernels.noise_probes.kernel import probe_plain, probe_rt
    from repro_torch.kernels.noisy_matmul.kernel import matmul_plain, matmul_rt
    from repro_torch.kernels.region import pallas_region
    from repro_torch.kernels.spmv_ell.kernel import spmv_ell_plain, spmv_ell_rt

    banner("6. timings at the main path's shapes, k=0 (CUDA events, median "
           f"of {TIMING_REPS})")
    rows = []

    # spmv_ell, q=0 and q=1 (n=2^21, L=16), CSR @ x on the same matrix
    warnings.filterwarnings("ignore", message="Sparse")   # beta / invariants
    spmv_q1 = pallas_region("spmxv", n=MAIN_SPMXV_N, nnz_per_row=16,
                            q=1.0).args_for_rt("fp")
    for q, (vals, cols, x) in ((0, (main["vals"], main["cols"], main["x"])),
                               (1, spmv_q1)):
        R, L = vals.shape
        order = torch.argsort(cols, dim=1)
        csr = torch.sparse_csr_tensor(
            torch.arange(0, R * L + 1, L, device=vals.device,
                         dtype=torch.int64),
            torch.gather(cols, 1, order).flatten().long(),
            torch.gather(vals, 1, order).flatten(), size=(R, x.shape[0]))
        lib_err = _max_err(csr @ x, spmv_ell_plain(vals, cols, x)[0])
        rows.append((
            "spmv_ell", f"spmv_ell q={q}",
            lambda v=vals, c=cols, xx=x: spmv_ell_rt(0, v, c, xx, mode="fp"),
            lambda v=vals, c=cols, xx=x: spmv_ell_plain(v, c, xx, mode="fp",
                                                        k_noise=0),
            lambda m=csr, xx=x: m @ xx, 4 * (2 * R * L + x.shape[0] + R + 1024),
            2 * R * L, FP32_FLOPS,
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

    rows.append(("noisy_matmul", "noisy_matmul",
                 lambda: matmul_rt(0, a, b, noise, mode="fp"),
                 lambda: matmul_plain(a, b, noise, mode="fp", k_noise=0),
                 tf32_matmul, 4 * (3 * n * n + 1024), 2 * n ** 3, TF32_FLOPS,
                 "torch.matmul with TF32 allowed"))
    extra = {"noisy_matmul": {"map_encode_us": _map_encode_us(a, n)}}

    # noise_probes, 1056 steps
    pnoise = main["noise"]
    rows.append(("noise_probes", "noise_probes",
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

    def bf16_sdpa():
        return sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)

    tf32_ms, tf32_dev = time_ms(tf32_sdpa), device_ms(tf32_sdpa)[0]
    bf16_ms, bf16_dev = time_ms(bf16_sdpa), device_ms(bf16_sdpa)[0]
    rows.append(("flash_attention", "flash_attention",
                 lambda: flash_attention_rt(0, q, k, v, noise, mode="fp"),
                 lambda: flash_attention_plain(q, k, v, noise, mode="fp",
                                               k_noise=0),
                 lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                 fa_bytes, fa_ops, TF32_FLOPS,
                 "scaled_dot_product_attention f32, is_causal, enable_gqa "
                 f"(max|d| vs plain {lib_err:.3g}); beside it the same call "
                 f"with TF32 allowed {tf32_ms!r} ms, {tf32_dev!r} ms on the "
                 f"device (the like-for-like yardstick: TF32 products, as "
                 f"the kernel's) and in bf16 {bf16_ms!r} ms, {bf16_dev!r} ms "
                 f"on the device"))

    def all_rows():
        """The rows above, then the loop kernels' (built, and their slot
        costs timed, only after the rows above are timed)."""
        yield from rows
        loop_rows, loop_extra = _loop_rows()
        extra.update(loop_extra)
        yield from loop_rows
        new_rows, new_extra = _decan_graph_rows()
        extra.update(new_extra)
        yield from new_rows

    meta = Kernels().rows
    out = {}
    one_launch = []
    for (name, label, kern, plain, lib, nbytes, nops, peak,
         lib_what) in all_rows():
        kernel_ms = time_ms(kern)
        kernel_host_ms = host_ms(kern)
        dev_ms, per_kernel, n_kernels, dev_whole = device_ms(kern)
        # the loop regions' plain versions run their loops in Python (one
        # PyTorch call a step): a few calls are enough
        slow = name in LOOP_PLAIN_REPS
        plain_ms = time_ms(plain, reps=LOOP_PLAIN_REPS.get(name, TIMING_REPS),
                           warmup=1 if slow else 3)
        library_ms = time_ms(lib) if lib is not None else None
        lib_dev_ms = device_ms(lib)[0] if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        share = {"event": bound_ms / kernel_ms,
                 "device": bound_ms / dev_ms if dev_ms else None}
        vs_lib = {"event": kernel_ms / library_ms if library_ms else None,
                  "device": (dev_ms / lib_dev_ms
                             if dev_ms and lib_dev_ms else None)}
        print(f"{label}: kernel_ms={kernel_ms!r} (host clock with "
              f"synchronize: {kernel_host_ms!r}) plain_ms={plain_ms!r} "
              f"bound_ms={bound_ms!r} ({bound_by}; {nbytes} bytes, {nops} "
              f"operations) library_ms={library_ms!r}"
              + (f" [{lib_what}]" if lib_what else "")
              + f" launches on the main path={launches[name]}", flush=True)
        print(f"  device time per call (torch.profiler): {dev_ms!r} ms = "
              + ", ".join(f"{k} {v!r}" for k, v in per_kernel.items())
              + f"; library call on the device: {lib_dev_ms!r} ms; kernels "
              f"launched per call: {n_kernels!r}"
              + ("" if dev_whole else " (INCOMPLETE: the trace dropped "
                 "records in every window; each kernel is averaged over its "
                 "own records)"))
        print(f"  share of the bound (bound / time): {share}; kernel / "
              f"library call: {vs_lib}", flush=True)
        if (name in ("noise_probes", "spmv_ell") or name in LOOP_PLAIN_REPS
                ) and n_kernels != 1:
            one_launch.append(f"{label}: {n_kernels!r} kernels a call")
        row = {"name": name, "route": "cuda",
               "source": meta[name]["source"],
               "replaces": meta[name]["replaces"],
               "launches": launches[name], "max_abs_err": max_err[name],
               "ms": kernel_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "device_ms": dev_ms,
               "device_records_whole": dev_whole,
               "library_device_ms": lib_dev_ms,
               "bound_share": share, "vs_library": vs_lib,
               "kernels_per_call": n_kernels, **extra.get(name, {})}
        if name in out:     # spmv at q=1: beside the q=0 row
            out[name]["q1"] = {k: v for k, v in row.items()
                               if k not in ("name", "route", "source",
                                            "replaces", "launches",
                                            "max_abs_err")}
        else:
            out[name] = row
    out["noise_probes"]["launch_floor"] = _launch_floor()
    out["noise_probes"]["us_per_pattern"] = _probe_slot_costs()
    if one_launch:
        raise RuntimeError("the probe, spmv and loop regions must launch "
                           "one kernel a call: " + "; ".join(one_launch))
    return list(out.values())


# plain-version timing reps of the loop regions, the DECAN loops and the
# graph modes (their loops run in Python); every one launches one kernel a
# call
LOOP_PLAIN_REPS = {"stream_triad": 5, "spmxv": 5, "lat_mem_rd": 3,
                   "haccmk": 2, "matmul_O0": 3, "matmul_O3": 3,
                   "decan_table3": 5, "decan_livermore": 2,
                   "graph_fp_add32": 5, "graph_mxu_fma128": 5,
                   "graph_vmem_ld": 5, "graph_hbm_stream": 5,
                   "graph_hbm_latency": 3}


def _loop_rows():
    """Phase-6 rows of the loop kernels at their phase-4 shapes, each timed
    as the sweeps call it: the region's runtime-k callable (fp_add) at
    k=0. Returns (rows, extra keys by kernel)."""
    import torch

    from repro_torch.bench.kernels import (haccmk_region, lat_mem_rd_region,
                                           matmul_region, spmxv_region,
                                           stream_region)
    from repro_torch.kernels.loop_regions import kernel as lk
    from repro_torch.kernels.loop_regions import ref as lref

    def main_call(region, name):
        fn, args = region.build_rt("fp_add"), region.args_for_rt("fp_add")
        # the slot's own cost: each mode's run-time kernel at k=0 against
        # the clean one, and its run-time and static builds at k=8
        slot = {"clean": time_ms(partial(region.build("", 0),
                                         *region.args_for("", 0)), reps=5,
                                 warmup=1)}
        for mode in LOOP_MODES:
            rt = region.build_rt(mode)
            slot[mode] = {
                "rt_k0": time_ms(partial(rt, 0, *region.args_for_rt(mode)),
                                 reps=5, warmup=1),
                "rt_k8": time_ms(partial(rt, 8, *region.args_for_rt(mode)),
                                 reps=3, warmup=1),
                "static_k8": time_ms(partial(region.build(mode, 8),
                                             *region.args_for(mode, 8)),
                                     reps=3, warmup=1)}
        print(f"{region.name}: event ms of the noise slot (clean kernel; "
              f"each mode's run-time kernel at k=0 and k=8, static k=8): "
              f"{slot}", flush=True)
        extra.setdefault(name, {})["slot_ms"] = slot
        return partial(fn, 0, *args), args

    # every call binds its tensors now (partial): the names are reused below
    rows, extra = [], {}
    # STREAM n=2^25, chunk 512: 12 bytes an element
    reg = stream_region(n=MAIN_STREAM_N)
    kern, (a, b, c, carry) = main_call(reg, "stream_triad")
    c_lib = torch.empty_like(c)
    rows.append(("stream_triad", "stream_triad n=2^25",
                 kern, partial(lref.stream_triad_plain, a, b, c, chunk=512,
                               mode="fp_add", k=0, carry=carry),
                 partial(torch.add, a, b, alpha=3.0, out=c_lib),
                 12 * MAIN_STREAM_N, 2 * MAIN_STREAM_N, FP32_FLOPS,
                 "torch.add(a, b, alpha=3.0, out=c)"))

    # lat_mem_rd: 1024 iterations x 8 dependent hops on a 2^26 table
    reg = lat_mem_rd_region(**MAIN_LAT)
    kern, (table, idx0, carry) = main_call(reg, "lat_mem_rd")
    n_iter, hops = MAIN_LAT["n_iter"], MAIN_LAT["hops_per_iter"]
    t8, t16 = (time_ms(partial(lk.lat_mem_rd, table, idx0, n_iter=n_iter,
                               hops=h, static=False)) for h in (8, 16))
    ns_hop = (t16 - t8) * 1e6 / (n_iter * 8)
    lat_bound = n_iter * hops * ns_hop * 1e-6
    print(f"lat_mem_rd: {ns_hop!r} ns a dependent hop on the 2^26 table "
          f"(8 against 16 hops an iteration: {t8!r} / {t16!r} ms); "
          f"latency bound {lat_bound!r} ms", flush=True)
    extra["lat_mem_rd"].update(ns_per_hop=ns_hop, latency_bound_ms=lat_bound)
    rows.append(("lat_mem_rd", "lat_mem_rd 2^26 table, 1024 x 8 hops",
                 kern, partial(lref.lat_mem_rd_plain, table, idx0,
                               n_iter=n_iter, hops=hops, mode="fp_add", k=0,
                               carry=carry),
                 None, 4 * n_iter * hops, 0, FP32_FLOPS, None))

    # HACCmk: 6 chains x 8 FP32 operations a lane and iteration
    reg = haccmk_region(**MAIN_HACC)
    kern, (x, carry) = main_call(reg, "haccmk")
    w, it = MAIN_HACC["width"], MAIN_HACC["n_iter"]
    rows.append(("haccmk", f"haccmk width {w}, {it} iterations",
                 kern, partial(lref.haccmk_plain, x, n_iter=it, mode="fp_add",
                               k=0, carry=carry),
                 None, 4 * w, w * it * lref.HACC_CHAINS * 8, FP32_FLOPS, None))

    # SPMXV large, q=0 (n=2^21, L=16): the bytes of spmv_ell's row
    warnings.filterwarnings("ignore", message="Sparse")
    reg = spmxv_region(n=MAIN_SPMXV_N, q=0.0, name="spmxv_large_q0.0")
    kern, (vals, cols, x, y, carry) = main_call(reg, "spmxv")
    R, L = vals.shape
    order = torch.argsort(cols, dim=1)
    csr = torch.sparse_csr_tensor(
        torch.arange(0, R * L + 1, L, device=vals.device, dtype=torch.int64),
        torch.gather(cols, 1, order).flatten().long(),
        torch.gather(vals, 1, order).flatten(), size=(R, x.shape[0]))
    lib_err = _max_err(csr @ x, kern()[0])
    rows.append(("spmxv", "spmxv n=2^21 L=16 q=0",
                 kern, partial(lref.spmxv_plain, vals, cols, x, y,
                               rows_per_iter=64, mode="fp_add", k=0,
                               carry=carry),
                 partial(torch.matmul, csr, x),
                 4 * (2 * R * L + x.shape[0] + R), 2 * R * L,
                 FP32_FLOPS,
                 f"torch.sparse_csr_tensor @ x (max|d| vs kernel {lib_err:.3g})"))

    # matmul O0 / O3, n=192 (Fig. 4)
    n = MAIN_MM_N
    for opt, name in ((False, "matmul_O0"), (True, "matmul_O3")):
        reg = matmul_region(n=n, optimized=opt)
        kern, args = main_call(reg, name)
        it = 16 * n if opt else 32 * n // lref.UNROLL_O0
        if opt:
            a, b, carry = args
            plain = partial(lref.matmul_o3_plain, a, b, n_iter=it,
                            mode="fp_add", k=0, carry=carry)
            nbytes = 4 * (lref.ROWS_O3 * n + n * n)
            nops = 2 * it * lref.ROWS_O3 * n
        else:
            a, b, out0, carry = args
            plain = partial(lref.matmul_o0_plain, a, b, out0, n_iter=it,
                            mode="fp_add", k=0, carry=carry)
            nbytes = 4 * (n + n * n)
            nops = 2 * it * lref.UNROLL_O0 * n
        rows.append((name, f"{name} n={n}", kern, plain, None, nbytes, nops,
                     FP32_FLOPS, None))
    return rows, extra


def _graph_work(name: str, state: dict, k: int) -> tuple:
    """(bytes, operations, peak) of one graph-mode call at k: its state read
    once and its new state written once, plus the bytes its patterns read
    from device memory (hbm_stream: k distinct tiles; the chase: k 4-byte
    hops); its FP32 adds (mxu: 2*128^3 bf16 tensor-core operations a
    pattern)."""
    f32 = 4
    if name == "fp_add32":
        e = state["c"].numel()
        return 9 * e * f32, k * e, FP32_FLOPS
    if name == "vmem_ld":
        return (state["buf"].numel() + 8 * 1024) * f32, k * 1024, FP32_FLOPS
    if name == "mxu_fma128":
        d = state["m"].shape[0]
        return 3 * d * d * 2, 2 * d ** 3 * k, BF16_FLOPS
    if name == "hbm_stream":
        e = state["acc"].numel()
        return (k + 2) * e * f32, k * e, FP32_FLOPS
    return 4 * k + 12, k, FP32_FLOPS      # hbm_latency


def _decan_graph_rows():
    """Phase-6 rows of the DECAN loops at their phase-4 shapes, each timed
    as the sweeps call it (the region's runtime-k fp_add callable at k=0):
    Table 3's data-bound scenario (STREAM's triad and 4-step chains;
    torch.add with alpha 3 as the library call) and Livermore; then each
    graph-level mode's kernel at k = GRAPH_ROW_K through ``apply_rt``,
    called as ``studies.fresh_calls`` calls it (hbm_stream from a base tile
    that moves every call, the chase going on where it stopped: no call
    reads the L2's lines of the call before), with its µs a pattern (the
    slope of event time over GRAPH_SLOPE_KS) beside
    ``pattern_cost(H100_SXM)``'s. Returns (rows, extra keys by kernel)."""
    import numpy as np
    import torch

    from repro_torch.bench.studies import fresh_calls
    from repro_torch.configs.base import H100_SXM

    rows, extra = [], {}
    targets = _decan_targets(MAIN_LIV["n_iter"], MAIN_LIV["n_iter"])
    # Table 3 data-bound: a, b read and the triad written, 12 bytes an
    # element; the chains' FP32 work of one 8-lane copy a warp
    tgt = targets["t3 data-bound"]
    reg = tgt.region()
    fn, args = reg.build_rt("fp_add"), reg.args_for_rt("fp_add")
    a, b, c, x0, carry = args
    n = MAIN_T3["n"]
    c_lib = torch.empty_like(c)
    n_iter = tgt.n_iter
    rows.append(("decan_table3", "decan_table3 data-bound N=2^25",
                 partial(fn, 0, *args),
                 partial(tgt.build_plain(True, True), a, b, c, x0),
                 partial(torch.add, a, b, alpha=3.0, out=c_lib),
                 12 * n, 2 * n + n_iter * 8 * 4 * 4 * 3, FP32_FLOPS,
                 "torch.add(a, b, alpha=3.0, out=c), the triad alone"))
    tgt = targets["livermore"]
    reg = tgt.region()
    fn, args = reg.build_rt("fp_add"), reg.args_for_rt("fp_add")
    w, it = MAIN_LIV["width"], MAIN_LIV["n_iter"]
    rows.append(("decan_livermore", f"decan_livermore width {w}, {it} "
                 "iterations", partial(fn, 0, *args),
                 partial(tgt.build_plain(True, True), args[0]),
                 None, 4 * MAIN_LIV["n"], w * it * 13, FP32_FLOPS, None))
    for name, (mode, state) in _graph_states().items():
        kernel = f"graph_{name}"
        if name.startswith("ici_"):      # fp_add32's kernel, or torch.sum
            continue
        # hbm_stream and the chase called so that no call reads the L2's
        # lines of the call before (studies.fresh_calls)
        call = fresh_calls(name, mode, state)
        ts = [time_ms(partial(call, k)) for k in GRAPH_SLOPE_KS]
        dev = [device_ms(partial(call, k))[0] for k in GRAPH_SLOPE_KS]
        slope_us = float(np.polyfit(GRAPH_SLOPE_KS, ts, 1)[0]) * 1e3
        dev_slope_us = (float(np.polyfit(GRAPH_SLOPE_KS, dev, 1)[0]) * 1e3
                        if all(d is not None for d in dev) else None)
        model = mode.pattern_cost(H100_SXM).time_on(H100_SXM)
        extra[kernel] = {"mode": name, "slope_ks": list(GRAPH_SLOPE_KS),
                         "slope_event_ms": ts, "slope_device_ms": dev,
                         "us_per_pattern": slope_us,
                         "device_us_per_pattern": dev_slope_us,
                         "model_us_per_pattern": max(model.values()) * 1e6,
                         "model_per_resource_s": model, "k": GRAPH_ROW_K}
        if name in ("hbm_stream", "hbm_latency"):
            # beside it, every call on the unchanged state (as a step calls
            # the mode): the same lines each call, L2 hits while they fit
            warm = [time_ms(partial(mode.apply_rt, state, k))
                    for k in GRAPH_SLOPE_KS]
            extra[kernel]["same_lines_event_ms"] = warm
            extra[kernel]["same_lines_us_per_pattern"] = float(
                np.polyfit(GRAPH_SLOPE_KS, warm, 1)[0]) * 1e3
        print(f"graph {name}: {slope_us!r} us a pattern by events, "
              f"{dev_slope_us!r} on the device (k in {list(GRAPH_SLOPE_KS)}: "
              f"{ts} ms, {dev} ms); the same lines every call: "
              f"{extra[kernel].get('same_lines_us_per_pattern')!r} us "
              f"({extra[kernel].get('same_lines_event_ms')} ms); "
              f"pattern_cost(H100_SXM): {max(model.values()) * 1e6!r} us "
              f"{model}", flush=True)
        nbytes, nops, peak = _graph_work(name, state, GRAPH_ROW_K)
        rows.append((kernel, f"{kernel} ({name}) k={GRAPH_ROW_K}",
                     partial(call, GRAPH_ROW_K),
                     partial(mode.apply_rt, state, GRAPH_ROW_K, plain=True),
                     None, nbytes, nops, peak, None))
    return rows, extra


def _launch_floor() -> dict:
    """An empty kernel launched through ``_build.launch``: the least a
    wrapper call can cost, by events, host clock and on the device."""
    import torch

    from repro_torch.kernels import _build

    t = torch.empty(1, device="cuda")

    def empty():
        _build.launch("noise_probes", "empty", (t,), (), mode_id=0, k=0,
                      static=False)

    floor = {"ms": time_ms(empty), "host_ms": host_ms(empty),
             "device_ms": device_ms(empty)[0]}
    print(f"launch floor (an empty kernel through _build.launch): "
          f"{floor['ms']!r} ms by events, {floor['host_ms']!r} ms host clock "
          f"with synchronize, {floor['device_ms']!r} ms on the device",
          flush=True)
    return floor


def _probe_slot_costs() -> dict:
    """µs a noise pattern of each mode in the probe at 1056 steps
    (``launch/slot_cost.py``, k in {0, 64, 128, 256}: fp and vmem patterns
    are too cheap to resolve at smaller k), beside the earlier kernel's mxu
    in PERF.md (6.42 µs, fitted at k in {0, 4, 8, 16})."""
    from repro_torch.launch.slot_cost import slot_costs

    costs = slot_costs(("fp", "vmem", "mxu"), (0, 64, 128, 256),
                       kernels=("noise_probes",))["noise_probes s1056"]
    per = {m: c["us_per_pattern"] for m, c in costs.items()}
    print(f"probe, µs a pattern (launch/slot_cost.py): {per} (earlier, in "
          f"PERF.md: mxu 6.42)", flush=True)
    return per


# ---------------------------------------------------------------------------
# phase 7: step-level injection and the paged serving engine, gemma-2b
# ---------------------------------------------------------------------------

# gemma-2b at full width and depth in bf16 (src/repro_torch/configs/
# gemma_2b.py: 18 layers, d_model 2048, MQA, head_dim 256, GeGLU d_ff
# 16384, vocab 256,000, tied), served with launch/serve.py's defaults, the
# reference CLI's: 8 requests on 4 slots, prompts of 2-11 tokens from
# RandomState(0)
SERVE_ARCH = "gemma_2b"
SERVE_ARGS = {"requests": 8, "slots": 4, "max_new": 16, "max_seq": 256,
              "page_size": 16}
# the serve regions: a paged engine two ticks into a full-slot campaign
# (serve/load.py:engine_for_probe) at the probe CLI's defaults (prompt 128,
# 4 slots, max_new 8, page 16)
SERVE_PROBE = {"slots": 4, "prompt": 128, "max_new": 8, "page_size": 16}
SERVE_KS = (1, 64)
# the traced noisy tick: mxu_fma128 at the run-time cap (~2.4 us a pattern,
# PERF.md, PR 16), long enough to overlap the step's kernels
TRACE_MODE, TRACE_K = "mxu_fma128", 512
# reps of every sweep point (min of reps, the host clock): a 5% tolerance
# of a 5-9 ms step is 0.25-0.45 ms, about the step's own spread from run to
# run, so each region is read twice to show how far its values hold
SERVE_REPS = 10
# reading -> its store: two fresh readings, then the second one replayed
SERVE_READINGS = {"reading 1": "serve_1.jsonl", "reading 2": "serve_2.jsonl",
                  "replay": "serve_2.jsonl"}
L2_NOTE = "(k tiles L2-resident below k~380)"


def _leaves(obj) -> list:
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _leaves(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _leaves(v)]
    return []


def _noise_overlap(trace_path: str, noise_name: str) -> dict:
    """Read a chrome trace of noisy calls: the kernels launched inside the
    ``NOISE_SCOPE`` ranges (by the correlation of their launch calls), their
    streams, the other kernels' (the step's) streams, and how much of each
    noise kernel's interval overlaps a step kernel. Fails unless a noise
    kernel named ``noise_name`` ran on a stream of its own, overlapping the
    step."""
    from repro_torch.core.noise import NOISE_SCOPE

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    scopes = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == NOISE_SCOPE]
    corr = set()
    for e in events:
        if e.get("cat") != "cuda_runtime":
            continue
        for sc in scopes:
            if (e.get("tid") == sc.get("tid")
                    and sc["ts"] <= e["ts"] <= sc["ts"] + sc.get("dur", 0)):
                corr.add(e.get("args", {}).get("correlation"))
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "spin_kernel" not in e.get("name", "")]
    noise = [e for e in kernels if e.get("args", {}).get("correlation")
             in corr]
    step = [e for e in kernels if e not in noise]
    noise_streams = sorted({e["args"].get("stream") for e in noise})
    step_streams = sorted({e["args"].get("stream") for e in step})
    overlap = []
    for n in noise:
        n0, n1 = n["ts"], n["ts"] + n["dur"]
        cover = sum(max(0.0, min(n1, s["ts"] + s["dur"]) - max(n0, s["ts"]))
                    for s in step)
        overlap.append(cover / max(n["dur"], 1e-9))
    out = {"scopes": len(scopes), "noise_kernels": sorted(
               {e["name"].split("(")[0] for e in noise}),
           "noise_streams": noise_streams, "step_streams": step_streams,
           "step_kernels": len(step),
           "noise_us": [e["dur"] for e in noise],
           "overlap_share": overlap}
    print(f"  trace of the noisy tick: {json.dumps(out)}", flush=True)
    if not any(noise_name in name for name in out["noise_kernels"]):
        raise RuntimeError(f"trace: no {noise_name} kernel under "
                           f"{NOISE_SCOPE} ({out})")
    if not step:
        raise RuntimeError("trace: no kernel of the step (the graph "
                           "replay's kernels are not in the trace)")
    if set(noise_streams) & set(step_streams):
        raise RuntimeError(f"trace: the noise ran on the step's stream "
                           f"({out})")
    if not any(o > 0 for o in overlap):
        raise RuntimeError(f"trace: the noise kernel overlaps no kernel of "
                           f"the step ({out})")
    return out


def phase_serve(tmp: str, kernels: Kernels) -> dict:
    """Gemma-2b at full width and depth, served (paged and dense, equal
    greedy tokens), its prefill and decode tick as step regions (noisy =
    clean bitwise, payload = k, the noise overlapping the step in a trace,
    classified into a store and replayed with 0 measured, t(0) from the
    graph and eagerly), then the probe CLI's serve and decode-step paths at
    the smoke config. Returns the graph-noise kernels' launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.absorption import measure
    from repro_torch.core.campaign import Campaign, CampaignStore
    from repro_torch.core.controller import Controller
    from repro_torch.core.injector import GraphStep, step_modes
    from repro_torch.launch.probe import DEFAULT_GRAPH_MODES
    from repro_torch.launch.probe import main as probe_main
    from repro_torch.launch.serve import report, serve
    from repro_torch.models.model import build
    from repro_torch.serve.load import (engine_for_probe, serve_names,
                                         serve_regions)

    banner("7. serving: gemma-2b at full width and depth (bf16) and its "
           "step regions")
    seconds: dict = {}
    counts = {name: [0, 0] for name in kernels.rows}
    graph = tuple(f"graph_{m}" for m in DEFAULT_GRAPH_MODES)
    cfg = get_config(SERVE_ARCH)
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(0, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name}: {n_params} parameters in bf16 drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; {card_line()}", flush=True)

    def serve_both():
        out = {}
        for dense in (False, True, False):
            eng, reqs, dt = serve(api, params, dense=dense, **SERVE_ARGS)
            print(report(eng, reqs, dt), flush=True)
            out.setdefault(dense, []).append(([r.out for r in reqs], eng,
                                              dt))
        if out[False][0][0] != out[True][0][0]:
            raise RuntimeError("paged and dense greedy tokens differ")
        if out[False][0][0] != out[False][1][0]:
            raise RuntimeError("two paged runs gave different tokens")
        toks, eng, dt = out[False][1]
        rep = eng.report()
        n_tok = sum(len(t) for t in toks)
        res = {"tok_s": n_tok / dt, "decode_tok_s": rep["decode_tok_s"],
               "total_tok_s": rep["total_tok_s"], "ticks": rep["ticks"],
               "wall_s": dt, "dense_wall_s": out[True][0][2]}
        print(f"gemma-2b serve (paged, warm): {json.dumps(res)}; paged and "
              f"dense greedy tokens equal; {card_line()}", flush=True)
        return res

    served = drive(kernels, counts, seconds, "serve_gemma2b", (),
                   serve_both)

    def regions_path():
        registry = step_modes("cuda")
        eng = engine_for_probe(api, params, **SERVE_PROBE)
        names = serve_names(cfg.name, **SERVE_PROBE)
        regions = serve_regions(eng, names, {m: registry[m]
                                             for m in DEFAULT_GRAPH_MODES})
        pf_fn, pf_args, tk_fn, tk_args = eng.probe_cells()
        eager = {names[0]: (pf_fn, pf_args), names[1]: (tk_fn, tk_args)}
        res = {}
        for region in regions:
            clean = region.build("", 0)
            if not isinstance(clean, GraphStep):
                raise RuntimeError(f"{region.name}: the clean step is not a "
                                   "CUDA graph")
            want = [t.clone() for t in _leaves(clean(*region.args_for("", 0)))]
            torch.cuda.synchronize()
            for mode in DEFAULT_GRAPH_MODES:
                for k in SERVE_KS:
                    for how, call in (
                            ("static", lambda: region.build(mode, k)(
                                *region.args_for(mode, k))),
                            ("runtime", lambda: region.build_rt(mode)(
                                k, *region.args_for_rt(mode)))):
                        got = _leaves(call()[0])
                        torch.cuda.synchronize()
                        if len(got) != len(want) or not all(
                                torch.equal(a, b) for a, b in zip(got, want)):
                            raise RuntimeError(f"{region.name}: noisy out != "
                                               f"clean out ({mode} {how} "
                                               f"k={k})")
                    rep = region.payload_check(mode, k)
                    if rep.payload != k:
                        raise RuntimeError(f"{region.name}: payload check "
                                           f"{mode} k={k}: {rep}")
            print(f"{region.name}: noisy out bitwise equal to clean out, "
                  f"static and run-time k in {list(SERVE_KS)}, and payload "
                  f"= k for {', '.join(DEFAULT_GRAPH_MODES)}", flush=True)
            fn, args = eager[region.name]
            t_graph = measure(clean, region.args_for("", 0), reps=10)
            t_eager = measure(fn, args, reps=10)
            ev_graph = time_ms(partial(clean, *region.args_for("", 0)))
            ev_eager = time_ms(partial(fn, *args))
            res[region.name] = {"t0_graph_ms": t_graph * 1e3,
                                "t0_eager_ms": t_eager * 1e3,
                                "event_graph_ms": ev_graph,
                                "event_eager_ms": ev_eager}
            print(f"{region.name}: t(0) host clock with synchronize, min of "
                  f"10: graph {t_graph * 1e3!r} ms, eager {t_eager * 1e3!r} "
                  f"ms; CUDA events, median of {TIMING_REPS}: graph "
                  f"{ev_graph!r} ms, eager {ev_eager!r} ms; {card_line()}",
                  flush=True)
        tick = regions[1]
        fn, args = tick.build_rt(TRACE_MODE), tick.args_for_rt(TRACE_MODE)
        fn(TRACE_K, *args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(3):
                fn(TRACE_K, *args)
            torch.cuda.synchronize()
        path = os.path.join(tmp, "noisy_tick_trace.json")
        prof.export_chrome_trace(path)
        res["trace"] = _noise_overlap(path, "gmxu")

        # two fresh readings, each into a store of its own, then the second
        # store replayed; beside the fit's Abs^raw (the hinge's knee, k1)
        # each mode prints the threshold reading (the last k within 5% of
        # t(0)) and the largest t(k)/t(0) of its sweep
        verdicts = {}
        for reading, store in SERVE_READINGS.items():
            camp = Campaign(CampaignStore(os.path.join(tmp, store)),
                            Controller(reps=SERVE_REPS))
            t_read = time.perf_counter()
            try:
                reps_ = {r.name: camp.characterize(r, DEFAULT_GRAPH_MODES)
                         for r in regions}
            finally:
                camp.store.close()
            print(f"characterize ({reading}, reps {SERVE_REPS}): "
                  f"{camp.stats} in {time.perf_counter() - t_read:.1f} s",
                  flush=True)
            if reading == "replay" and camp.stats.measured:
                raise RuntimeError(f"the serve store replayed with "
                                   f"{camp.stats.measured} measured")
            for name, rep in reps_.items():
                _payloads_ok(rep)
                modes = {m: {"abs_raw": r.fit.k1,
                             "k1_threshold": r.fit.k1_threshold,
                             "max_ratio": float(max(r.curve.ratios())),
                             "ks": list(r.curve.ks),
                             "ratios": [float(x) for x in r.curve.ratios()],
                             "t0_ms": r.fit.t0 * 1e3}
                         for m, r in rep.results.items()}
                verdicts.setdefault(name, {})[reading] = {
                    "label": rep.bottleneck.label, "modes": modes}
                print(f"{name} ({reading}): " + ", ".join(
                    f"{m} Abs^raw={v['abs_raw']!r} threshold="
                    f"{v['k1_threshold']!r} max t(k)/t(0)="
                    f"{v['max_ratio']!r}" + (f" {L2_NOTE}"
                                             if m == "hbm_stream" else "")
                    for m, v in modes.items())
                    + f" => {rep.bottleneck.label}; {card_line()}",
                    flush=True)
        res["verdicts"] = verdicts
        return res

    regions_res = drive(kernels, counts, seconds, "serve_regions_gemma2b",
                        graph, regions_path)

    cli = {"probe_serve_smoke": ["--serve", "--arch", "gemma-2b"],
           "probe_decode_smoke": ["--arch", "gemma-2b", "--kind", "decode"]}
    for name, argv in cli.items():
        store = os.path.join(tmp, f"{name}.jsonl")
        print(f"== python -m repro_torch.launch.probe {' '.join(argv)}",
              flush=True)
        drive(kernels, counts, seconds, name, graph,
              lambda: probe_main(argv + ["--store", store]))
        _, stats = probe_main(argv + ["--store", store,
                                      "--expect-no-measure"])
        if stats.measured:
            raise RuntimeError(f"{name}: replay measured {stats.measured}")
    print("phase 7 wall time per path (s): "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print("serve results: " + json.dumps({"served": served,
                                          **regions_res}), flush=True)
    for name, (n_cuda, n_plain) in counts.items():
        if n_cuda or n_plain:
            print(f"{name}: kernel {n_cuda} launches on the serving paths, "
                  f"plain version {n_plain} (the payload checks' oracle)")
    return {name: n_cuda for name, (n_cuda, _) in counts.items()}


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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        serve_launches = phase_serve(tmp, kernels)
    for row in rows:        # the serving paths are main paths too
        row["launches"] += serve_launches[row["name"]]
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
