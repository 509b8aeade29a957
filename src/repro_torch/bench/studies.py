"""The paper's studies on the port's loop kernels: Fig. 7 (SPMXV), Fig. 5
(STREAM, lat_mem_rd, HACCmk), Fig. 4 (matmul -O0 / -O3), Table 3 (the four
FP/LS overlap scenarios by DECAN and by noise), Fig. 6 (the Livermore loop,
where only the two methods combined diagnose the bottleneck), Table 1 (the
card measured beside the analytic model) and Table 4 (HBM-class against
DDR-class memory for SPMXV, analytic): the counterparts of the reference's
``benchmarks/fig7_spmxv.py``, ``fig5_hwchar.py``, ``fig4_matmul.py``,
``table3_decan.py``, ``fig6_overlap.py``, ``table1_systems.py`` and
``table4_memsys.py``, with the same JSON structure (fig7's ``findings``,
fig5's ``signatures``, fig4's ``signature_flip`` and ``pallas``, table3's
and fig6's ``sat_fp``/``sat_ls``/labels, table1's rows, table4's
``hbm_collapse``).

    PYTHONPATH=src python -m repro_torch.bench STUDY [--device cuda|cpu] \\
        [--full] [--pallas] [--store-dir D] [--out DIR] [--expect-no-measure]

STUDY is fig7, fig5, fig4, table3, fig6, table1 or table4. ``--pallas``
(fig7 and fig4, as the reference's) also runs the study on the Pallas
kernel's counterpart (fig7: the ELL SPMV, fig4: the tiled matmul); the
other studies refuse it.

``--device cuda`` (the default) measures the CUDA kernels on the card;
sizes are the card's (below). ``--device cpu`` runs the plain PyTorch
versions at smoke sizes: it checks the path, and its times say nothing
about any device.

With ``--store-dir`` every characterization is a resumable campaign (one
store per region, as ``benchmarks/common.py:characterize`` keeps them),
and so are the DECAN variants (``run_decan_stored``: ``decan`` records in
the region's store) and the analytic predictions (``pred`` records of
``AnalyticCampaign``, in the store of the region they model): a second run
replays them and measures 0 points (``--expect-no-measure`` fails the run
otherwise). fig7's GFLOP/s and table1's per-pattern costs come from fresh
timings in every run, as fig7's do in the reference.

Sizes on the card, against the reference's host sizes:
  fig7: small n=2^17 (vals, cols, x, y: 17 MB, inside the 50 MB L2, the
        cache-resident matrix the paper intends) and large n=2^21 (285 MB,
        5x the L2); L=16, 64 rows an iteration — the reference's sizes;
  fig5: STREAM n=2^25 (3 x 128 MiB; the reference's 2^22 x 3 x 4 B = 48 MiB
        would sit in the L2); lat_mem_rd a 2^26-entry table (256 MiB; the
        reference's 2^22 is 16 MiB), 1024 iterations (every call walks the
        same 8,192 hops from the table's start, as the reference's does,
        so after the first call the chase hits the L2); HACCmk 60,000 iterations at width 135,168 (1,024 lanes
        on each of the 132 SMs; the reference's width 8 would occupy 8
        threads of one SM). ``--full`` doubles them as the reference's does;
  fig4: n=192, the reference's (one block of 192 threads: the study is
        about register discipline in one loop, not about filling the card);
        ``--pallas``: the tiled matmul at n=128 (full: 256), the reference's;
  table3: N=2^25 (the reference's 2^22 would keep a, b and c, 48 MiB, in
        the L2, and the data-bound cases would not be bound by device
        memory); the reference's depths and iterations (stream: N / 512
        chunks, walked by 4,224 warps); token and scatter_dep at width
        67,584 (512 lanes on each SM: 8,448 copies of the reference's
        8-lane loop);
  fig6: the reference's buffer (2^18) and iterations (60,000; full
        150,000) at width 135,168;
  table1: fig5's loops at fig5's sizes (one --store-dir replays fig5's
        sweeps), modelled at the same shapes on the H100 SXM and a
        DDR-class point; each graph-level noise mode's measured cost a
        pattern beside the model's (``fresh_calls``: the device-memory
        modes on lines the last call left in the L2 only by chance);
  table4: the reference's SPMXV (N=2^21, 16 a row), analytic.

Each run writes ``<out>/<study>.json`` and, beside it, ``<study>.stats.json``
with the process's kernel launches ({kernel: [CUDA, plain]}).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Callable, Optional

from repro_torch.configs.base import H100_SXM

OUT_DIR = "experiments/bench_torch"

# (quick, full) sizes per device kind
FIG7_SIZES = {"cuda": {"small": 1 << 17, "large": 1 << 21},
              "cpu": {"small": 1 << 10, "large": 1 << 12}}
FIG5_SIZES = {
    "cuda": {"stream_n": 1 << 25, "lat_table": 1 << 26, "lat_iter": 1024,
             "hacc_iter": 60_000, "hacc_width": 132 * 1024},
    "cpu": {"stream_n": 1 << 14, "lat_table": 1 << 12, "lat_iter": 64,
            "hacc_iter": 64, "hacc_width": 8},
}
FIG4_N = {"cuda": 192, "cpu": 32}
FIG4_PALLAS_N = {"cuda": 128, "cpu": 128}     # quick; --full doubles it
T3_SIZES = {"cuda": {"n": 1 << 25, "width": 132 * 512},
            "cpu": {"n": 1 << 13, "width": 8}}
# Table 3 scenario -> (kind, chain depth, iterations; stream: N // CHUNK):
# the reference's on the card, a few iterations on the CPU
T3_ITERS = {"cuda": {"token": 25_000, "scatter_dep": 20_000},
            "cpu": {"token": 16, "scatter_dep": 16}}
T3_SCENARIOS = {
    "compute-bound": ("token", 24),
    "data-bound": ("stream", 4),
    "full-overlap": ("stream", 192),
    "limited-overlap": ("scatter_dep", 24),
}
T3_EXPECTED = {  # the paper's Table 3 readouts (noise column)
    "compute-bound": "fp low / l1 high",
    "data-bound": "mem low / fp high",
    "full-overlap": "both ~0",
    "limited-overlap": "moderate/ambiguous",
}
FIG6_SIZES = {"cuda": {"n": 1 << 18, "n_iter": 60_000, "width": 132 * 1024},
              "cpu": {"n": 1 << 12, "n_iter": 64, "width": 8}}
# graph-level noise quantities of table1's cost-a-pattern fit
PATTERN_KS = {"cuda": (0, 128, 256, 512), "cpu": (0, 4, 8, 16)}


def banner(title: str) -> None:
    print(f"\n=== {title} {'=' * max(0, 66 - len(title))}", flush=True)


def device_label(device: str) -> str:
    """The device a study ran on: the card's name, or "cpu"."""
    import torch

    if device == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"


class Study:
    """Shared state of one study run: the device, where stores go, and the
    points measured and replayed across its regions."""

    def __init__(self, device: str, store_dir: Optional[str]):
        from repro_torch.core.campaign import CampaignStats
        from repro_torch.kernels.region import resolve_device

        resolve_device(device)          # no card: fail before any work
        self.device = device
        self.store_dir = store_dir
        self.stats = CampaignStats()

    def characterize(self, ctl, region, modes):
        """``Controller.characterize`` through a per-region campaign store
        when ``store_dir`` is set, plain otherwise."""
        if not self.store_dir:
            return ctl.characterize(region, modes=modes)
        from repro_torch.fleet.executor import characterize_region

        return characterize_region(
            region, modes, controller=ctl, stats=self.stats,
            store=self._store_path(region.name))

    def _store_path(self, region: str) -> str:
        os.makedirs(self.store_dir, exist_ok=True)
        return os.path.join(self.store_dir, f"{region}.jsonl")

    def run_decan(self, target, *, reps: int, inner: int = 1):
        """``run_decan`` through the target's store when ``store_dir`` is
        set (``benchmarks/common.py:run_decan_stored``): the variant
        timings land in the file of the region's noise sweeps, and a re-run
        replays them."""
        from repro_torch.core.campaign import CampaignStore
        from repro_torch.core.decan import run_decan

        if not self.store_dir:
            return run_decan(target, reps=reps, inner=inner, stats=self.stats)
        store = CampaignStore(self._store_path(target.name))
        try:
            return run_decan(target, reps=reps, inner=inner, store=store,
                             stats=self.stats)
        finally:
            store.close()

    def predict(self, store_region: str, region: str, terms, mode, hw):
        """``predict_absorption``'s fit of one mode under ``hw``, through an
        ``AnalyticCampaign`` on ``store_region``'s store when ``store_dir``
        is set (a ``pred`` record keyed (region, mode), replayed on a
        re-run)."""
        from repro_torch.core.analytic import predict_absorption
        from repro_torch.core.campaign import AnalyticCampaign, CampaignStore

        if not self.store_dir:
            return predict_absorption(terms, mode, hw)
        store = CampaignStore(self._store_path(store_region))
        try:
            camp = AnalyticCampaign(store, hw=hw)
            fit = camp.predict_mode(region, terms, mode).fit
        finally:
            store.close()
        self.stats.measured += camp.stats.measured
        self.stats.cached += camp.stats.cached
        return fit


def save(out_dir: str, name: str, payload) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    return path


# ---------------------------------------------------------------------------
# Fig. 7/8: SPMXV, performance vs absorption across q
# ---------------------------------------------------------------------------

def sweep_ab(kernel: str, mode: str, ks, *, reps: int, device: str,
             **sizes) -> dict:
    """Wall-clock one (kernel, mode) k-sweep on the compile-once runtime-k
    path against the trace-per-k fallback (the paper's cost model),
    counting the builds each path takes (``benchmarks/common.py:
    pallas_sweep_ab``)."""
    from repro_torch.core.controller import Controller
    from repro_torch.kernels.region import pallas_region

    out: dict = {}
    for path, compile_once in (("compile_once", True), ("trace_per_k", False)):
        builds = {"n": 0}
        region = pallas_region(
            kernel, device=device,
            trace_hook=lambda: builds.__setitem__("n", builds["n"] + 1),
            **sizes)
        ctl = Controller(reps=reps, compile_once=compile_once,
                         verify_payload=False, stop_ratio=100.0)
        t0 = time.perf_counter()
        ctl.run_mode(region, mode, ks=ks)
        out[path] = {"seconds": round(time.perf_counter() - t0, 3),
                     "executables": builds["n"]}
    out["speedup"] = round(out["trace_per_k"]["seconds"]
                           / max(out["compile_once"]["seconds"], 1e-9), 2)
    print(f"  [{kernel}/{mode} sweep over {len(list(ks))} ks: compile-once "
          f"{out['compile_once']['executables']} build(s) in "
          f"{out['compile_once']['seconds']:.2f}s vs trace-per-k "
          f"{out['trace_per_k']['executables']} in "
          f"{out['trace_per_k']['seconds']:.2f}s -> {out['speedup']:.1f}x]")
    return out


def run_fig7_pallas(study: Study, quick: bool = True) -> dict:
    """The q-study on the ELL SPMV kernel (``csrc/spmv_ell.cu``)."""
    from repro_torch.core.absorption import measure
    from repro_torch.core.controller import Controller
    from repro_torch.kernels.region import pallas_region

    banner("Fig 7 (pallas) — ELL SPMV kernel: performance vs absorption")
    qs = (0.0, 0.5, 1.0) if quick else (0.0, 0.25, 0.5, 0.75, 1.0)
    n = 512 if quick else 2048
    nnz = 16
    ctl = Controller(reps=2 if quick else 3)
    rows = []
    for q in qs:
        region = pallas_region("spmxv", device=study.device, n=n,
                               nnz_per_row=nnz, q=q)
        t0 = measure(region.build("", 0), region.args_for("", 0),
                     reps=2 if quick else 3)
        gflops = 2.0 * n * nnz / t0 / 1e9
        rep = study.characterize(ctl, region, ("fp", "vmem"))
        rows.append({"q": q, "region": region.name, "gflops": gflops,
                     "abs_fp": rep.results["fp"].fit.k1,
                     "abs_vmem": rep.results["vmem"].fit.k1,
                     "label": rep.bottleneck.label})
        r = rows[-1]
        print(f"  pallas q={q:4.2f}  {gflops:6.3f} GFLOP/s  "
              f"Abs_FP={r['abs_fp']:6.1f} Abs_VMEM={r['abs_vmem']:6.1f} "
              f"-> {r['label']}")
    ks = (0, 1, 2, 4, 8, 16) if quick else (0, 1, 2, 4, 8, 16, 32, 64)
    ab = sweep_ab("spmxv", "fp", ks, reps=2 if quick else 3,
                  device=study.device, n=n, nnz_per_row=nnz)
    return {"rows": rows, "sweep_cost": ab}


def fig7_findings(large: list) -> dict:
    """The paper's finding on the large matrix: performance only falls with
    q while absorption is not monotonic (a regime transition)."""
    perf_monotonic = all(large[i]["gflops"] >= large[i + 1]["gflops"] - 0.15
                         for i in range(len(large) - 1))
    fp_abs = [r["abs_fp"] for r in large]
    non_monotonic = any(fp_abs[i] > min(fp_abs[:i] or [1e9])
                        for i in range(1, len(fp_abs)))
    return {"perf_monotonic": perf_monotonic,
            "absorption_non_monotonic": non_monotonic}


def run_fig7(study: Study, quick: bool = True, pallas: bool = False) -> dict:
    """Sweep q on a small (cache-resident) and a large (bandwidth-bound at
    q=0) matrix; GFLOP/s and FP/L1 absorption per q."""
    from repro_torch.bench.kernels import spmxv_region
    from repro_torch.core.absorption import measure
    from repro_torch.core.controller import Controller

    banner("Fig 7/8 — SPMXV: performance vs absorption across q")
    qs = (0.0, 0.25, 0.5, 1.0) if quick else (0.0, 0.1, 0.25, 0.5, 0.75, 1.0)
    sizes = FIG7_SIZES[study.device]
    nnz = 16
    ctl = Controller(reps=3 if quick else 5, verify_payload=False)
    out: dict = {}
    for label, n in sizes.items():
        rows = []
        for q in qs:
            region = spmxv_region(n=n, nnz_per_row=nnz, q=q,
                                  name=f"spmxv_{label}_q{q}",
                                  device=study.device)
            t0 = measure(region.build("", 0), region.args_for("", 0),
                         reps=3 if quick else 5)
            gflops = 2.0 * n * nnz / t0 / 1e9
            rep = study.characterize(ctl, region, ("fp_add", "l1_ld"))
            rows.append({"q": q, "gflops": gflops,
                         "abs_fp": rep.results["fp_add"].fit.k1,
                         "abs_l1": rep.results["l1_ld"].fit.k1,
                         "label": rep.bottleneck.label})
            r = rows[-1]
            print(f"  {label:5s} q={q:4.2f}  {gflops:6.2f} GFLOP/s  "
                  f"Abs_FP={r['abs_fp']:6.1f} Abs_L1={r['abs_l1']:6.1f} "
                  f"-> {r['label']}", flush=True)
        out[label] = rows
    out["findings"] = fig7_findings(out["large"])
    print(f"  large: performance monotonically falls: "
          f"{out['findings']['perf_monotonic']}; absorption non-monotonic "
          f"(regime transition): "
          f"{out['findings']['absorption_non_monotonic']}")
    if pallas:
        out["pallas"] = run_fig7_pallas(study, quick)
    out["device"] = device_label(study.device)
    out["sizes"] = sizes
    return out


# ---------------------------------------------------------------------------
# Fig. 5: STREAM / lat_mem_rd / HACCmk absorption signatures
# ---------------------------------------------------------------------------

def fig5_signatures(rows: dict) -> dict:
    """The differential signatures that validate the method: STREAM is
    bandwidth-bound, lat_mem_rd absorbs more memory noise than STREAM,
    HACCmk absorbs the least fp noise."""
    return {
        "stream_is_bandwidth": rows["stream"]["bottleneck"] == "bandwidth",
        "latmem_absorbs_memory": rows["lat_mem_rd"]["abs"]["mem_ld"]
        > rows["stream"]["abs"]["mem_ld"],
        "haccmk_fp_lowest": rows["haccmk"]["abs"]["fp_add"]
        <= min(rows["haccmk"]["abs"]["l1_ld"],
               rows["stream"]["abs"]["fp_add"]),
    }


def run_fig5(study: Study, quick: bool = True) -> dict:
    """Characterize the three hardware-characterization loops under fp, l1
    and memory noise."""
    from repro_torch.bench.kernels import (haccmk_region, lat_mem_rd_region,
                                           stream_region)
    from repro_torch.core.controller import Controller

    banner("Fig 5 — STREAM / lat_mem_rd / HACCmk absorption signatures")
    scale = 1 if quick else 2
    sz = FIG5_SIZES[study.device]
    regions = {
        "stream": stream_region(n=sz["stream_n"] * scale,
                                device=study.device),
        # the chase table must exceed the last-level cache so every hop is
        # a genuine miss — that slack is what memory noise is absorbed into
        "lat_mem_rd": lat_mem_rd_region(table_len=sz["lat_table"] * scale,
                                        n_iter=sz["lat_iter"] * scale,
                                        device=study.device),
        "haccmk": haccmk_region(n_iter=sz["hacc_iter"] * scale,
                                width=sz["hacc_width"], device=study.device),
    }
    ctl = Controller(reps=3 if quick else 5, verify_payload=False)
    rows = {}
    for name, region in regions.items():
        rep = study.characterize(ctl, region, ("fp_add", "l1_ld", "mem_ld"))
        rows[name] = {"abs": rep.absorptions(),
                      "abs_rel": rep.absorptions(relative=True),
                      "bottleneck": rep.bottleneck.label,
                      "confidence": rep.bottleneck.confidence}
        print(rep.summary(), flush=True)
    sig = fig5_signatures(rows)
    print("signatures:", sig)
    return {"rows": rows, "signatures": sig,
            "device": device_label(study.device), "sizes": sz}


# ---------------------------------------------------------------------------
# Fig. 4: matmul -O0 vs -O3
# ---------------------------------------------------------------------------

def run_fig4(study: Study, quick: bool = True, pallas: bool = False) -> dict:
    """The naive loop absorbs fp noise but not L1 noise; the
    register-blocked one absorbs little of either (the signature flips)."""
    from repro_torch.bench.kernels import matmul_region
    from repro_torch.core.controller import Controller

    banner("Fig 4 — matmul -O0 vs -O3 (absorption flip under optimization)")
    n = FIG4_N[study.device] * (1 if quick else 2)
    ctl = Controller(reps=3 if quick else 5, verify_payload=False)
    rows = {}
    for opt in (False, True):
        region = matmul_region(n=n, optimized=opt, device=study.device)
        rep = study.characterize(ctl, region, ("fp_add", "l1_ld"))
        rows[region.name] = {"abs": rep.absorptions(),
                             "bottleneck": rep.bottleneck.label}
        print(rep.summary(), flush=True)
    o0, o3 = rows["matmul_O0"]["abs"], rows["matmul_O3"]["abs"]
    flip = (o0["fp_add"] > o0["l1_ld"]) and (max(o3.values()) <= 5
                                             or o3["fp_add"] < o0["fp_add"])
    print(f"-O0 absorbs fp ({o0['fp_add']:.0f}) >> l1 ({o0['l1_ld']:.0f}); "
          f"-O3 absorbs ~nothing ({o3}) -> signature flip: {flip}")
    out = {"rows": rows, "signature_flip": bool(flip),
           "device": device_label(study.device), "n": n}
    if pallas:
        out["pallas"] = run_fig4_pallas(study, quick)
    return out


def run_fig4_pallas(study: Study, quick: bool = True) -> dict:
    """Fig. 4's fp-vs-vmem axes on the tiled matmul kernel
    (``csrc/noisy_matmul.cu``), and the compile-once vs trace-per-k sweep
    cost (``benchmarks/fig4_matmul.py:run_pallas``)."""
    from repro_torch.core.controller import Controller
    from repro_torch.kernels.region import pallas_region

    banner("Fig 4 (pallas) — tiled matmul kernel, fp vs vmem noise")
    n = FIG4_PALLAS_N[study.device] * (1 if quick else 2)
    ctl = Controller(reps=2 if quick else 3)
    region = pallas_region("matmul", device=study.device, n=n)
    rep = study.characterize(ctl, region, ("fp", "vmem"))
    print(rep.summary(), flush=True)
    ks = (0, 1, 2, 4, 8, 16) if quick else (0, 1, 2, 4, 8, 16, 32, 64)
    ab = sweep_ab("matmul", "fp", ks, reps=2 if quick else 3,
                  device=study.device, n=n)
    return {"region": region.name, "abs": rep.absorptions(),
            "bottleneck": rep.bottleneck.label, "sweep_cost": ab}


# ---------------------------------------------------------------------------
# Table 3: DECAN (decremental) against noise injection (incremental)
# ---------------------------------------------------------------------------

def t3_scenarios(device: str, quick: bool = True) -> dict:
    """scenario -> (kind, depth, iterations) at ``device``'s sizes."""
    from repro_torch.kernels.decan_loops.ref import CHUNK

    scale = 1 if quick else 2
    n = T3_SIZES[device]["n"]
    iters = dict(T3_ITERS[device], stream=n // CHUNK)
    return {name: (kind, depth, iters[kind] * scale)
            for name, (kind, depth) in T3_SCENARIOS.items()}


def run_table3(study: Study, quick: bool = True) -> dict:
    """Each overlap scenario by both methods: DECAN's Sat_FP / Sat_LS and
    scenario, the noise absorptions (fp_add, l1_ld) and label, and the
    combined label."""
    from repro_torch.bench.kernels import table3_target
    from repro_torch.core.classifier import classify, cross_check_with_decan
    from repro_torch.core.controller import Controller

    banner("Table 3 — DECAN (decremental) vs noise injection (incremental)")
    sz = T3_SIZES[study.device]
    reps = 3 if quick else 5
    ctl = Controller(reps=reps, verify_payload=False)
    rows: dict = {}
    for name, (kind, depth, n_iter) in t3_scenarios(study.device,
                                                     quick).items():
        # one DecanTarget carries both analyses: the decremental variants
        # and, through .region()'s run-time-k kernel, the noise sweeps, in
        # one store t3_<name>.jsonl
        target = table3_target(
            f"t3_{name}", kind, depth, n_iter, n=sz["n"],
            width=None if kind == "stream" else sz["width"],
            device=study.device)
        dec = study.run_decan(target, reps=reps)
        rep = study.characterize(ctl, target.region(), ("fp_add", "l1_ld"))
        noise_label = classify(rep.absorptions())
        combined = cross_check_with_decan(noise_label, dec.sat_fp, dec.sat_ls)
        rows[name] = {
            "sat_fp": dec.sat_fp, "sat_ls": dec.sat_ls,
            "decan_scenario": dec.scenario(),
            "abs_fp": rep.results["fp_add"].fit.k1,
            "abs_l1": rep.results["l1_ld"].fit.k1,
            "noise_label": noise_label.label,
            "combined_label": combined.label,
            "expected": T3_EXPECTED[name],
            "t_ref_s": dec.t_ref,
        }
        r = rows[name]
        print(f"  {name:16s} DECAN: Sat_FP={r['sat_fp']:.2f} "
              f"Sat_LS={r['sat_ls']:.2f} -> {r['decan_scenario']:16s} | "
              f"noise: Abs_FP={r['abs_fp']:5.1f} Abs_L1={r['abs_l1']:5.1f} "
              f"-> {r['noise_label']:9s} | combined: {r['combined_label']}",
              flush=True)
    return {**rows, "device": device_label(study.device), "sizes": sz}


# ---------------------------------------------------------------------------
# Fig. 6: combining noise injection with DECAN (the Livermore loop)
# ---------------------------------------------------------------------------

def run_fig6(study: Study, quick: bool = True) -> dict:
    """The loop where the methods disagree: DECAN's FP variant near the
    reference, the noise absorbed in neither mode; combined, DECAN rules
    out full overlap and the verdict is a shared upstream bottleneck."""
    from repro_torch.bench.kernels import livermore_target
    from repro_torch.core.classifier import classify, cross_check_with_decan
    from repro_torch.core.controller import Controller

    banner("Fig 6 — combining noise injection with DECAN (livermore case)")
    sz = FIG6_SIZES[study.device]
    n_iter = sz["n_iter"] if quick else sz["n_iter"] * 5 // 2
    reps = 3 if quick else 5
    target = livermore_target(n_iter, n=sz["n"], width=sz["width"],
                              device=study.device)
    dec = study.run_decan(target, reps=reps)
    ctl = Controller(reps=reps, verify_payload=False)
    rep = study.characterize(ctl, target.region(), ("fp_add", "l1_ld"))
    noise_only = classify(rep.absorptions())
    combined = cross_check_with_decan(noise_only, dec.sat_fp, dec.sat_ls)
    print(f"  DECAN: Sat_FP={dec.sat_fp:.2f} Sat_LS={dec.sat_ls:.2f} "
          f"-> {dec.scenario()}")
    print(f"  noise: {dict((m, round(a, 1)) for m, a in rep.absorptions().items())} "
          f"-> {noise_only.label}")
    print(f"  combined verdict: {combined.label} ({combined.decan_hint})",
          flush=True)
    return {"sat_fp": dec.sat_fp, "sat_ls": dec.sat_ls,
            "abs": rep.absorptions(), "noise_label": noise_only.label,
            "combined_label": combined.label,
            "decan_scenario": dec.scenario(),
            "decan_hint": combined.decan_hint, "t_ref_s": dec.t_ref,
            "device": device_label(study.device), "sizes": sz,
            "n_iter": n_iter}


# ---------------------------------------------------------------------------
# Table 1: the card measured, beside the analytic model
# ---------------------------------------------------------------------------

def kernel_terms(hw, sz: dict, scale: int = 1) -> dict:
    """Per-loop resource seconds under ``hw`` at the shapes fig5 measures
    (the bytes and operations of chip_smoke.py's bounds): STREAM 12 bytes
    and 2 operations an element; lat_mem_rd one dependent 4-byte load a hop
    (8 a iteration) at ``hw``'s latency; HACCmk 8 FP32 operations a chain
    step, 6 chains a lane, its 4-byte lanes read once."""
    from repro_torch.core.analytic import StepTerms

    n = sz["stream_n"] * scale
    stream = StepTerms(compute=2 * n / hw.peak_flops,
                       memory=12 * n / hw.hbm_bw)
    hops = sz["lat_iter"] * scale * 8
    lat = StepTerms(compute=hops / hw.peak_flops,
                    memory=4 * hops / hw.hbm_bw,
                    latency=hops * hw.hbm_latency_s)
    width, it = sz["hacc_width"], sz["hacc_iter"] * scale
    hacc = StepTerms(compute=width * it * 6 * 8 / hw.peak_flops,
                     memory=4 * width / hw.hbm_bw)
    return {"stream": stream, "lat_mem_rd": lat, "haccmk": hacc}


# hbm_stream's base tile moves by this many tiles a call (odd: the bases
# cycle through half the buffer)
STREAM_BASE_STEP = 617


def fresh_calls(name: str, mode, state) -> Callable:
    """k -> aux of ``mode.apply_rt``, called so that the device-memory
    modes' reads are not the L2's lines of the call before (as between the
    steps of a model whose own traffic evicts them): the chase
    (hbm_latency) goes on from where the last call stopped; hbm_stream's
    calls read the buffer from a base tile that moves by
    ``STREAM_BASE_STEP`` tiles a call (each call reads the k tiles
    (j*197) % n_tiles past its base, as the reference's). The other modes:
    ``apply_rt`` on the unchanged state."""
    if name == "hbm_latency":
        box = [state]

        def chase(k):
            aux, box[0] = mode.apply_rt(box[0], k)
            return aux
        return chase
    if name == "hbm_stream":
        buf, tile = state["buf"], state["acc"].shape[0]
        span = max(buf.shape[0] // tile // 2, 1)
        calls = itertools.count()

        def stream(k):
            base = next(calls) * STREAM_BASE_STEP % span
            return mode.apply_rt(dict(state, buf=buf[base * tile:]), k)[0]
        return stream
    return lambda k: mode.apply_rt(state, k)[0]


def pattern_costs(study: Study, ks) -> dict:
    """Each graph-level noise mode's seconds a pattern on ``study.device``
    (the least-squares slope over ``ks`` of the time of its ``apply_rt``,
    called as ``fresh_calls`` calls it), beside
    ``pattern_cost(H100_SXM)``'s per-resource seconds and their largest."""
    import numpy as np
    import torch

    from repro_torch.core.absorption import measure
    from repro_torch.core.noise import make_modes

    out = {}
    for name, mode in make_modes(device=study.device).items():
        state = mode.make_state(torch.Generator().manual_seed(0))
        call = fresh_calls(name, mode, state)
        ts = [measure(call, (k,), reps=5) for k in ks]
        slope = float(np.polyfit(np.asarray(ks, float), np.asarray(ts), 1)[0])
        model = mode.pattern_cost(H100_SXM).time_on(H100_SXM)
        out[name] = {"measured_s": slope, "ts": ts, "ks": list(ks),
                     "model_s": max(model.values()), "model": model}
        print(f"  {name:14s} measured {slope * 1e9:10.3f} ns/pattern, model "
              f"(H100 SXM) {max(model.values()) * 1e9:10.4f} ns", flush=True)
        del state
    return out


def run_table1(study: Study, quick: bool = True) -> dict:
    """The card's row measured (fig5's loops under fp_add, l1_ld, mem_ld),
    its analytic rows (H100 SXM and a DDR-class point) modelled at the same
    shapes, and each graph-level mode's cost a pattern against the model."""
    from repro_torch.bench.kernels import (haccmk_region, lat_mem_rd_region,
                                           stream_region)
    from repro_torch.configs.base import H100_CXL_DDR
    from repro_torch.core.controller import Controller
    from repro_torch.core.noise import make_modes

    banner("Table 1 — cross-system absorption (card measured; analytic)")
    scale = 1 if quick else 2
    sz = FIG5_SIZES[study.device]
    regions = {   # fig5's regions, names and sizes: one store serves both
        "stream": stream_region(n=sz["stream_n"] * scale,
                                device=study.device),
        "lat_mem_rd": lat_mem_rd_region(table_len=sz["lat_table"] * scale,
                                        n_iter=sz["lat_iter"] * scale,
                                        device=study.device),
        "haccmk": haccmk_region(n_iter=sz["hacc_iter"] * scale,
                                width=sz["hacc_width"], device=study.device),
    }
    ctl = Controller(reps=3 if quick else 5, verify_payload=False)
    measured = {}
    for name, region in regions.items():
        rep = study.characterize(ctl, region, ("fp_add", "l1_ld", "mem_ld"))
        a = rep.absorptions()
        measured[name] = {"fp": a["fp_add"], "l1": a["l1_ld"],
                          "mem": a["mem_ld"],
                          "t0_s": rep.results["fp_add"].fit.t0}
    rows = {f"{device_label(study.device)}(measured)": measured}
    modes = make_modes(device=study.device)
    probe = {"fp": modes["fp_add32"], "l1": modes["vmem_ld"],
             "mem": modes["hbm_stream"]}
    for hw in (H100_SXM, H100_CXL_DDR):
        row = {}
        for kname, terms in kernel_terms(hw, sz, scale).items():
            entry = {"t0_s": terms.bound()}
            for short, mode in probe.items():
                fit = study.predict(regions[kname].name,
                                    f"{regions[kname].name}@{hw.name}",
                                    terms, mode, hw)
                entry[short] = min(fit.k1, 1e6)
            row[kname] = entry
        rows[f"{hw.name}(analytic)"] = row
    for sysname, row in rows.items():
        cells = [f"{row[k]['fp']:8.0f}/{row[k]['l1']:7.0f}/{row[k]['mem']:7.0f}"
                 for k in ("stream", "lat_mem_rd", "haccmk")]
        print(f"  {sysname:34s} | " + " | ".join(cells) + "  (fp/l1/mem)")
    print("  cost of a graph-level noise pattern on the device against the "
          "model:", flush=True)
    costs = pattern_costs(study, PATTERN_KS[study.device])
    return {"rows": rows, "pattern_cost": costs,
            "device": device_label(study.device), "sizes": sz}


# ---------------------------------------------------------------------------
# Table 4: HBM-class against DDR-class memory for SPMXV (analytic)
# ---------------------------------------------------------------------------

T4_N = 1 << 21        # rows
T4_NNZ = 16           # per row
T4_MLP = 24           # outstanding misses the memory system can overlap
# name -> (bytes/s, line bytes, latency s). hbm_like: the H100's device
# memory (3.35 TB/s; a miss fetches 32-byte sectors; H100_SXM's
# hbm_latency_s a dependent miss); ddr_like: the reference's.
T4_MEMS = {"hbm_like": (3.35e12, 32, H100_SXM.hbm_latency_s),
           "ddr_like": (256e9, 64, 90e-9)}


def spmxv_terms(q: float, bw: float, line: int, lat: float):
    """SPMXV's resource seconds at swap probability q (the reference's
    model), compute at the H100 SXM's FP32 peak."""
    from repro_torch.core.analytic import StepTerms

    streaming = T4_N * T4_NNZ * 8 + T4_N * 4   # vals+cols stream + y write
    gathers = T4_N * T4_NNZ
    # regular fraction: gathered lines have spatial reuse (banded columns);
    # random fraction q: one full line fetched per useful 4 bytes
    gather_bytes = gathers * ((1 - q) * 4 + q * line)
    return StepTerms(compute=2 * T4_N * T4_NNZ / H100_SXM.peak_flops,
                     memory=(streaming + gather_bytes) / bw,
                     latency=gathers * q * lat / T4_MLP)


def run_table4(study: Study, quick: bool = True) -> dict:
    """SPMXV's modelled GFLOP/s and fp absorption per q on each memory
    class; ``hbm_collapse``: whether the HBM class loses more than twice
    the DDR class's share of its q=0 rate by q=0.5 (the paper's finding)."""
    from repro_torch.configs.base import HardwareConfig
    from repro_torch.core.noise import make_modes

    del quick
    banner("Table 4 — HBM-class vs DDR-class for SPMXV (analytic, per q)")
    fp = make_modes(device=study.device)["fp_add32"]
    rows: dict = {}
    for q in (0.0, 0.25, 0.5):
        row = {}
        for mname, (bw, line, lat) in T4_MEMS.items():
            hw = HardwareConfig(name=mname, hbm_bw=bw, hbm_latency_s=lat)
            t = spmxv_terms(q, bw, line, lat)
            fit = study.predict("table4_spmxv", f"spmxv_q{q}@{mname}", t, fp,
                                hw)
            row[mname] = {"gflops": 2 * T4_N * T4_NNZ / t.bound() / 1e9,
                          "abs_fp": min(fit.k1, 1e9), "dominant": t.dominant}
        rows[q] = row
        print("  q=%.2f | " % q + " | ".join(
            f"{m}: {r['gflops']:9.1f} GF abs={r['abs_fp']:8.0f} "
            f"{r['dominant'][:4]}" for m, r in row.items()), flush=True)
    r0, r5 = rows[0.0], rows[0.5]
    hbm_collapse = (r5["hbm_like"]["gflops"] / r0["hbm_like"]["gflops"]
                    < 0.5 * r5["ddr_like"]["gflops"] / r0["ddr_like"]["gflops"])
    print(f"  HBM-class collapses under random access (paper's finding): "
          f"{hbm_collapse}")
    return {"rows": {str(k): v for k, v in rows.items()},
            "hbm_collapse": bool(hbm_collapse),
            "mems": {m: {"bw": bw, "line": line, "latency_s": lat}
                     for m, (bw, line, lat) in T4_MEMS.items()}}


STUDIES = {"fig7": ("fig7_spmxv", run_fig7), "fig5": ("fig5_hwchar", run_fig5),
           "fig4": ("fig4_matmul", run_fig4),
           "table3": ("table3_decan", run_table3),
           "fig6": ("fig6_overlap", run_fig6),
           "table1": ("table1_systems", run_table1),
           "table4": ("table4_memsys", run_table4)}
# the studies whose reference has a --pallas arm
PALLAS_STUDIES = ("fig7", "fig4")


def write_stats(out_dir: str, name: str) -> None:
    """The process's kernel launches, beside the study's result."""
    from repro_torch.kernels.region import launch_counts

    with open(os.path.join(out_dir, f"{name}.stats.json"), "w") as f:
        json.dump({"launches": launch_counts()}, f)


def main(argv=None) -> int:
    """``python -m repro_torch.bench STUDY``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench",
        description="the paper's Fig. 7 (SPMXV), Fig. 5 (STREAM, "
                    "lat_mem_rd, HACCmk), Fig. 4 (matmul -O0/-O3), Table 3 "
                    "and Fig. 6 (DECAN and noise), Table 1 and Table 4 "
                    "(the analytic model) on the port's kernels")
    ap.add_argument("study", choices=sorted(STUDIES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default: the kernels on the card) or cpu "
                         "(their plain versions, at smoke sizes)")
    ap.add_argument("--full", action="store_true",
                    help="the reference's full grids and doubled sizes")
    ap.add_argument("--pallas", action="store_true",
                    help="fig7: also run the q-study on the ELL SPMV "
                         "kernel; fig4: the fp/vmem study on the tiled "
                         "matmul kernel (the other studies have none)")
    ap.add_argument("--store-dir", default=None,
                    help="keep every sweep in a campaign store here (one "
                         "file per region); a second run replays them")
    ap.add_argument("--out", default=OUT_DIR,
                    help=f"where the JSON result goes (default {OUT_DIR})")
    ap.add_argument("--expect-no-measure", action="store_true",
                    help="exit non-zero if any sweep point was measured "
                         "(with --store-dir: a complete store replays)")
    args = ap.parse_args(argv)
    if args.pallas and args.study not in PALLAS_STUDIES:
        ap.error(f"--pallas: {args.study} has no Pallas-kernel arm (only "
                 f"{' and '.join(PALLAS_STUDIES)} do)")
    study = Study(args.device, args.store_dir)
    name, run = STUDIES[args.study]
    t0 = time.perf_counter()
    if args.study in PALLAS_STUDIES:
        out = run(study, quick=not args.full, pallas=args.pallas)
    else:
        out = run(study, quick=not args.full)
    out["points"] = {"measured": study.stats.measured,
                     "replayed": study.stats.cached}
    path = save(args.out, name, out)
    write_stats(args.out, name)
    print(f"[{args.study}: {study.stats.measured} points measured, "
          f"{study.stats.cached} replayed from store; "
          f"{time.perf_counter() - t0:.1f} s] -> {path}")
    if args.expect_no_measure and (study.stats.measured
                                   or not args.store_dir):
        print(f"expected no measurement, but {study.stats.measured} "
              "point(s) were measured")
        return 1
    return 0
