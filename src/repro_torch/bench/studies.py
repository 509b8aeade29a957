"""The paper's Fig. 7 (SPMXV), Fig. 5 (STREAM, lat_mem_rd, HACCmk) and
Fig. 4 (matmul -O0 / -O3) studies on the port's loop regions: the
counterparts of the reference's ``benchmarks/fig7_spmxv.py``,
``fig5_hwchar.py`` and ``fig4_matmul.py``, with the same JSON structure
(fig7's ``findings``, fig5's ``signatures``, fig4's ``signature_flip``).

    PYTHONPATH=src python -m repro_torch.bench fig7 [--device cuda|cpu] \\
        [--full] [--pallas] [--store-dir D] [--out DIR] [--expect-no-measure]
    PYTHONPATH=src python -m repro_torch.bench fig5 [...]
    PYTHONPATH=src python -m repro_torch.bench fig4 [...]

``--device cuda`` (the default) measures the CUDA loop kernels on the card;
sizes are the card's (below). ``--device cpu`` runs the plain PyTorch
versions at smoke sizes: it checks the path, and its times say nothing
about any device.

With ``--store-dir`` every characterization is a resumable campaign (one
store per region, as ``benchmarks/common.py:characterize`` keeps them): a
second run replays the sweeps and measures 0 points
(``--expect-no-measure`` fails the run otherwise). The GFLOP/s of fig7
come from a fresh k=0 timing in every run, as in the reference.

Sizes on the card, against the reference's host sizes:
  fig7: small n=2^17 (vals, cols, x, y: 17 MB, inside the 50 MB L2, the
        cache-resident matrix the paper intends) and large n=2^21 (285 MB,
        5x the L2); L=16, 64 rows an iteration — the reference's sizes;
  fig5: STREAM n=2^25 (3 x 128 MiB; the reference's 2^22 x 3 x 4 B = 48 MiB
        would sit in the L2); lat_mem_rd a 2^26-entry table (256 MiB, so
        the chase misses the L2; the reference's 2^22 is 16 MiB), 1024
        iterations; HACCmk 60,000 iterations at width 135,168 (1,024 lanes
        on each of the 132 SMs; the reference's width 8 would occupy 8
        threads of one SM). ``--full`` doubles them as the reference's does;
  fig4: n=192, the reference's (one block of 192 threads: the study is
        about register discipline in one loop, not about filling the card).

Each run writes ``<out>/<study>.json`` and, beside it, ``<study>.stats.json``
with the process's kernel launches ({kernel: [CUDA, plain]}).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

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

        os.makedirs(self.store_dir, exist_ok=True)
        return characterize_region(
            region, modes, controller=ctl, stats=self.stats,
            store=os.path.join(self.store_dir, f"{region.name}.jsonl"))


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

def run_fig4(study: Study, quick: bool = True) -> dict:
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
    return {"rows": rows, "signature_flip": bool(flip),
            "device": device_label(study.device), "n": n}


STUDIES = {"fig7": ("fig7_spmxv", run_fig7), "fig5": ("fig5_hwchar", run_fig5),
           "fig4": ("fig4_matmul", run_fig4)}


def write_stats(out_dir: str, name: str) -> None:
    """The process's kernel launches, beside the study's result."""
    from repro_torch.kernels.region import launch_counts

    with open(os.path.join(out_dir, f"{name}.stats.json"), "w") as f:
        json.dump({"launches": launch_counts()}, f)


def main(argv=None) -> int:
    """``python -m repro_torch.bench {fig7,fig5}``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench",
        description="the paper's Fig. 7 (SPMXV), Fig. 5 (STREAM, "
                    "lat_mem_rd, HACCmk) and Fig. 4 (matmul -O0/-O3) "
                    "studies on the port's loop kernels")
    ap.add_argument("study", choices=sorted(STUDIES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default: the kernels on the card) or cpu "
                         "(their plain versions, at smoke sizes)")
    ap.add_argument("--full", action="store_true",
                    help="the reference's full grids and doubled sizes")
    ap.add_argument("--pallas", action="store_true",
                    help="fig7: also run the q-study on the ELL SPMV kernel")
    ap.add_argument("--store-dir", default=None,
                    help="keep every sweep in a campaign store here (one "
                         "file per region); a second run replays them")
    ap.add_argument("--out", default=OUT_DIR,
                    help=f"where the JSON result goes (default {OUT_DIR})")
    ap.add_argument("--expect-no-measure", action="store_true",
                    help="exit non-zero if any sweep point was measured "
                         "(with --store-dir: a complete store replays)")
    args = ap.parse_args(argv)
    study = Study(args.device, args.store_dir)
    name, run = STUDIES[args.study]
    t0 = time.perf_counter()
    if args.study == "fig7":
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
