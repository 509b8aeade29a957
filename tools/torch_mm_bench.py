"""Fig. 4's two loop matmuls (``mm_o3_kernel``, ``mm_o0_kernel``,
``csrc/loop_regions.cu``) on the card at the main path's size (n = 192:
-O3 3,072 iterations, -O0 768). It prints

* the registers and spills of every ``mm_o3_kernel`` and ``mm_o0_kernel``
  instance of the run-time library (``nvcc -Xptxas -v``) and, for their
  clean static builds and their run-time instances without noise and
  under fp_add, each innermost loop's SASS opcodes, and each clean build's
  per iteration (its deepest loop over the checkout's trip,
  ``MM_O3_UNROLL``, 1 for -O0 and where the checkout has none); the SASS
  is written whole under ``--out``;
* -O3's warp-issue floor (``chip_smoke.o3_issue_floor``: 16 FADD/FMUL a
  warp and iteration at the card's highest SM clock, for the checkout's
  block, ``MM_O3_THREADS``, 256 where it has none);
* in device ms, ``--readings`` readings in turns (each a mean of 25
  calls): each matmul's clean build and its row (fp_add's run-time build
  at k = 0, as the sweeps time t(0) and phase 6 its row);
* unless ``--quick``: phase 6's noise-slot readings of ``chip_smoke.py``
  (``_slot_ms``) in device and event ms for both: the clean build, every
  loop mode's run-time build at k = 0 and k = 8;
* with ``--fig4 N``: the Fig. 4 study N times (``studies.run_fig4``, what
  ``python -m repro_torch.bench fig4`` runs, here on the library built for
  this tool): each row's Abs values and label, and ``signature_flip``,

then one ``MM {json}`` line with every number and the card's name and
power limit. Run from a checkout's root on a machine with a card:

    python3 tools/torch_mm_bench.py [--src DIR] [--fig4 N] [--quick]
                                    [--readings R] [--out DIR] [--build-only]

``--src``: the ``src`` directory of the checkout to measure (default: this
checkout's), so that one call can time a parent and a change with the same
script: build both (``--build-only``, started together), then time them in
turns. Only ``loop_regions.cu`` is built, into ``build/mm_bench/`` beside
that ``src`` (``torch_triad_bench.load_tree``).
"""
import argparse
import collections
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_liv_bench import innermost_loops  # noqa: E402
from torch_triad_bench import ROOT, load_tree  # noqa: E402

SOURCES = ("loop_regions",)
N = 192
# (label, library, base name, mangled-tail prefix) of the instances read
# (a run-time call at k = 0 launches the <MODE, 0> instance where the
# checkout has one, ``fp_add rt k0``)
SASS_FNS = (("o3 clean", "static", "mm_o3_kernel", "ILi0ELi0E"),
            ("o3 none rt", "rt", "mm_o3_kernel", "ILi0ELin1E"),
            ("o3 fp_add rt", "rt", "mm_o3_kernel", "ILi1ELin1E"),
            ("o3 fp_add rt k0", "rt", "mm_o3_kernel", "ILi1ELi0E"),
            ("o0 clean", "static", "mm_o0_kernel", "ILi0ELi0E"),
            ("o0 none rt", "rt", "mm_o0_kernel", "ILi0ELin1E"),
            ("o0 fp_add rt", "rt", "mm_o0_kernel", "ILi1ELin1E"),
            ("o0 fp_add rt k0", "rt", "mm_o0_kernel", "ILi1ELi0E"))


def _sass(_build, lref, out_dir: str) -> dict:
    """{label: {"registers", "loops": [...], "instructions"}} of SASS_FNS,
    each clean build's deepest loop per iteration; the SASS written to
    ``out_dir``."""
    from repro_torch.core.payload import BOOKKEEPING, census_op
    from repro_torch.sass.parse import parse_sass, select

    unroll = {"mm_o3_kernel": getattr(lref, "MM_O3_UNROLL", 1),
              "mm_o0_kernel": 1}
    usage = _build.ptxas_usage("loop_regions")
    texts = {"rt": _build.sass_dump(_build.runtime_lib_path()),
             "static": _build.sass_dump(
                 _build.static_lib_path("loop_regions", 0, 0))}
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for label, lib, base, tail in SASS_FNS:
        text = select(texts[lib], ((base, tail),))
        if not text.strip():
            continue
        with open(os.path.join(out_dir, label.replace(" ", "_") + ".sass"),
                  "w") as f:
            f.write(text)
        (fn,) = parse_sass(text).values()
        loops = []
        for lo, hi, ops in innermost_loops(fn):
            work = sum(n for op, n in ops.items()
                       if census_op(op) not in BOOKKEEPING)
            loops.append({"addr": [hex(lo), hex(hi)], "work": work,
                          "ops": dict(ops.most_common())})
            print(f"{label}: innermost loop {hex(lo)}-{hex(hi)}: {work} "
                  f"instructions but branches: "
                  + ", ".join(f"{o} {n}" for o, n in ops.most_common()),
                  flush=True)
        row = {"instructions": len(fn.instrs), "loops": loops,
               "registers": {name: u for name, u in usage.items()
                             if base in name}}
        if label.endswith("clean"):
            u = unroll[base]
            deepest = max(i.depth for i in fn.instrs)
            body = collections.Counter(
                i.opcode for i in fn.instrs if i.depth == deepest)
            work = sum(n for op, n in body.items()
                       if census_op(op) not in BOOKKEEPING)
            row["per_iteration"] = {"deepest_loop": work, "unroll": u,
                                    "body": work / u,
                                    "ops": {o: n / u for o, n in body.items()}}
            print(f"{label}: the deepest loop holds {work} instructions but "
                  f"branches for {u} iteration(s): {work / u:g} an "
                  "iteration: " + ", ".join(
                      f"{o} {n / u:g}" for o, n in body.most_common()),
                  flush=True)
        out[label] = row
    for name, u in sorted(usage.items()):
        if "mm_o3_kernel" in name or "mm_o0_kernel" in name:
            print(f"  ptxas {name}: {u[0]} registers, spills {u[1]}/{u[2]}")
    return out


def _in_turns(cs, regions: dict, readings: int) -> dict:
    """{name: [device ms] * readings} of each region's clean build and row
    (fp_add's run-time build at k = 0), read in turns, with the medians."""
    from functools import partial

    fns = {}
    for name, region in regions.items():
        fns[f"{name} clean"] = partial(region.build("", 0),
                                       *region.args_for("", 0))
        fns[f"{name} row"] = partial(region.build_rt("fp_add"), 0,
                                     *region.args_for_rt("fp_add"))
    out = {name: [] for name in fns}
    for _ in range(readings):
        for name, fn in fns.items():
            out[name].append(cs.device_ms(fn)[0])
    out["median"] = {name: statistics.median(out[name]) for name in fns}
    print("device ms in turns (median [min, max]): " + "; ".join(
        f"{name} {out['median'][name]!r} [{min(out[name])!r}, "
        f"{max(out[name])!r}]" for name in fns), flush=True)
    return out


def _fig4(times: int) -> list:
    """The Fig. 4 study ``times`` times, each on the card without a store."""
    from repro_torch.bench.studies import Study, run_fig4

    runs = []
    for _ in range(times):
        res = run_fig4(Study("cuda", None))
        runs.append({"rows": res.get("rows"),
                     "signature_flip": res.get("signature_flip")})
        print("FIG4 " + json.dumps(runs[-1]), flush=True)
    return runs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the checkout to measure")
    ap.add_argument("--fig4", type=int, default=0,
                    help="run the Fig. 4 study this many times")
    ap.add_argument("--readings", type=int, default=5,
                    help="device readings of each build, in turns")
    ap.add_argument("--quick", action="store_true",
                    help="skip the noise-slot readings")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mm_bench",
                                                  "sass"),
                    help="where the SASS files go")
    ap.add_argument("--build-only", action="store_true",
                    help="build loop_regions.cu and stop")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    _build = load_tree(src, SOURCES, os.path.join(
        os.path.dirname(src), "build", "mm_bench"))
    _build.runtime_lib()
    _build.static_build("loop_regions", 0, 0)
    if args.build_only:
        print(f"built {SOURCES} for {src}", flush=True)
        return

    import chip_smoke as cs

    from repro_torch.bench.kernels import matmul_region
    from repro_torch.kernels.loop_regions import ref as lref

    card = cs.card_line()
    print(f"{src}: {card}", flush=True)
    threads = getattr(lref, "MM_O3_THREADS", lref.THREADS)
    floor = cs.o3_issue_floor(N, 16 * N, threads, cs.sm_clock_mhz())
    print(f"matmul_O3 warp-issue floor ({threads}-thread blocks): "
          f"{floor['formula']} = {floor['ms']!r} ms", flush=True)
    result = {"src": src, "card": card, "n": N, "o3_threads": threads,
              "warp_issue_floor": floor,
              "sass": _sass(_build, lref, os.path.join(
                  args.out, os.path.basename(os.path.dirname(src)) or "tree"))}
    regions = {"matmul_O3": matmul_region(n=N, optimized=True),
               "matmul_O0": matmul_region(n=N)}
    result["readings"] = _in_turns(cs, regions, args.readings)
    row = result["readings"]["median"]["matmul_O3 row"]
    print(f"matmul_O3 row: {row!r} ms, {floor['ms'] / row!r} of the "
          "warp-issue floor", flush=True)
    if not args.quick:
        result["slot_ms"] = {}
        for name, region in regions.items():
            slot = cs._slot_ms(region, name, device=True, static=False)
            result["slot_ms"][name] = slot
            print(f"{name}: run-time k=0 over clean (device ms): "
                  + cs.slot_costs(slot), flush=True)
    if args.fig4:
        result["fig4"] = _fig4(args.fig4)
    print("MM " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
