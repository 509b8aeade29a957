"""Fig. 6's Livermore loop (``liv_kernel``, ``csrc/decan_loops.cu``) on the
card at the main path's size (n = 2^18, 60,000 iterations, 135,168
threads). It prints

* the registers and spills of every ``liv_kernel`` instance of the
  run-time library (``nvcc -Xptxas -v``) and, for the clean static build
  and the run-time instances (the ref, fp and ls variants; fp_add), each
  innermost loop's SASS opcodes, and the clean build's per iteration (its
  innermost loop over the checkout's unroll, ``LIV_UNROLL``, 1 where the
  checkout has none); the SASS is written whole under ``--out``;
* in device ms, ``--readings`` readings in turns (each a mean of 25
  calls): the ref, FP-only and LS-only variants, as the DECAN study times
  them, and the row (fp_add's run-time build at k = 0, as the sweeps time
  t(0) and phase 6 its row);
* unless ``--quick``: phase 6's noise-slot readings of ``chip_smoke.py``
  (``_slot_ms``) in device and event ms: the clean build, every loop
  mode's run-time build at k = 0 and k = 8, the row against the clean
  build in turns;
* with ``--fig6 N``: the Fig. 6 study N times (``studies.run_fig6``, what
  ``python -m repro_torch.bench fig6`` runs, here on the library built
  for this tool): Sat_FP, Sat_LS, the DECAN scenario, the Abs values and
  the labels,

then one ``LIV {json}`` line with every number and the card's name and
power limit. Run from a checkout's root on a machine with a card:

    python3 tools/torch_liv_bench.py [--src DIR] [--fig6 N] [--quick]
                                     [--readings R] [--out DIR]
                                     [--build-only]

``--src``: the ``src`` directory of the checkout to measure (default: this
checkout's), so that one call can time a parent and a change with the same
script: build both (``--build-only``, started together), then time them in
turns. Only ``decan_loops.cu`` is built, into ``build/liv_bench/`` beside
that ``src`` (``torch_triad_bench.load_tree``).
"""
import argparse
import collections
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_triad_bench import ROOT, load_tree  # noqa: E402

SOURCES = ("decan_loops",)
N, N_ITER, WIDTH = 2 ** 18, 60_000, 132 * 1024
# (label, library, mangled-tail prefix) of the liv_kernel instances read
SASS_FNS = (("clean", "static", "ILb1ELb1ELi0ELi0E"),
            ("ref none rt", "rt", "ILb1ELb1ELi0ELin1E"),
            ("fp none rt", "rt", "ILb1ELb0ELi0ELin1E"),
            ("ls none rt", "rt", "ILb0ELb1ELi0ELin1E"),
            ("ref fp_add rt", "rt", "ILb1ELb1ELi1ELin1E"))


def innermost_loops(fn) -> list:
    """[(first address, last address, Counter of opcodes)] of the loops
    of a parsed SASS function that hold no other loop (a loop: a backward
    branch and the addresses from its target to it)."""
    loops = []
    for ins in fn.instrs:
        tgt = ins.target
        if ins.op != "BRA" or tgt is None:
            continue
        addr = int(tgt, 16) if tgt.startswith("0x") else fn.labels.get(tgt)
        if addr is not None and addr < ins.addr:
            loops.append((addr, ins.addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                        for a, b in loops)]
    return [(lo, hi, collections.Counter(i.opcode for i in fn.instrs
                                         if lo <= i.addr <= hi))
            for lo, hi in sorted(inner)]


def _sass(_build, dref, out_dir: str) -> dict:
    """{label: {"registers", "loops": [...], "instructions"}} of SASS_FNS,
    with the clean build's innermost loop per iteration; the SASS written
    to ``out_dir``."""
    from repro_torch.core.payload import BOOKKEEPING, census_op
    from repro_torch.sass.parse import parse_sass, select

    unroll = getattr(dref, "LIV_UNROLL", 1)
    usage = _build.ptxas_usage("decan_loops")
    texts = {"rt": _build.sass_dump(_build.runtime_lib_path()),
             "static": _build.sass_dump(
                 _build.static_lib_path("decan_loops", 0, 0))}
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for label, lib, tail in SASS_FNS:
        text = select(texts[lib], (("liv_kernel", tail),))
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
                             if "liv_kernel" in name}}
        if label == "clean":
            deepest = max(i.depth for i in fn.instrs)
            body = collections.Counter(
                i.opcode for i in fn.instrs if i.depth == deepest)
            work = sum(n for op, n in body.items()
                       if census_op(op) not in BOOKKEEPING)
            row["per_iteration"] = {"deepest_loop": work, "unroll": unroll,
                                    "body": work / unroll,
                                    "ops": {o: n / unroll
                                            for o, n in body.items()}}
            print(f"clean: the deepest loop holds {work} instructions but "
                  f"branches for {unroll} iteration(s): {work / unroll:g} "
                  "an iteration: " + ", ".join(
                      f"{o} {n / unroll:g}" for o, n in body.most_common()),
                  flush=True)
        out[label] = row
    for name, u in sorted(usage.items()):
        if "liv_kernel" in name:
            print(f"  ptxas {name}: {u[0]} registers, spills {u[1]}/{u[2]}")
    return out


def _variants_in_turns(cs, target, readings: int) -> dict:
    """{name: [device ms] * readings}, the ref, fp and ls variants (the
    run-time library without noise) and the row (fp_add's run-time build
    at k = 0), read in turns, with their medians."""
    from functools import partial

    region = target.region()
    args = target.args_for()
    fns = {name: partial(target.build(fp, ls), *args)
           for name, (fp, ls) in (("ref", (True, True)),
                                  ("fp", (True, False)),
                                  ("ls", (False, True)))}
    fns["row"] = partial(region.build_rt("fp_add"), 0,
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


def _fig6(times: int) -> list:
    """The Fig. 6 study ``times`` times, each on the card without a store."""
    from repro_torch.bench.studies import Study, run_fig6

    keys = ("sat_fp", "sat_ls", "decan_scenario", "abs", "noise_label",
            "combined_label", "t_ref_s")
    runs = []
    for _ in range(times):
        res = run_fig6(Study("cuda", None))
        runs.append({k: res.get(k) for k in keys})
        print("FIG6 " + json.dumps(runs[-1]), flush=True)
    return runs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the checkout to measure")
    ap.add_argument("--fig6", type=int, default=0,
                    help="run the Fig. 6 study this many times")
    ap.add_argument("--readings", type=int, default=5,
                    help="device readings of each variant, in turns")
    ap.add_argument("--quick", action="store_true",
                    help="skip the noise-slot readings")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "liv_bench",
                                                  "sass"),
                    help="where the SASS files go")
    ap.add_argument("--build-only", action="store_true",
                    help="build decan_loops.cu and stop")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    _build = load_tree(src, SOURCES, os.path.join(
        os.path.dirname(src), "build", "liv_bench"))
    _build.runtime_lib()
    _build.static_build("decan_loops", 0, 0)
    if args.build_only:
        print(f"built {SOURCES} for {src}", flush=True)
        return

    import chip_smoke as cs

    from repro_torch.bench.kernels import livermore_target
    from repro_torch.kernels.decan_loops import ref as dref

    card = cs.card_line()
    print(f"{src}: {card}", flush=True)
    result = {"src": src, "card": card, "sizes": {"n": N, "n_iter": N_ITER,
                                                  "width": WIDTH},
              "sass": _sass(_build, dref, os.path.join(
                  args.out, os.path.basename(os.path.dirname(src)) or "tree"))}
    target = livermore_target(N_ITER, n=N, width=WIDTH)
    result["variants"] = _variants_in_turns(cs, target, args.readings)
    if not args.quick:
        result["slot_ms"] = cs._slot_ms(target.region(), "decan_livermore",
                                        device=True, static=False)
    if args.fig6:
        result["fig6"] = _fig6(args.fig6)
    print("LIV " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
