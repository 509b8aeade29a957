"""STREAM's label, read again and again: the quickstart's STREAM
characterization (``examples/torch_quickstart.py``: its ``MODES`` over
``stream_region`` under ``Controller(reps=3)``) run ``--runs`` times at
n = 2^22 (the quickstart's size) and as many times at n = 2^25 (the main
path's). Prints each run's label and each mode's Abs^raw and t(0), the
labels counted at each size, then one ``LABELS {json}`` line with every
reading and the card's name and power limit. Run from a checkout's root on
a machine with a card:

    python3 tools/torch_stream_labels.py [--src DIR] [--runs 5]
                                         [--sizes 2^22,2^25] [--warps W]
                                         [--build-only]

``--src``: the ``src`` directory of the checkout to measure (default: this
checkout's), so that one call reads a parent and a change with the same
script. Only ``loop_regions.cu`` is built, into ``build/stream_labels/``
beside that ``src``. ``--warps``: STREAM's grouping, set as
``tools/torch_triad_bench.py:set_grouping`` sets it (default: the
checkout's own). The payload check is left out
(``verify_payload=False``): a label is read off the timings alone, and the
check's static build at each sweep's last k would cost a build a run.
"""
import argparse
import collections
import json
import os
import subprocess
import sys

from torch_triad_bench import load_tree, own_grouping, set_grouping

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"2^22": 1 << 22, "2^25": 1 << 25}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the checkout to read")
    ap.add_argument("--runs", type=int, default=5,
                    help="characterizations at each size")
    ap.add_argument("--sizes", default=",".join(SIZES),
                    help="comma-separated sizes, of " + ", ".join(SIZES))
    ap.add_argument("--warps", type=int, default=0,
                    help="STREAM's grouping (default: the checkout's own)")
    ap.add_argument("--build-only", action="store_true",
                    help="build loop_regions.cu and stop")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    _build = load_tree(src, ("loop_regions",), os.path.join(
        os.path.dirname(src), "build", "stream_labels"))
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    _build.runtime_lib()
    if args.build_only:
        print(f"built loop_regions for {src}", flush=True)
        return

    from torch_quickstart import MODES

    from repro_torch.bench.kernels import stream_region
    from repro_torch.core.controller import Controller

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.warps:
        set_grouping(args.warps)
    warps = own_grouping()
    print(f"{src}: {card}; {warps} warps", flush=True)
    ctl = Controller(reps=3, verify_payload=False)
    runs = {}
    for size in args.sizes.split(","):
        n = SIZES[size]
        target = stream_region(n=n)
        runs[size] = []
        for r in range(args.runs):
            rep = ctl.characterize(target, modes=MODES)
            run = {"label": rep.bottleneck.label,
                   "abs_raw": rep.absorptions(),
                   "t0_ms": {m: res.fit.t0 * 1e3
                             for m, res in rep.results.items()}}
            runs[size].append(run)
            print(f"n={size} run {r}: {run['label']} "
                  + " ".join(f"{m}={a:g}" for m, a in run["abs_raw"].items())
                  + " t0_ms=" + " ".join(f"{t:.4f}"
                                         for t in run["t0_ms"].values()),
                  flush=True)
        print(f"n={size}: labels "
              f"{dict(collections.Counter(r['label'] for r in runs[size]))}",
              flush=True)
    print("LABELS " + json.dumps({"src": src, "card": card, "warps": warps,
                                  "runs": runs}),
          flush=True)


if __name__ == "__main__":
    main()
