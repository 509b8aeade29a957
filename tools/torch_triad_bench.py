"""The two STREAM triad kernels on the card at the main path's sizes:
``stream_kernel`` (``csrc/loop_regions.cu``; n = 2^25, chunk 512) and
``t3_kernel``'s data-bound scenario (``csrc/decan_loops.cu``; N = 2^25,
depth 4), under several groupings (the number of warps that walk the
65,536 chunks, ``--warps``). It prints

* the registers and spills of their run-time instances (``nvcc -Xptxas
  -v``) and an opcode count of their SASS, which it writes whole under
  ``--out``;
* at each grouping, phase 6's noise-slot readings of ``chip_smoke.py``
  (``_slot_ms``) in device and event ms: the clean build, every loop mode's
  run-time build at k = 0 and k = 8, and the targets' readings in turns
  (the clean build, fp_add's run-time build at k = 0, ``torch.add(a, b,
  alpha=3)``),

then one ``TRIAD {json}`` line with every number and the card's name and
power limit. Run from a checkout's root on a machine with a card:

    python3 tools/torch_triad_bench.py [--src DIR] [--warps W,W,...]
                                       [--out DIR] [--build-only]

``--src``: the ``src`` directory of the checkout to measure (default: this
checkout's), so that one call can time a parent and a change with the same
script: build both (``--build-only``, started together), then time them in
turns. Only ``loop_regions.cu`` and ``decan_loops.cu`` are built, into
``build/triad_bench/`` beside that ``src``. ``--warps``: the groupings
(default: the checkout's own); each is set as the checkout's grid-stride
constant (``set_grouping``), which the plain versions follow too.
"""
import argparse
import collections
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2 ** 25
SOURCES = ("loop_regions", "decan_loops")
T3_DEMANGLED = "t3_kernel<(int)1, (bool)1, (bool)1"
# (label, source, base name, mangled-tail prefix) of the instances read
SASS_FNS = (("stream clean", "static", "stream_kernel", "ILi0ELi0E"),
            ("stream none rt", "rt", "stream_kernel", "ILi0ELin1E"),
            ("stream fp_add rt", "rt", "stream_kernel", "ILi1ELin1E"),
            ("t3 none rt", "rt", "t3_kernel", "ILi1ELb1ELb1ELi0ELin1E"),
            ("t3 fp_add rt", "rt", "t3_kernel", "ILi1ELb1ELb1ELi1ELin1E"))


def load_tree(src: str, sources: tuple, build_dir: str):
    """Import the checkout at ``src`` (its ``repro_torch``) building only
    ``sources`` into ``build_dir``; returns its ``_build``. A checkout
    without ``_build.use_sources`` has the two names set directly."""
    sys.path[:0] = [src, ROOT]
    from repro_torch.kernels import _build

    if hasattr(_build, "use_sources"):
        _build.use_sources(sources, build_dir)
    else:
        _build.KERNEL_SOURCES, _build.BUILD_DIR = sources, build_dir
    return _build


def set_grouping(warps: int) -> None:
    """Walk the triads' chunks with ``warps`` warps, in the kernels'
    wrappers and in their plain versions (the checkout's ``N_WARPS_MAX``,
    which SPMXV's wrapper reads too)."""
    from repro_torch.kernels.loop_regions import ref as lref

    lref.N_WARPS_MAX = warps


def own_grouping() -> int:
    from repro_torch.kernels.loop_regions import ref as lref

    return lref.N_WARPS_MAX


def _sass(_build, out_dir: str) -> dict:
    """{label: {"registers": {...}, "instructions": n, "ops": {opcode:
    count}}} of SASS_FNS; their SASS written to ``out_dir``."""
    from repro_torch.sass.parse import select

    usage = {}
    for source in SOURCES:
        usage.update(_build.ptxas_usage(source))
    texts = {"rt": _build.sass_dump(_build.runtime_lib_path()),
             "static": _build.sass_dump(
                 _build.static_lib_path("loop_regions", 0, 0))}
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    op_re = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    for label, lib, base, tail in SASS_FNS:
        text = select(texts[lib], ((base, tail),))
        with open(os.path.join(out_dir, label.replace(" ", "_") + ".sass"),
                  "w") as f:
            f.write(text)
        ops = collections.Counter(m.group(1) for m in map(op_re.match,
                                                          text.splitlines())
                                  if m)
        want = T3_DEMANGLED if base == "t3_kernel" else base
        regs = {name: u for name, u in usage.items()
                if want in name and ("-1>" in name) == (lib == "rt")}
        out[label] = {"registers": regs, "instructions": sum(ops.values()),
                      "ops": dict(ops.most_common())}
        print(f"{label}: {sum(ops.values())} SASS instructions; "
              + ", ".join(f"{o} {n}" for o, n in ops.most_common()
                          if o.startswith(("LDG", "STG", "BRA", "I2F", "MUFU",
                                           "IMAD.HI", "FMUL", "FADD",
                                           "BAR", "ATOM", "RED"))),
              flush=True)
    for name, u in sorted(usage.items()):
        if "stream_kernel" in name or T3_DEMANGLED in name:
            print(f"  ptxas {name}: {u[0]} registers, spills {u[1]}/{u[2]}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the checkout to measure")
    ap.add_argument("--warps", default="",
                    help="comma-separated groupings (default: the "
                         "checkout's own)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "triad_bench", "sass"),
                    help="where the SASS files go")
    ap.add_argument("--build-only", action="store_true",
                    help="build the two sources and stop")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    _build = load_tree(src, SOURCES, os.path.join(
        os.path.dirname(src), "build", "triad_bench"))
    with ThreadPoolExecutor(max_workers=2) as pool:
        for job in [pool.submit(_build.runtime_lib),
                    pool.submit(_build.static_build, "loop_regions", 0, 0)]:
            job.result()
    if args.build_only:
        print(f"built {SOURCES} for {src}", flush=True)
        return

    import chip_smoke as cs

    from repro_torch.bench.kernels import stream_region, table3_target
    from repro_torch.kernels.decan_loops import ref as dref

    card = cs.card_line()
    print(f"{src}: {card}", flush=True)
    result = {"src": src, "card": card,
              "sass": _sass(_build, os.path.join(
                  args.out, os.path.basename(os.path.dirname(src)) or "tree")),
              "groupings": {}}
    n_iter = N // dref.CHUNK
    stream = stream_region(n=N)
    t3 = table3_target("t3_data-bound", "stream", 4, n_iter, n=N).region()
    warps = [int(w) for w in args.warps.split(",") if w] or [own_grouping()]
    for w in warps:
        set_grouping(w)
        print(f"== {w} warps ({n_iter / w:g} chunks a warp)", flush=True)
        result["groupings"][w] = {
            "stream_triad": cs._slot_ms(stream, "stream_triad", device=True,
                                        static=False),
            "decan_table3": cs._slot_ms(t3, "decan_table3", device=True,
                                        static=False)}
    print("TRIAD " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
