"""The graph-noise emitters ``gfp_kernel`` (fp_add32), ``gmxu_kernel``
(mxu_fma128), ``gvmem_kernel`` (vmem_ld) and ``gstream_kernel``
(hbm_stream) of ``csrc/graph_noise.cu`` on the card at its noise scale
(``core.noise.CARD_SCALE``: fp on (8, 128) f32, four blocks; vmem_ld's
(64, 128) buffer, four blocks; m and c 128 x 128 bf16; a (256, 128) f32
tile from a 256 MiB buffer). It prints

* the registers and spills of each kernel's instances (``nvcc -Xptxas
  -v``) and, in the run-time instances, each pattern loop's SASS opcodes
  (the innermost loops that hold the pattern instruction, FADD, HGMMA or
  HMMA, LDS or LDG), their instructions a pattern and any integer-division
  opcodes in them (MUFU.RCP, I2F, F2I, IMAD.HI; the SASS is written whole
  under ``--out``);
* each mode's floor a pattern (``chip_smoke.graph_floor_us``: fp 2 and
  vmem 8 SM clocks, mxu's one-SM tensor-core 1,024 clocks at the card's
  highest SM clock; hbm_stream's bytes bound, 131,072 B at 3.35 TB/s);
* in device ms, ``chip_smoke.TARGET_READINGS`` readings in turns (each a
  mean of 25 calls) of each mode's ``apply_rt`` at every k of
  ``chip_smoke.GRAPH_KS`` (0, 64, 128, 256, 512), called as
  ``studies.fresh_calls`` calls it and read by phase 6's own
  ``chip_smoke.graph_readings``, each (mode, k) held once bitwise to its
  plain version; the k = 0 call, the medians' slope over k in {0, 128,
  256, 512} (µs a pattern) and its share of the floor;
* the host's cost of one call at k = 0 (``chip_smoke.host_ms``, and
  1,000 calls back to back over 1,000);
* 64 chained ``torch.matmul(m, c)`` in bf16 in one CUDA graph
  (``chip_smoke.mxu_library_graph``), by events and on the device, when
  mxu_fma128 is read;
* unless ``--quick``: ``studies.pattern_costs`` (the host-clock slope the
  Table 1 study reads) for the modes read,

then one ``GRAPH {json}`` line with every number and the card's name and
power limit. ``--build-times K,K,...`` instead times the static builds of
the modes' emitters at those k (``_build.static_build``, nvcc end to end,
all started together) and prints one ``GRAPH_BUILD {json}`` line. Run
from a checkout's root on a machine with a card:

    python3 tools/torch_graph_bench.py [--src DIR] [--modes M,M,...]
                                       [--quick] [--out DIR] [--build-only]
                                       [--build-times K,K,...]

``--src``: the ``src`` directory of the checkout to measure (default: this
checkout's), so that one call can time a parent and a change with the same
script: build both (``--build-only``, started together), then time them in
turns, a process a tree (parent, change, change, parent). Only
``graph_noise.cu`` is built, into ``build/graph_bench/`` beside that
``src`` (``torch_triad_bench.load_tree``). A variant (another ring) is a
copy of ``src/`` with the ``#define`` changed, passed as ``--src``.
``--modes``: the modes to read (default: all four).
"""
import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_liv_bench import innermost_loops  # noqa: E402
from torch_triad_bench import ROOT, load_tree  # noqa: E402

SOURCES = ("graph_noise",)
MODES = ("fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream")
KERNELS = {"fp_add32": "gfp_kernel", "mxu_fma128": "gmxu_kernel",
           "vmem_ld": "gvmem_kernel", "hbm_stream": "gstream_kernel"}
# a pattern's instruction in SASS, and how many of it a pattern issues
PATTERN_OPS = {"fp_add32": (("FADD",), 1), "mxu_fma128": (("HGMMA", "HMMA"), 8),
               "vmem_ld": (("LDS",), 1), "hbm_stream": (("LDG",), 1)}
# what an integer division or modulo leaves in SASS (the card has no
# divider: a reciprocal through the float pipe and a high multiply)
DIVISION_OPS = ("MUFU.RCP", "I2F", "F2I", "IMAD.HI")


def _sass(_build, out_dir: str, modes) -> dict:
    """{mode: {"registers", "loops"}}: ptxas's registers and spills of each
    kernel's instances, and the run-time instance's loops that hold its
    pattern instruction (their instructions a pattern and division
    opcodes); the SASS written to ``out_dir``."""
    from repro_torch.sass.parse import parse_sass, select

    usage = _build.ptxas_usage("graph_noise")
    text = _build.sass_dump(_build.runtime_lib_path())
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for mode in modes:
        base = KERNELS[mode]
        sel = select(text, ((base, "ILin1E"),))
        with open(os.path.join(out_dir, base + "_rt.sass"), "w") as f:
            f.write(sel)
        (fn,) = parse_sass(sel).values()
        ops_of, per = PATTERN_OPS[mode]
        loops = []
        for lo, hi, ops in innermost_loops(fn):
            n_op = sum(n for o, n in ops.items() if o.split(".")[0] in ops_of)
            if not n_op:
                continue
            division = {o: n for o, n in ops.items()
                        if o.startswith(DIVISION_OPS)}
            patterns = n_op / per
            loops.append({"addr": [hex(lo), hex(hi)],
                          "instructions": sum(ops.values()),
                          "patterns": patterns,
                          "per_pattern": sum(ops.values()) / patterns,
                          "division_ops": division,
                          "ops": dict(ops.most_common())})
            print(f"{base}: pattern loop {hex(lo)}-{hex(hi)}: "
                  f"{sum(ops.values())} instructions for {patterns:g} "
                  f"patterns ({sum(ops.values()) / patterns:.2f} a pattern; "
                  f"division opcodes {division or 'none'}): " + ", ".join(
                      f"{o} {n}" for o, n in ops.most_common()), flush=True)
        regs = {name: u for name, u in usage.items() if base in name}
        for name, u in sorted(regs.items()):
            print(f"  ptxas {name}: {u[0]} registers, spills {u[1]}/{u[2]}",
                  flush=True)
        out[mode] = {"registers": regs, "instructions": len(fn.instrs),
                     "loops": loops}
    return out


def _calls(names) -> dict:
    """mode -> (k -> aux, the mode, its state): ``apply_rt`` as
    ``studies.fresh_calls`` calls it, on the card's seed-0 state."""
    import torch

    from repro_torch.bench.studies import fresh_calls
    from repro_torch.core.noise import make_modes

    modes = make_modes(device="cuda")
    out = {}
    for name in names:
        state = modes[name].make_state(torch.Generator().manual_seed(0))
        out[name] = (fresh_calls(name, modes[name], state), modes[name],
                     state)
    return out


def _parity(calls: dict, ks) -> dict:
    """{mode: {k: bitwise}}: one run-time call of each (mode, k) on the
    state against its plain version."""
    import torch

    def leaves(v):
        return v if isinstance(v, tuple) else (v,)

    out = {}
    for name, (_, mode, state) in calls.items():
        out[name] = {}
        for k in ks:
            aux, new = mode.apply_rt(state, k)
            paux, pnew = mode.apply_rt(state, k, plain=True)
            out[name][k] = bool(torch.equal(aux, paux) and all(
                torch.equal(a, b) for key in new
                for a, b in zip(leaves(new[key]), leaves(pnew[key]))))
    print(f"bitwise against the plain version: {out}", flush=True)
    return out


def _in_turns(cs, calls: dict) -> dict:
    """``chip_smoke.graph_readings`` of both modes, printed."""
    out = cs.graph_readings({name: call for name, (call, _, _)
                             in calls.items()})
    for name, got in out.items():
        print(f"{name}: device ms in turns (median [min, max]): " + "; ".join(
            f"k={k} {got['median'][k]!r} [{min(v)!r}, {max(v)!r}]"
            for k, v in got["readings"].items())
              + f"; {got['device_us_per_pattern']!r} us a pattern",
              flush=True)
    return out


def _host(cs, call, n: int = 1000) -> dict:
    """The host's cost of one call at k = 0, µs: ``chip_smoke.host_ms`` (a
    call and a synchronize, median), and ``n`` calls back to back, then one
    synchronize, over n (the wrapper's dispatch where it outlasts the
    kernel)."""
    import torch

    one = cs.host_ms(partial(call, 0), reps=200) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call(0)
    torch.cuda.synchronize()
    return {"call_and_sync_us": one,
            "back_to_back_us": (time.perf_counter() - t0) * 1e6 / n}


def _build_times(_build, ks, modes) -> dict:
    """{mode: {k: seconds}} of the static builds of the modes' emitters at
    each k, all started together."""
    from repro_torch.kernels.graph_noise.kernel import MODE_IDS

    jobs = [(mode, k) for mode in modes for k in ks]

    def build(job):
        t0 = time.perf_counter()
        _build.static_build("graph_noise", MODE_IDS[job[0]], job[1])
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        secs = list(pool.map(build, jobs))
    out = {mode: {} for mode in modes}
    for (mode, k), sec in zip(jobs, secs):
        out[mode][k] = sec
        print(f"static build of {KERNELS[mode]} at k={k}: {sec:.1f} s",
              flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the checkout to measure")
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated modes to read (default: all four)")
    ap.add_argument("--quick", action="store_true",
                    help="skip studies.pattern_costs")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "graph_bench", "sass"),
                    help="where the SASS files go")
    ap.add_argument("--build-only", action="store_true",
                    help="build graph_noise.cu and stop")
    ap.add_argument("--build-times", default="",
                    help="comma-separated static k: time the modes' "
                         "static builds at each and stop")
    args = ap.parse_args(argv)
    modes = [m for m in args.modes.split(",") if m]
    unknown = set(modes) - set(MODES)
    if unknown:
        ap.error(f"unknown modes {sorted(unknown)}; of {list(MODES)}")
    src = os.path.abspath(args.src)
    _build = load_tree(src, SOURCES, os.path.join(
        os.path.dirname(src), "build", "graph_bench"))
    if args.build_times:
        ks = [int(k) for k in args.build_times.split(",") if k]
        print("GRAPH_BUILD " + json.dumps(
            {"src": src, "seconds": _build_times(_build, ks, modes)}),
              flush=True)
        return
    _build.runtime_lib()
    if args.build_only:
        print(f"built {SOURCES} for {src}", flush=True)
        return

    import chip_smoke as cs

    card = cs.card_line()
    mhz = cs.sm_clock_mhz()
    print(f"{src}: {card}", flush=True)
    calls = _calls(modes)
    floors = {}
    for name, (_, _, state) in calls.items():
        per, what = cs.graph_floor_us(name, state, mhz)
        floors[name] = per
        print(f"{name}: {what}: {per!r} us a pattern (SM clock {mhz:g} "
              "MHz)", flush=True)
    result = {"src": src, "card": card, "sm_clock_mhz": mhz,
              "floor_us_per_pattern": floors,
              "sass": _sass(_build, os.path.join(
                  args.out, os.path.basename(os.path.dirname(src)) or "tree"),
                  modes),
              "bitwise": _parity(calls, cs.GRAPH_KS)}
    result["readings"] = _in_turns(cs, calls)
    for name, per in floors.items():
        got = result["readings"][name]
        slope = got["device_us_per_pattern"]
        got["floor_share"] = per / slope if slope else None
        print(f"{name}: k=0 {got['median'][0]!r} ms, row k={cs.GRAPH_ROW_K} "
              f"{got['median'][cs.GRAPH_ROW_K]!r} ms, {slope!r} us a "
              f"pattern, {got['floor_share']!r} of its floor", flush=True)
    result["host"] = {name: _host(cs, call) for name, (call, _, _)
                      in calls.items()}
    print(f"host clock at k=0 (µs a call): {result['host']}", flush=True)
    if "mxu_fma128" in calls:
        state = calls["mxu_fma128"][2]
        lib = cs.mxu_library_graph(state["m"], state["c"], cs.GRAPH_ROW_K)
        result["library"] = {"what": f"{cs.GRAPH_ROW_K} chained "
                                     "torch.matmul(m, c), bf16, one CUDA "
                                     "graph",
                             "event_ms": cs.time_ms(lib),
                             "device_ms": cs.device_ms(lib)[0]}
        print(f"library: {result['library']}", flush=True)
    if not args.quick:
        from repro_torch.bench.studies import Study, pattern_costs

        costs = pattern_costs(Study("cuda", None), cs.GRAPH_SLOPE_KS)
        result["pattern_costs"] = {name: costs[name] for name in modes}
    print("GRAPH " + json.dumps(result, default=str), flush=True)


if __name__ == "__main__":
    main()
