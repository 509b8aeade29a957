"""Multi-pod dry-run: trace every (architecture x input shape) cell's
per-rank program on the production meshes and extract memory / cost /
roofline evidence, on any host, allocating nothing on any device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all                 # 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod     # 2x16x16

PyTorch port of the reference's ``repro.launch.dryrun``. Where the
reference lowers and compiles the cell on 512 forced host devices and
parses the optimized HLO, the port runs rank 0's per-rank program
(``launch/steps.py``) on meta tensors, over a fake process group of 256
or 512 ranks (``parallel/fake.py``), under a dispatch mode that records
every op (``roofline/trace.py``). Outputs one JSON per cell under
``<out>/<mesh>/`` with:

  memory     - per-rank bytes: argument (the rank's state, params and
               cache shards and its batch rows), alias (the donated state
               it updates in place), output (the results' new bytes),
               temp (the trace's peak of live bytes the program creates;
               the results are among them at the end), and
               generated_code_size_in_bytes null (there is none)
  cost       - the trace's product FLOPs and HBM bytes, and the elements
               of its transcendental ops
  roofline   - FLOPs / HBM traffic / wire bytes of the per-rank program
               and the three terms in seconds, on the H100 SXM's data-sheet
               peaks (predictions)
  collectives are the roofline's ``collective_breakdown``

The hardware is ``H100_SXM`` and ``n_chips`` the fake world's size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

_DOC = __doc__

# element-wise ops of transcendental functions (cost["transcendentals"])
TRANSCENDENTAL = frozenset({
    "aten.exp.default", "aten.log.default", "aten.tanh.default",
    "aten.sigmoid.default", "aten.rsqrt.default", "aten.sqrt.default",
    "aten.sin.default", "aten.cos.default", "aten.pow.Tensor_Scalar",
    "aten.erf.default", "aten._softmax.default", "aten.logsumexp.default",
    "aten.silu.default", "aten.gelu.default", "aten._log_softmax.default",
    "aten.log1p.default", "aten.expm1.default", "aten.softplus.default",
})


def trace_program(prog):
    """Run ``prog.fn(*prog.args)`` under an ``OpTrace``; returns (the
    trace, the memory dict, the cost dict)."""
    from repro_torch.roofline.terms import dot_flops, traffic_bytes
    from repro_torch.roofline.trace import OpTrace, tensor_bytes

    with OpTrace() as trace:
        out = prog.fn(*prog.args)
    memory = {"argument_size_in_bytes": prog.argument_bytes,
              "output_size_in_bytes": tensor_bytes(out, exclude=prog.args),
              "temp_size_in_bytes": trace.peak_bytes,
              "alias_size_in_bytes": prog.alias_bytes,
              "generated_code_size_in_bytes": None}
    del out
    cost = {"flops": dot_flops(trace.ops),
            "bytes accessed": traffic_bytes(trace.ops),
            "transcendentals": float(sum(
                sum(int(torch.Size(t.shape).numel()) for t in r.outputs)
                for r in trace.ops if r.name in TRANSCENDENTAL))}
    return trace, memory, cost


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = "experiments/dryrun_torch",
             compress: str | None = None,
             overrides: dict | None = None,
             remat: str = "nothing",
             tag: str = "", verbose: bool = True) -> dict:
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.configs.base import H100_SXM
    from repro_torch.launch.mesh import make_production_mesh, mesh_config
    from repro_torch.launch.steps import SkipCell, build_cell
    from repro_torch.parallel.fake import fake_world
    from repro_torch.roofline.terms import analyze_trace

    mesh_name = "2x16x16" if multi_pod else "16x16"
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cell_id = f"{arch}_{shape_name}{('_' + tag) if tag else ''}"
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "tag": tag}

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record.update(status="skip", reason=reason)
        _write(out_dir, mesh_name, cell_id, record)
        if verbose:
            print(f"SKIP {cell_id} [{mesh_name}]: {reason}")
        return record

    n_chips = mesh_config(multi_pod=multi_pod).n_devices
    t0 = time.time()
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            prog = build_cell(arch, shape_name, mesh, compress=compress,
                              overrides=overrides, remat=remat)
            trace, mem, cost = trace_program(prog)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        rep = analyze_trace(trace.ops, arch=arch, shape=shape,
                            mesh_name=mesh_name, n_chips=n_chips,
                            hw=H100_SXM, cfg=cfg, memory_stats=mem)
        record.update(
            status="ok",
            kind=prog.kind,
            compile_s=time.time() - t0,
            memory=mem,
            cost=cost,
            roofline=dataclasses.asdict(rep),
            hardware=H100_SXM.name,
            n_ops=len(trace.ops),
        )
        if verbose:
            m = record["memory"]
            print(f"OK   {cell_id} [{mesh_name}] "
                  f"trace={record['compile_s']:.1f}s "
                  f"args={m['argument_size_in_bytes']/2**30:.2f}GiB "
                  f"temp={m['temp_size_in_bytes']/2**30:.2f}GiB "
                  f"out={m['output_size_in_bytes']/2**30:.2f}GiB")
            print("     " + rep.summary())
    except SkipCell as e:
        record.update(status="skip", reason=str(e))
        if verbose:
            print(f"SKIP {cell_id} [{mesh_name}]: {e}")
    except Exception as e:
        record.update(status="fail", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"FAIL {cell_id} [{mesh_name}]: {type(e).__name__}: {e}")
    _write(out_dir, mesh_name, cell_id, record)
    return record


def _write(out_dir: str, mesh_name: str, cell_id: str, record: dict) -> None:
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{cell_id}.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=_DOC,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--compress", default=None, choices=(None, "int8"))
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, SHAPES, canonical

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells.append((canonical(args.arch), args.shape))

    n_ok = n_skip = n_fail = 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                       out_dir=args.out, compress=args.compress,
                       tag=args.tag)
        n_ok += rec["status"] == "ok"
        n_skip += rec["status"] == "skip"
        n_fail += rec["status"] == "fail"
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skip, {n_fail} fail")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
