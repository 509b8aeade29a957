"""The paper's tool pointed at the port's own training step: inject noise
beside a (reduced) gemma train step, measure absorption, verify the payload
survived, classify the bottleneck — then predict the same architecture's
full-scale cell (gemma-2b train_4k on a 16 x 16 mesh of H100 SXM cards)
from the port's own dry-run record.

    PYTHONPATH=src python examples/torch_probe_train_step.py              # card
    PYTHONPATH=src python examples/torch_probe_train_step.py --device cpu

The measured half is the reference's (``examples/probe_train_step.py``):
gemma-2b's smoke config, seq 128 x batch 4, the forward loss as the step,
``make_modes(NoiseScale(mxu_dim=64, hbm_mib=16, chase_len=2^18))``, 3 reps;
on the card mxu_dim is the mxu kernel's fixed 128 (``MXU_DIM``).

The analytic half carries no TPU figure. Its step terms (Tc, Tm, Ti) come
from the dry-run record ``<--dryrun-dir>/gemma_2b_train_4k.json``, read
by ``repro_torch.launch.probe.analytic_probe`` (the function behind
``python -m repro_torch.launch.probe --analytic``) on ``H100_SXM``'s
data-sheet peaks. Without the record, the cell is traced first through
``repro_torch.launch.dryrun.run_cell`` on the host (about 21 s on a
CPU); the record it writes is read on every later run. The closing line is
read off those terms and the predicted label.
"""
import argparse
import json
import os

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.classifier import classify
from repro_torch.core.injector import probe_step
from repro_torch.core.noise import NoiseScale, make_modes
from repro_torch.kernels.graph_noise.kernel import MXU_DIM
from repro_torch.kernels.region import resolve_device
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.probe import analytic_probe
from repro_torch.models.model import build

MODES = ("fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream")
ARCH, SHAPE = "gemma_2b", "train_4k"


def measured(*, device="cuda", seq=128, batch=4, reps=3) -> dict:
    """The measured half: {mode: StepProbe} over the four modes on the
    smoke train step (params from seed 0), each printed with its payload;
    then the classification."""
    api = build(get_smoke_config(ARCH))
    params = api.init(0, device)
    data = api.dummy_batch(ShapeConfig("probe", "train", seq, batch),
                           device=device)
    # the card's mxu pattern is its kernel's 128 x 128 bf16 tile
    mxu_dim = MXU_DIM if torch.device(device).type == "cuda" else 64
    modes = make_modes(NoiseScale(mxu_dim=mxu_dim, hbm_mib=16,
                                  chase_len=1 << 18), device=device)
    print(f"== measured ({device}, reduced config, seq {seq} x batch "
          f"{batch}) ==", flush=True)
    probes = {}
    for name in MODES:
        pr = probe_step(lambda p, b: api.loss(p, b)[0], (params, data),
                        modes[name], reps=reps)
        probes[name] = pr
        print(f"  {name:12s} Abs^raw={pr.fit.k1:7.1f}  "
              f"payload={pr.injection.payload}/{pr.injection.expected} "
              f"overhead={pr.injection.overhead_fraction:.0%}", flush=True)
    print(" ", classify({m: pr.fit.k1 for m, pr in probes.items()}))
    return probes


def dryrun_record(dryrun_dir: str) -> str:
    """The path of the 16 x 16 train_4k record under ``dryrun_dir``,
    traced on the host first when it is absent."""
    path = os.path.join(dryrun_dir, f"{ARCH}_{SHAPE}.json")
    if not os.path.exists(path):
        out_dir, mesh = os.path.split(os.path.normpath(dryrun_dir))
        if mesh != "16x16":
            raise SystemExit(f"no record {path}, and {dryrun_dir} is not a "
                             "16x16 directory to trace it into")
        print(f"   no record at {path}: tracing the cell on the host "
              "(repro_torch.launch.dryrun)", flush=True)
        run_cell(ARCH, SHAPE, multi_pod=False, out_dir=out_dir)
    return path


def analytic(dryrun_dir: str, *, store=None):
    """The analytic half: the four modes predicted from the record's terms
    on the H100 SXM (through the probe's ``--analytic`` route); returns
    (RegionReport, the record's roofline dict)."""
    print("\n== analytic (full gemma-2b train_4k on 16 x 16 H100 SXM) ==")
    with open(dryrun_record(dryrun_dir)) as f:
        roof = json.load(f)["roofline"]
    rep, _ = analytic_probe(ARCH, SHAPE, dryrun_dir, list(MODES), tol=0.05,
                            store=store)
    return rep, roof


def reading(rep, roof: dict) -> str:
    """The closing line, from the record's terms and the predicted share
    of the step each mode's noise can occupy before it shows."""
    share = rep.bottleneck.absorptions
    most = max(share, key=share.get)
    return (f"The {roof['dominant']} term dominates the full-scale cell "
            f"(Tc={roof['t_compute'] * 1e3:.1f} ms, "
            f"Tm={roof['t_memory'] * 1e3:.1f} ms, "
            f"Ti={roof['t_ici'] * 1e3:.1f} ms) -> predicted "
            f"[{rep.bottleneck.label}]; most absorbed: {most} "
            f"({share[most]:.1f}% of the step).")


def main(argv=None):
    """Parse the flags, run both halves, print the closing line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): the step and noise on the card; "
                         "cpu: on the CPU")
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length of the measured step")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size of the measured step")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions a point")
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch/16x16",
                    help="where the dry-run records live (the probe's "
                         "--analytic default)")
    ap.add_argument("--store", default=None,
                    help="the predictions' campaign store (default: the "
                         "probe's, under experiments/campaigns/)")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: refuse, never the CPU
    probes = measured(device=args.device, seq=args.seq, batch=args.batch,
                      reps=args.reps)
    rep, roof = analytic(args.dryrun_dir, store=args.store)
    print("\n" + reading(rep, roof))
    return probes, rep


if __name__ == "__main__":
    main()
