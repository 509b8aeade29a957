"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --steps 200 --seq 128 --batch 16 [--device cuda|cpu]

PyTorch port of the reference's ``repro.launch.train``, with its flags and
``--device``: it trains on the card by default (and refuses to run without
one) or on the CPU when asked. ``--smoke`` takes the reduced same-family
config; without it the full config trains on one card, from random weights
drawn on the device from the seed. Fault tolerance: checkpoints land in
``--ckpt-dir`` every ``--ckpt-every`` steps, and a rerun with the same
flags resumes from the latest one. ``--compress int8`` without a mesh runs
as the reference's does (no axis to reduce over).

``--mesh single|multi`` trains on the production mesh (16×16 or 2×16×16,
``launch/mesh.py``), one process a device, started e.g. by ``torchrun
--nproc-per-node``: the process group is made from torchrun's environment
(NCCL on the card, gloo on the CPU). With fewer ranks than the mesh needs
it exits with the reference's ``ValueError`` message.

Reference fault: rerun after the last step (a checkpoint at or past
``--steps``), the reference's ``hist[-1]`` raises ``IndexError``; here the
run says so in one line and exits non-zero.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import tempfile
from typing import Optional, Sequence

NOTHING_TO_RUN = ("nothing to train: resumed at step {start} of --steps "
                  "{steps} (the reference fails here with IndexError on "
                  "hist[-1]; ROADMAP queue 3)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", default=None, choices=(None, "int8"))
    ap.add_argument("--mesh", default="none",
                    choices=("none", "single", "multi"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--task", default="lcg", choices=("lcg", "uniform"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) needs a card; cpu runs the "
                         "same path on the CPU")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> list[dict]:
    args = build_parser().parse_args(argv)

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import (ShapeConfig, TrainConfig, get_config,
                                     get_smoke_config)
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.kernels.region import resolve_device
    from repro_torch.models.model import build
    from repro_torch.train.trainer import Trainer

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    mesh = None
    if args.mesh != "none":
        try:
            mesh = _production_mesh(args.mesh == "multi", dev)
        except ValueError as e:
            raise SystemExit(str(e))
        if dev.type == "cuda":      # this rank's card
            import torch
            dev = torch.device("cuda", torch.cuda.current_device())
    logging.basicConfig(level=logging.INFO)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = build(cfg)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_train_ckpt")
    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir)
    pipe = SyntheticPipeline(cfg, shape, task=args.task, device=dev)
    ckpt = CheckpointManager(tcfg.ckpt_dir) if args.ckpt_every else None
    trainer = Trainer(api, tcfg, mesh=mesh, compress=args.compress,
                      ckpt_manager=ckpt, device=dev)

    state = trainer.init_state()
    shapes = [s for n, s in state.layout.shapes.items()
              if n.startswith("params/")] if mesh is not None else \
        [p.shape for p in state.params.parameters()]
    n_params = sum(math.prod(s) for s in shapes)
    where = "" if mesh is None else f" mesh={tuple(mesh.shape)}"
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"tokens/step={args.batch * args.seq} device={dev}{where}")
    start = 0
    if ckpt is not None and ckpt.steps():
        state, start = ckpt.restore_latest(like=state)
        print(f"resumed from checkpoint step {start}")

    state, hist = trainer.run(state, pipe, steps=args.steps,
                              start_step=start)
    if not hist:
        raise SystemExit(NOTHING_TO_RUN.format(start=start,
                                               steps=args.steps))
    for h in hist:
        if h["step"] % args.log_every == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:5d} loss={h['loss']:.4f} "
                  f"gnorm={h['grad_norm']:.3f} lr={h['lr']:.2e} "
                  f"wall={h['wall_s']*1e3:.0f}ms")
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(first: {hist[0]['loss']:.4f})")
    return hist


def _production_mesh(multi_pod: bool, dev):
    """The production mesh over this process's world: the default process
    group is made from torchrun's environment when it is set (NCCL on the
    card, gloo on the CPU); a lone process is a world of one."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_production_mesh(multi_pod=multi_pod, device_type=dev.type)


if __name__ == "__main__":
    main()
