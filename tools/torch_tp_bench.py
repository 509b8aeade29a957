"""The mesh training step of ``chip_smoke.py``'s phase 12 (gemma-2b at
full width, 2 of its 18 layers, bf16 with f32 masters, one batch of 4 x
512 tokens, ``TrainConfig(warmup_steps=1)``) on W cards, one NCCL rank a
card, on each (data, model) mesh of ``--shapes``: its step seconds and
the peak memory a rank, so that a parent and a change can be timed in
turns in one call. For each shape it prints a ``TP`` line of JSON:

* ``step_s``: the wall seconds of each of ``--steps`` steps after one
  warm-up step (NCCL's first collectives), each ended by a
  ``torch.cuda.synchronize()``, and their median;
* ``peak_bytes``: ``torch.cuda.max_memory_allocated`` over the timed
  steps, the largest of the ranks (the state and batch included);
* ``state_bytes``: the state a rank holds (its shards);
* ``loss``: the warm-up step's loss (the same batch and seed in every
  tree, so the trees' losses agree within bf16);

with the card's name and power limit. Run from a checkout's root on a
machine with ``max(W)`` cards:

    python3 tools/torch_tp_bench.py [--src DIR] [--shapes 1x4,4x1]
                                    [--steps N] [--device cpu]

``--src``: the ``src`` directory of the checkout to measure (default:
this checkout's), a process a tree, e.g. parent, change, change, parent.
``--device cpu`` runs gloo ranks at gemma-2b's smoke config instead (a
check of the tool, no timing worth keeping).
"""
import argparse
import dataclasses
import json
import math
import multiprocessing as mp
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, LAYERS, BATCH, SEQ = "gemma_2b", 2, 4, 512
GROUP_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 900


def _rank(rank: int, world: int, args: dict, tmp: str) -> None:
    sys.path.insert(0, args["src"])
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.configs import (MeshConfig, ShapeConfig, TrainConfig,
                                     get_config, get_smoke_config)
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models.model import build
    from repro_torch.parallel.sharding import make_mesh_from_config
    from repro_torch.train import Trainer

    cpu = args["device"] == "cpu"
    if cpu:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        cfg = get_smoke_config(ARCH)
    else:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
        cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    dist.init_process_group(
        "gloo" if cpu else "nccl",
        store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    api = build(cfg)
    batch = SyntheticPipeline(cfg, ShapeConfig("tp", "train", SEQ, BATCH),
                              task="lcg", device=dev).batch(0)
    out = {}
    for shape in args["shapes"]:
        mesh = make_mesh_from_config(MeshConfig(shape, ("data", "model")))
        trainer = Trainer(api, TrainConfig(warmup_steps=1), mesh=mesh,
                          device=dev)
        state = trainer.init_state()
        sync()
        state, metrics = trainer._step(state, batch)
        loss = float(metrics["loss"])
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(args["steps"]):
            sync()
            t0 = time.perf_counter()
            state, metrics = trainer._step(state, batch)
            sync()
            times.append(time.perf_counter() - t0)
        peak = torch.tensor([0 if cpu else torch.cuda.max_memory_allocated()],
                            dtype=torch.float64, device=dev)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        out["x".join(map(str, shape))] = {
            "step_s": times, "median_step_s": statistics.median(times),
            "peak_bytes": int(peak.item()),
            "state_bytes": sum(t.numel() * t.element_size()
                               for t in state.tensors().values()),
            "loss": loss}
        del state, trainer
        if not cpu:
            torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(tmp, "rank0.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--shapes", default="1x4,4x1")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    shapes = [tuple(int(x) for x in s.split("x")) for s in a.shapes.split(",")]
    world = max(math.prod(s) for s in shapes)
    args = {"src": os.path.abspath(a.src), "shapes": shapes,
            "steps": a.steps, "device": a.device}
    if a.device == "cpu":
        card = "cpu"
    else:
        sys.path.insert(0, ROOT)
        import chip_smoke as cs

        card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, world, args, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise SystemExit(f"ranks exited {codes}")
        with open(os.path.join(tmp, "rank0.json")) as f:
            res = json.load(f)
    for shape, rec in res.items():
        print("TP " + json.dumps(dict(rec, shape=shape, world=world,
                                      src=args["src"], card=card)),
              flush=True)


if __name__ == "__main__":
    main()
