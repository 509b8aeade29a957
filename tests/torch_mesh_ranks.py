"""The port's side of the mesh tests: ranks of a ``gloo`` process group on
the CPU, one process each, started by ``spawn``.

The rank processes import torch, numpy and the port only (not the test
modules, which import JAX). Each rank joins the group through a
``FileStore`` under the test's own directory (no fixed port: the test
processes run side by side), runs one target of this module and saves its
result with ``torch.save``. ``spawn`` joins every rank within a hard
timeout: a rank still alive then is killed and the test fails, so a
collective that two ranks disagree on cannot hang the suite.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import traceback

import numpy as np
import torch

JOIN_TIMEOUT_S = 120
# the reference's side (tests/torch_mesh_ref.py), by name
TCFG = dict(lr=1e-3, warmup_steps=1)
ICI_K = 3


def _entry(rank: int, world: int, tmp: str, target: str, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world)
        result = globals()[target](rank, world, args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(world: int, target: str, args, tmp: str,
          timeout: float = JOIN_TIMEOUT_S) -> list:
    """Run ``target(rank, world, args)`` on ``world`` gloo ranks; their
    results in rank order. Raises AssertionError if a rank fails or is
    still running after ``timeout`` seconds (every rank is then killed)."""
    import time

    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, tmp, target, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {}
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            errors[r] = open(path).read()
    assert not hung, f"{target}: ranks {hung} still ran after {timeout} s " \
                     f"and were killed; errors: {errors}"
    assert not errors and all(p.exitcode == 0 for p in procs), \
        f"{target} failed: {errors or [p.exitcode for p in procs]}"
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

def f32_smoke(arch: str):
    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke_config(arch),
                               param_dtype="float32", compute_dtype="float32")


def _mesh(shape, axes):
    from repro_torch.configs import MeshConfig
    from repro_torch.parallel.sharding import make_mesh_from_config

    return make_mesh_from_config(MeshConfig(tuple(shape), tuple(axes)))


def _fresh_state(cfg, params_np, compress):
    from repro_torch.convert import params_to_torch
    from repro_torch.train import TrainState, adamw_init, init_residuals

    params = params_to_torch(cfg, params_np)
    return TrainState(params=params, opt=adamw_init(params),
                      residuals=init_residuals(params) if compress else None)


def _gathered(state) -> dict:
    """Every tensor of a sharded state, gathered, as numpy."""
    return {n: state.layout.gather(n, t).numpy().copy()
            for n, t in state.tensors().items()}


def _local_balance_loss(api, state, batch, n_groups):
    """The mean over ranks of each rank's OWN balance loss (no reduction
    over the batch axes): what a per-rank loss would report."""
    import torch.distributed as dist

    from repro_torch.train.trainer import gather_params

    full = gather_params(state.params, state.layout)
    with torch.no_grad():
        _, aux = api.loss(full, batch, n_groups=n_groups)
    lb = aux["moe_lb_loss"].clone()
    dist.all_reduce(lb)
    return float(lb) / dist.get_world_size()


def train_steps(rank: int, world: int, args: dict) -> dict:
    """One mesh step of each (arch, compress, mesh) case of this world from
    the reference's params; the gathered state and metrics on rank 0. At
    world 4, a checkpoint of the (2, 2) gemma-2b step's state."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import TrainConfig
    from repro_torch.models.model import build
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.trainer import (batch_shardings, make_train_step,
                                           shard_state)

    out = {}
    for arch, inputs in args["archs"].items():
        cfg = f32_smoke(arch)
        api = build(cfg)
        batch = {k: torch.from_numpy(v.copy())
                 for k, v in inputs["batch"].items()}
        for compress in (None, "int8"):
            for shape in args["meshes"]:
                mesh = _mesh(shape, ("data", "model"))
                state = shard_state(api, _fresh_state(
                    cfg, inputs["params"], compress), mesh)
                rec = {}
                if cfg.n_experts and compress is None:
                    bspec = batch_shardings(mesh, batch)["tokens"]
                    local = {k: sh.local_shard(v, bspec, mesh)
                             for k, v in batch.items()}
                    rec["per_rank_lb"] = _local_balance_loss(api, state,
                                                             local, 1)
                step = make_train_step(api, TrainConfig(**TCFG), mesh=mesh,
                                       compress=compress)
                state, metrics = step(state, batch)
                rec.update(state=_gathered(state),
                           metrics={k: float(v) for k, v in metrics.items()},
                           local_bytes=sum(t.numel() * t.element_size()
                                           for t in state.tensors().values()))
                if args.get("ckpt") and arch == "gemma-2b" \
                        and compress is None and tuple(shape) == (2, 2):
                    CheckpointManager(args["ckpt"]).save(1, state)
                out[(arch, compress, tuple(shape))] = rec
    for (shape, axes), case in args.get("cpsum", {}).items():
        out[("cpsum", shape, axes)] = _cpsum(shape, axes, case)
    return out if rank == 0 else {k: v for k, v in out.items()
                                  if k[0] == "cpsum"}


def _cpsum(shape, axes, case) -> dict:
    """The compressed psum with this rank's own block of every gradient
    and residual (its rows of the stacked per-device arrays)."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.grad_compression import make_compressed_psum

    mesh = _mesh(shape, axes)
    spec = sh.P(tuple(axes) if len(axes) > 1 else axes[0])

    def mine(tree):
        return {k: sh.local_shard(torch.from_numpy(v.copy()), spec,
                                  mesh).clone() for k, v in tree.items()}

    mean, new_r = make_compressed_psum(axes, mesh=mesh)(mine(case["g"]),
                                                       mine(case["r"]))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = sh.mesh_axis_sizes(mesh)
    return {"index": sh._index(coord, axes, sizes),
            "mean": {k: v.numpy() for k, v in mean.items()},
            "new_r": {k: v.numpy() for k, v in new_r.items()}}


def resume(rank: int, world: int, args: dict) -> dict:
    """Restore the world-4 checkpoint into a fresh state sharded on this
    world's (world, 1) mesh (rank 0 returns it gathered); then the
    trainer's restart path on that mesh: a failure at step 3 restores the
    step-2 checkpoint and replays."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models.model import build
    from repro_torch.train import Trainer
    from repro_torch.train.trainer import shard_state

    cfg = f32_smoke("gemma-2b")
    api = build(cfg)
    mesh = _mesh((world, 1), ("data", "model"))
    like = shard_state(api, _fresh_state(cfg, args["params"], None), mesh)
    CheckpointManager(args["ckpt"]).restore(1, like=like)
    out = {"restored": _gathered(like)}

    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, ckpt_every=2)
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", "train", 16, 8),
                             device="cpu")
    runs = {}
    for name, fail in (("clean", None), ("failed", 3)):
        fired = []

        def inject(step, fail=fail, fired=fired):
            if step == fail and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        tr = Trainer(api, tcfg, mesh=mesh, device="cpu",
                     ckpt_manager=CheckpointManager(
                         os.path.join(args["tmp"], f"{name}_{world}")))
        _, hist = tr.run(tr.init_state(), pipe, steps=5, fail_injector=inject)
        runs[name] = [(h["step"], h["loss"]) for h in hist]
        out["mesh_kept"] = tr.mesh is mesh
    out["runs"] = runs
    return out if rank == 0 else {}


def ici(rank: int, world: int, args: dict) -> dict:
    """The three ICI modes, static and run-time k, over the "model" axis of
    a (world,) mesh and on a ("data",) mesh without it, from the given
    global v: every rank's output and aux."""
    from repro_torch.core import noise
    from repro_torch.parallel import sharding as sh

    v = torch.from_numpy(args["v"].copy())
    scale = noise.NoiseScale(ici_kib=args["ici_kib"])
    out = {}
    for key, axes in ((world, ("model",)), ("no_axis", ("data",))):
        mesh = _mesh((world,), axes)
        modes = noise.make_modes(scale, mesh=mesh, ici_axis="model",
                                 device="cpu")
        for name in ("ici_allreduce", "ici_allgather", "ici_a2a"):
            m = modes[name]
            sharded = name != "ici_allreduce" and key != "no_axis"
            state = {"v": sh.local_shard(v, sh.P("model"), mesh).clone()
                     if sharded else v.clone()}
            made = m.make_state(torch.Generator().manual_seed(0))["v"]
            for form, apply in (("static", m.apply), ("rt", m.apply_rt)):
                before = state["v"].clone()
                aux, new = apply(state, ICI_K)
                assert torch.equal(state["v"], before)     # out of place
                out[(key, name, form)] = {"aux": aux.numpy().copy(),
                                          "v": new["v"].numpy().copy(),
                                          "state_numel": made.numel()}
        # the active mesh stands in for an explicit one
        with sh.use_mesh(mesh):
            m = noise.make_modes(scale, ici_axis="model",
                                 device="cpu")["ici_allreduce"]
            out[(key, "active")] = m.apply({"v": v.clone()}, 1)[0].item()
    return out


def layouts(rank: int, world: int, args) -> dict:
    """``local_shard`` against DTensor's ``distribute_tensor`` under
    ``placements`` for specs over one and two axes of a (2, 2) mesh,
    ``gather_shard`` back to the full tensor, and the (pod, data) group."""
    import torch.distributed as dist

    try:
        from torch.distributed.tensor import distribute_tensor
    except ImportError:                         # torch < 2.4
        from torch.distributed._tensor import distribute_tensor
    from repro_torch.parallel import sharding as sh

    mesh = _mesh((2, 2), ("pod", "data"))
    full = torch.arange(8 * 12 * 6, dtype=torch.float32).reshape(8, 12, 6)
    specs = (sh.P("pod"), sh.P(None, "data"), sh.P("pod", "data"),
             sh.P(("pod", "data")), sh.P(None, ("pod", "data"), None),
             sh.P())
    dt_ok, gather_ok = True, True
    for spec in specs:
        local = sh.local_shard(full, spec, mesh)
        dt = distribute_tensor(full, mesh, sh.placements(spec, mesh))
        dt_ok &= torch.equal(dt.to_local(), local)
        gather_ok &= torch.equal(sh.gather_shard(local.clone(), spec, mesh),
                                 full)
    group = sh.axis_group(mesh, ("pod", "data"))
    return {"dtensor_equal": dt_ok, "gathered_equal": gather_ok,
            "pod_data_group": dist.get_process_group_ranks(group),
            "want_pod_data_group": list(range(world)),
            "coordinate": tuple(mesh.get_coordinate())}


def serve_steps(rank: int, world: int, args: dict) -> dict:
    """The per-rank prefill and decode (``serve/mesh.py``) of each arch on
    each (data, model) mesh of this world (a MoE at ``args["capacity"]``),
    from the reference's params,
    prompt, cache, tokens and position: this rank's logits rows, its
    shards of the updated cache, and where they lie in the global arrays
    (each local element's flat index)."""
    from repro_torch.convert import params_to_torch
    from repro_torch.models.model import build
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve import mesh as sm
    from repro_torch.train.trainer import batch_shardings, shard_params

    out = {}
    for arch, x in args["archs"].items():
        cfg = f32_smoke(arch)
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=args["capacity"])
        api = build(cfg)
        for shape in args["meshes"]:
            mesh = _mesh(shape, ("data", "model"))
            params = params_to_torch(cfg, x["params"])
            specs, shapes = shard_params(api, params, mesh)
            layout = sm.param_layout(specs, shapes, mesh)
            prompt = {"tokens": torch.from_numpy(x["prompt"].copy())}
            with torch.no_grad():
                pre = sm.make_mesh_prefill(api, mesh, layout)(params, prompt)
            cache = _torch_tree(x["cache"])
            cache, clayout = sm.shard_cache(api, cache, mesh)
            tokens = torch.from_numpy(x["tokens"].copy())
            pos = torch.tensor(x["pos"], dtype=torch.int32)
            with torch.no_grad():
                dl, new = sm.make_mesh_decode(api, mesh, layout, clayout)(
                    params, cache, tokens, pos)
            B = tokens.shape[0]
            rows = sh.local_shard(torch.arange(B), batch_shardings(
                mesh, prompt)["tokens"], mesh)
            where = {}
            for n, shp in clayout.shapes.items():
                flat = torch.arange(int(np.prod(shp))).reshape(shp)
                where[n] = clayout.local(n, flat).numpy().copy()
            out[(arch, tuple(shape))] = {
                "prefill": pre.numpy().copy(), "decode": dl.numpy().copy(),
                "rows": rows.numpy().copy(), "where": where,
                "cache": {n: t.numpy().copy()
                          for n, t in sm._leaves(new).items()}}
    return out


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).copy())
