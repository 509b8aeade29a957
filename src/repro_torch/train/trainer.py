"""The trainer: a step with microbatched gradient accumulation and mixed
precision, checkpoint / restart fault tolerance, and a straggler flag.

PyTorch port of the reference's ``repro.train.trainer``. The step is
eager: the loss and its gradients come from autograd
(``torch.autograd.grad`` over the parameters, whose ``requires_grad`` is
on for the step only), the update is AdamW in place
(``train/optimizer.py``), and the state object that goes in comes back.
Without a mesh the reference's int8 compression has no axis to reduce over
and the residuals ride along unchanged, as there.

Under a mesh (a ``torch.distributed`` ``DeviceMesh`` with the axis names of
``parallel.sharding``; one process a rank) each rank holds plain local
shards of the params, the AdamW moments and masters and the residuals, as
``state_shardings`` (the logical rules) places them; ``TrainState.layout``
records each tensor's spec and logical shape. A step (ZeRO-3 style):

  1. the global batch is split into the microbatches, and each rank takes
     its shard of each (``batch_shardings``; the reference's microbatches
     are cut from the global batch, then sharded);
  2. the weights are all-gathered at use (a leaf that no mesh axis splits
     is used as it is). A leaf that the forward computes split over
     ``model`` (``tp_leaves``: the transformer family's embedding,
     attention and dense MLP, where the rules split the vocabulary, the
     heads or ``ff`` there) is gathered over the other axes only, so each
     rank holds its own heads, ``ff`` columns and vocabulary rows whole
     over ``d_model``; every other leaf (norms, a MoE's router and
     experts, the ssm, hybrid and encdec families) is gathered whole;
  3. the forward and backward run on the rank's batch shard, each split
     layer on the rank's shard of its weights (tensor parallelism:
     ``models/transformer.py``), under ``use_mesh``; a MoE's dispatch
     groups are the reference's (``n_groups`` = the data-parallel size,
     whose groups are the batch shards), and its load-balance terms and a
     masked NLL's sums are reduced over the batch axes inside the model
     (``parallel.sharding.batch_reduction``);
  4. the gradients are averaged over the batch axes (in f32), so every
     rank holds the reference's replica mean (of its ``model`` shard, for
     a split leaf); with ``compress="int8"`` the compressed all-reduce then
     runs on those means with the residuals gathered over the same axes
     as their gradients, Q(mean + r), as the reference's single-program
     form, each leaf's scale the max over the whole leaf (over ``model``
     too);
  5. the clip's norm counts every element once (a split leaf's squares
     summed over ``model``), and each rank updates its own shard.

The loop (``Trainer.run``) keeps the reference's contract: the data are a
pure function of the step, a checkpoint is saved every ``ckpt_every``
steps (asynchronously), a step slower than ``step_deadline_s`` is flagged,
and a failed step restores the latest checkpoint and replays from it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import math
import time
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.models.layers import param
from repro_torch.parallel import sharding as sh
from repro_torch.train import grad_compression as gc
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, global_norm,
                                         opt_spec_like)

log = logging.getLogger("repro_torch.train")

BATCH_AXES = ("pod", "data")


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module
    opt: AdamWState
    residuals: Optional[dict] = None     # error-feedback state (compression)
    # under a mesh: each tensor's spec and logical shape (the tensors are
    # this rank's shards); None on one device
    layout: Optional[sh.Layout] = None

    def tensors(self) -> dict:
        """Every tensor of the state by a stable name (the checkpoint's
        leaves): params/<name>, opt/step, opt/mu|nu|master/<name>,
        residuals/<name>."""
        out = {f"params/{n}": p for n, p in self.params.named_parameters()}
        out["opt/step"] = self.opt.step
        groups = {"opt/mu": self.opt.mu, "opt/nu": self.opt.nu,
                  "opt/master": self.opt.master,
                  "residuals": self.residuals}
        for prefix, group in groups.items():
            for n, t in (group or {}).items():
                out[f"{prefix}/{n}"] = t
        return out


def _split_microbatches(batch: dict, m: int) -> list:
    """A batch dict -> m microbatch dicts along the leading axis."""
    for name, x in batch.items():
        if x.shape[0] % m:
            raise ValueError(f"batch {name!r} of {x.shape[0]} rows does not "
                             f"split into {m} microbatches")
    return [{name: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
             for name, x in batch.items()} for i in range(m)]


@contextlib.contextmanager
def _requires_grad(params: torch.nn.Module):
    """Turn ``requires_grad`` on for every parameter, off again after."""
    ps = list(params.parameters())
    for p in ps:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in ps:
            p.requires_grad_(False)


def loss_and_grads(api, params: torch.nn.Module, batch: dict, **fwd_kw):
    """``api.loss`` and its gradient for every parameter: (loss, aux,
    {name: grad}) with the loss and aux detached and each gradient in its
    parameter's dtype (zeros where the loss does not reach it)."""
    named = dict(params.named_parameters())
    with _requires_grad(params):
        loss, aux = api.loss(params, batch, **fwd_kw)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _compute_grads(api, params, mbs: list, fwd_kw: dict):
    """(loss, aux, grads) over the microbatches ``mbs``: one microbatch
    through ``loss_and_grads`` as it is; several summed into f32 zeros,
    then divided by their number (the aux losses averaged)."""
    if len(mbs) == 1:
        return loss_and_grads(api, params, mbs[0], **fwd_kw)
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.named_parameters()}
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(acc.values())).device)
    auxs = []
    for mb in mbs:
        loss, aux, g = loss_and_grads(api, params, mb, **fwd_kw)
        for n, gn in g.items():
            acc[n].add_(gn)
        del g
        loss_sum += loss
        auxs.append(aux)
    for a in acc.values():
        a.div_(len(mbs))
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    return loss_sum / len(mbs), aux, acc


def make_train_step(api, tcfg: TrainConfig, *, mesh=None,
                    compress: Optional[str] = None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``: the loss and its
    gradients over ``tcfg.microbatches`` microbatches (summed into f32
    zeros, then divided by M; the aux losses averaged), then AdamW in
    place. metrics: loss, grad_norm, lr and the aux, as 0-d tensors.

    ``mesh``: a ``DeviceMesh`` (the module docstring's step; the state is
    the one ``Trainer(mesh=...).init_state`` or ``shard_state`` made).
    ``compress``: None | "int8", the compressed all-reduce over the mesh's
    batch axes (without a mesh there is none to reduce over)."""
    M = tcfg.microbatches
    fwd_kw: dict = {"remat": tcfg.remat}
    if tcfg.scan_group > 1:
        fwd_kw["scan_group"] = tcfg.scan_group
    if mesh is not None:
        return _make_mesh_step(api, tcfg, mesh, compress, fwd_kw)

    def step(state: TrainState, batch: dict):
        mbs = [batch] if M <= 1 else _split_microbatches(batch, M)
        loss, aux, grads = _compute_grads(api, state.params, mbs, fwd_kw)
        _, _, stats = adamw_update(tcfg, state.params, grads, state.opt)
        del grads
        return state, {"loss": loss, **stats, **aux}

    return step


# ---------------------------------------------------------------------------
# The mesh path
# ---------------------------------------------------------------------------

def _check_mesh(mesh) -> None:
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"a mesh step needs a DeviceMesh over a process "
                        f"group (make_mesh_from_config); got "
                        f"{type(mesh).__name__}, which resolves specs but "
                        f"runs no collective")


def _param_specs(api, mesh, shapes: dict) -> dict:
    """{parameter name: P} on ``mesh`` for logical ``shapes``."""
    logical = api.param_spec()
    return {n: sh.resolve(logical[n], shapes[n], mesh) for n in shapes}


def state_shardings(api, mesh, state: TrainState) -> TrainState:
    """The specs of ``state``'s tensors on ``mesh`` by the logical rules, as
    a TrainState of {name: P} dicts (the reference's NamedSharding tree):
    params by ``api.param_spec()``, the AdamW moments and masters and the
    residuals as their parameters (``opt_spec_like``), the step
    replicated. Resolved on the logical shapes (``state.layout``'s for a
    sharded state)."""
    shapes = (state.layout.shapes if state.layout is not None else
              {n: tuple(t.shape) for n, t in state.tensors().items()})
    pspec = _param_specs(api, mesh, {
        n: shapes[f"params/{n}"] for n, _ in state.params.named_parameters()})
    ospec = opt_spec_like(pspec, use_master=state.opt.master is not None)
    return TrainState(
        params=pspec,
        opt=AdamWState(step=sh.P(), mu=ospec["mu"], nu=ospec["nu"],
                       master=ospec["master"]),
        residuals=pspec if state.residuals is not None else None)


def _flat_specs(specs: TrainState) -> dict:
    """A ``state_shardings`` tree -> {``TrainState.tensors`` name: P}."""
    out = {f"params/{n}": s for n, s in specs.params.items()}
    out["opt/step"] = specs.opt.step
    for prefix, group in (("opt/mu", specs.opt.mu), ("opt/nu", specs.opt.nu),
                          ("opt/master", specs.opt.master),
                          ("residuals", specs.residuals)):
        for n, s in (group or {}).items():
            out[f"{prefix}/{n}"] = s
    return out


def batch_shardings(mesh, batch_like: dict) -> dict:
    """{name: P} of a batch on ``mesh``: the leading axis over the batch
    axes (as far as it divides), the rest replicated."""
    return {name: sh.resolve(("batch",) + (None,) * (x.ndim - 1),
                             tuple(x.shape), mesh)
            for name, x in batch_like.items()}


def _own(full: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """A shard in its own storage (the full tensor itself when the shard
    is all of it)."""
    return full if local.shape == full.shape else local.clone()


def _set_param(module: torch.nn.Module, name: str, t: torch.Tensor):
    owner, _, leaf = name.rpartition(".")
    module.get_submodule(owner)._parameters[leaf] = param(t)


def shard_state(api, state: TrainState, mesh) -> TrainState:
    """A full (one-device) ``state`` -> this rank's shards of it on
    ``mesh``, with its ``layout`` (the tensors of ``state`` are replaced,
    so the full ones can be freed)."""
    _check_mesh(mesh)
    specs = _flat_specs(state_shardings(api, mesh, state))
    tensors = state.tensors()
    layout = sh.Layout(mesh, specs,
                       {n: tuple(t.shape) for n, t in tensors.items()})
    local = {n: _own(t, layout.local(n, t)) for n, t in tensors.items()}
    for n, _ in list(state.params.named_parameters()):
        _set_param(state.params, n, local[f"params/{n}"])

    def group(prefix, d):
        return None if d is None else {n: local[f"{prefix}/{n}"] for n in d}

    opt = AdamWState(step=local["opt/step"], mu=group("opt/mu", state.opt.mu),
                     nu=group("opt/nu", state.opt.nu),
                     master=group("opt/master", state.opt.master))
    return TrainState(params=state.params, opt=opt,
                      residuals=group("residuals", state.residuals),
                      layout=layout)


def shard_params(api, params: torch.nn.Module, mesh) -> tuple:
    """Replace each of ``params``' tensors by this rank's shard of it on
    ``mesh`` (``api.param_spec()``'s rules); returns ({name: P}, {name:
    logical shape})."""
    _check_mesh(mesh)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    specs = _param_specs(api, mesh, shapes)
    for n, p in list(params.named_parameters()):
        _set_param(params, n, _own(p, sh.local_shard(p, specs[n], mesh)))
    return specs, shapes


TP_AXES = (sh.MODEL_AXIS,)


def tp_leaves(api, layout: sh.Layout) -> frozenset:
    """The parameters that the forward computes on this rank's shard over
    ``model`` (``api.tensor_parallel``) and that ``layout`` splits there
    (none where the axis has size 1)."""
    if sh.mesh_axis_sizes(layout.mesh).get(sh.MODEL_AXIS, 1) == 1:
        return frozenset()
    return frozenset(
        n for n in (k.split("/", 1)[1] for k in layout.specs
                    if k.startswith("params/"))
        if api.tensor_parallel(n) and any(
            sh.MODEL_AXIS in sh.entry_axes(e)
            for e in layout.specs[f"params/{n}"]))


def gather_params(params: torch.nn.Module, layout: sh.Layout,
                  split: frozenset = frozenset()):
    """A module of the parameters gathered from this rank's shards
    (ZeRO-3's gather at use): whole, but for the ``split`` ones
    (``tp_leaves``), gathered over the axes other than ``model`` only. A
    parameter that no gathered axis splits is shared, not copied."""
    memo: dict = {}
    for n, p in params.named_parameters():
        full = layout.gather(f"params/{n}", p,
                             TP_AXES if n in split else ())
        memo[id(p)] = p if full is p else param(full)
    return copy.deepcopy(params, memo)


def moe_groups(api, mesh, batch: dict, bspecs: dict) -> dict:
    """The forward's ``n_groups`` for this rank's shard of ``batch``
    (``bspecs``, its specs): the reference's dispatch groups are the dp
    batch shards (``n_groups`` = dp), and a rank whose shard holds
    dp / split of them routes those. {} for a model without experts."""
    if not api.cfg.n_experts:
        return {}
    sizes = sh.mesh_axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in BATCH_AXES if a in sizes)
    split = math.prod(sizes[a] for a in sh.entry_axes(
        (bspecs["tokens"] + (None,))[0]))
    rows = batch["tokens"].shape[0]
    seq = batch["tokens"].shape[1] + (
        batch["img_embeds"].shape[1] if "img_embeds" in batch else 0)
    if split > 1 and (dp % split or rows * seq % dp):
        raise ValueError(f"a MoE microbatch of {rows} x {seq} tokens split "
                         f"{split} ways does not hold the reference's {dp} "
                         f"dispatch groups")
    return {"n_groups": dp // split}


def _make_mesh_step(api, tcfg: TrainConfig, mesh, compress, fwd_kw):
    _check_mesh(mesh)
    M = tcfg.microbatches
    sizes = sh.mesh_axis_sizes(mesh)
    batch_axes = tuple(a for a in BATCH_AXES if a in sizes)
    dp = math.prod(sizes[a] for a in batch_axes)
    group = sh.axis_group(mesh, batch_axes) if batch_axes else None
    tp = sizes.get(sh.MODEL_AXIS, 1) > 1
    model_group = mesh.get_group(sh.MODEL_AXIS) if tp else None
    # a split leaf's int8 scale is the max over the whole leaf: over
    # ``model`` as well as the batch axes
    cpsum = (gc.make_compressed_psum(
        batch_axes, mesh=mesh,
        scale_axes=batch_axes + TP_AXES if tp else None)
        if compress == "int8" and batch_axes else None)

    def shard_batch(batch: dict) -> tuple:
        mbs = [batch] if M <= 1 else _split_microbatches(batch, M)
        bspecs = batch_shardings(mesh, mbs[0])
        kw = dict(fwd_kw, **moe_groups(api, mesh, mbs[0], bspecs))
        return [{k: sh.local_shard(v, bspecs[k], mesh) for k, v in mb.items()}
                for mb in mbs], kw

    def mean_over_batch(t: torch.Tensor) -> torch.Tensor:
        if group is None:
            return t
        t32 = t.to(torch.float32)
        dist.all_reduce(t32, group=group)
        return t32.div_(dp)

    def step(state: TrainState, batch: dict):
        layout = state.layout
        if layout is None or layout.mesh is not mesh:
            raise ValueError("a mesh step takes a state sharded on its mesh "
                             "(Trainer(mesh=...).init_state or shard_state)")
        mbs, kw = shard_batch(batch)
        split = tp_leaves(api, layout)
        keep = {n: TP_AXES if n in split else ()
                for n, _ in state.params.named_parameters()}
        full = gather_params(state.params, layout, split)
        ctx = (sh.batch_reduction(group, dp) if group is not None
               else contextlib.nullcontext())
        with ctx, sh.use_mesh(mesh):
            loss, aux, grads = _compute_grads(api, full, mbs, kw)
        del full
        for n, g in grads.items():
            g.copy_(mean_over_batch(g))
        names = ["loss", *aux]
        stacked = mean_over_batch(torch.stack([loss.float(), *(
            a.float() for a in aux.values())]))
        metrics = dict(zip(names, stacked.unbind()))
        if cpsum is not None:
            full_r = {n: layout.gather(f"residuals/{n}", r, keep[n])
                      for n, r in state.residuals.items()}
            grads, new_r = cpsum(grads, full_r)
            del full_r
            for n, r in state.residuals.items():
                r.copy_(layout.local(f"residuals/{n}", new_r[n], keep[n]))
            del new_r
        gnorm = global_norm((g for n, g in grads.items() if n not in split),
                            shards=[grads[n] for n in grads if n in split],
                            group=model_group)
        local = {n: layout.local(f"params/{n}", g, keep[n])
                 for n, g in grads.items()}
        _, _, stats = adamw_update(tcfg, state.params, local, state.opt,
                                   gnorm=gnorm)
        del grads, local
        return state, {**metrics, **stats}

    return step


class Trainer:
    def __init__(self, api, tcfg: TrainConfig, *, mesh=None,
                 compress: Optional[str] = None, ckpt_manager=None,
                 device="cuda"):
        self.api = api
        self.tcfg = tcfg
        self.mesh = mesh
        self.compress = compress
        self.ckpt = ckpt_manager
        self.device = device
        self._step = make_train_step(api, tcfg, mesh=mesh, compress=compress)

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """The state from the seed; under a mesh each rank draws the full
        params and keeps its shards, and its AdamW state and residuals are
        made on the shards (a full-width state is never held whole)."""
        params = self.api.init(self.tcfg.seed if seed is None else seed,
                               self.device)
        if self.mesh is None:
            res = gc.init_residuals(params) if self.compress else None
            return TrainState(params=params, opt=adamw_init(params),
                              residuals=res)
        specs, shapes = shard_params(self.api, params, self.mesh)
        state = TrainState(params=params, opt=adamw_init(params),
                           residuals=(gc.init_residuals(params)
                                      if self.compress else None))
        # every tensor is laid out as its parameter (opt_spec_like); the
        # step is replicated
        param_of = {name: name.rsplit("/", 1)[1] if name != "opt/step"
                    else None for name in state.tensors()}
        state.layout = sh.Layout(
            self.mesh,
            {t: sh.P() if p is None else specs[p] for t, p in param_of.items()},
            {t: () if p is None else shapes[p] for t, p in param_of.items()})
        return state

    # -- fault-tolerant loop ---------------------------------------------------
    def run(self, state: TrainState, data: Iterator, *, steps: int,
            start_step: int = 0, max_restarts: int = 3,
            fail_injector: Optional[Callable[[int], None]] = None
            ) -> tuple[TrainState, list[dict]]:
        """Run steps ``start_step`` .. ``steps - 1`` with checkpoint /
        restart fault tolerance.

        ``fail_injector(step)`` may raise to simulate a node failure
        (tests). On failure the latest checkpoint is restored into the
        state (in place) and the loop goes on from its step; without one
        the state is drawn anew from the seed. The data pipeline is
        step-indexed, so replayed batches are identical.
        """
        history: list[dict] = []
        step = start_step
        restarts = 0
        while step < steps:
            try:
                batch = data(step) if callable(data) else next(data)
                if fail_injector is not None:
                    fail_injector(step)
                t0 = time.perf_counter()
                state, metrics = self._step(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                metrics.update(step=step, wall_s=dt)
                history.append(metrics)
                if (self.tcfg.step_deadline_s
                        and dt > self.tcfg.step_deadline_s):
                    log.warning("straggler: step %d took %.3fs > deadline "
                                "%.3fs — flagged for re-dispatch", step, dt,
                                self.tcfg.step_deadline_s)
                    history[-1]["straggler"] = True
                if self.ckpt is not None and self.tcfg.ckpt_every \
                        and (step + 1) % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(step + 1, state, blocking=False)
                step += 1
            except KeyboardInterrupt:
                raise
            except Exception as e:  # node failure / preemption analogue
                restarts += 1
                if self.ckpt is None or restarts > max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring last checkpoint "
                            "(restart %d/%d)", step, e, restarts,
                            max_restarts)
                self.ckpt.wait()
                restored, ckpt_step = self.ckpt.restore_latest(like=state)
                if restored is None:      # no checkpoint yet: restart clean
                    state = self.init_state()
                    step = start_step
                else:
                    state = restored
                    step = ckpt_step
        if self.ckpt is not None:
            self.ckpt.wait()
        return state, history
