"""The trainer: a step with microbatched gradient accumulation and mixed
precision, checkpoint / restart fault tolerance, and a straggler flag.

PyTorch port of the reference's ``repro.train.trainer`` on one device
(``mesh=None``). The step is eager: the loss and its gradients come from
autograd (``torch.autograd.grad`` over the parameters, whose
``requires_grad`` is on for the step only), the update is AdamW in place
(``train/optimizer.py``), and the state object that goes in comes back.
A mesh, and the int8-compressed all-reduce over its batch axes, wait for
the parallel layer (ROADMAP queue 1, item 11); without a mesh the
reference's compression has no axis to reduce over and the residuals
ride along unchanged, as here.

The loop (``Trainer.run``) keeps the reference's contract: the data are a
pure function of the step, a checkpoint is saved every ``ckpt_every``
steps (asynchronously), a step slower than ``step_deadline_s`` is flagged,
and a failed step restores the latest checkpoint and replays from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.train import grad_compression as gc
from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update

log = logging.getLogger("repro_torch.train")

MESH_REFUSED = ("a mesh (and the int8-compressed all-reduce over its batch "
                "axes) waits for the parallel layer (ROADMAP queue 1, item "
                "11); pass mesh=None")


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module
    opt: AdamWState
    residuals: Optional[dict] = None     # error-feedback state (compression)

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


def make_train_step(api, tcfg: TrainConfig, *, mesh=None,
                    compress: Optional[str] = None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``: the loss and its
    gradients over ``tcfg.microbatches`` microbatches (summed into f32
    zeros, then divided by M; the aux losses averaged), then AdamW in
    place. metrics: loss, grad_norm, lr and the aux, as 0-d tensors."""
    if mesh is not None:
        raise NotImplementedError(MESH_REFUSED)
    M = tcfg.microbatches
    fwd_kw: dict = {"remat": tcfg.remat}
    if tcfg.scan_group > 1:
        fwd_kw["scan_group"] = tcfg.scan_group
    del compress  # without a mesh there is no batch axis to reduce over

    def compute_grads(params, batch):
        if M <= 1:
            return loss_and_grads(api, params, batch, **fwd_kw)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.named_parameters()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(acc.values())).device)
        auxs = []
        for mb in _split_microbatches(batch, M):
            loss, aux, g = loss_and_grads(api, params, mb, **fwd_kw)
            for n, gn in g.items():
                acc[n].add_(gn)
            del g
            loss_sum += loss
            auxs.append(aux)
        for a in acc.values():
            a.div_(M)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return loss_sum / M, aux, acc

    def step(state: TrainState, batch: dict):
        loss, aux, grads = compute_grads(state.params, batch)
        _, _, stats = adamw_update(tcfg, state.params, grads, state.opt)
        del grads
        return state, {"loss": loss, **stats, **aux}

    return step


class Trainer:
    def __init__(self, api, tcfg: TrainConfig, *, mesh=None,
                 compress: Optional[str] = None, ckpt_manager=None,
                 device="cuda"):
        self.api = api
        self.tcfg = tcfg
        self.compress = compress
        self.ckpt = ckpt_manager
        self.device = device
        self._step = make_train_step(api, tcfg, mesh=mesh, compress=compress)

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        params = self.api.init(self.tcfg.seed if seed is None else seed,
                               self.device)
        res = gc.init_residuals(params) if self.compress else None
        return TrainState(params=params, opt=adamw_init(params),
                          residuals=res)

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
