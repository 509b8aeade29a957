"""AdamW with f32 moments and f32 master copies for bf16 params.

PyTorch port of the reference's ``repro.train.optimizer``. The state keeps
one f32 ``mu``, ``nu`` (and ``master``) tensor per parameter, keyed by the
parameter's ``named_parameters`` name. Unlike the reference's pure,
donated update, ``adamw_update`` works IN PLACE on the card: the moments,
the master copies and the parameters are overwritten, so a full-width
model holds one copy of its state.

Weight decay follows the reference's rule, "no decay on 1-D leaves", read
on the REFERENCE's leaf: the reference stacks per-layer params on a
leading (L, ...) axis, so every per-layer norm scale (L, d) is decayed
there while the unstacked final norm (d,) is not. The port's per-layer
modules hold (d,) tensors, so the rank is taken from
``convert.reference_ndim``, not from the tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.convert import reference_ndim


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor                   # int32 scalar
    mu: dict                             # name -> f32 tensor
    nu: dict                             # name -> f32 tensor
    master: Optional[dict]               # f32 masters (None if params f32)


def adamw_init(params, *, use_master: bool = True) -> AdamWState:
    """Zero moments (and f32 master copies when any parameter is not f32)
    beside ``params`` (an ``nn.Module``), on its device."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    mu = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
          for n, p in named.items()}
    nu = {n: torch.zeros_like(m) for n, m in mu.items()}
    needs_master = use_master and any(p.dtype != torch.float32
                                      for p in named.values())
    master = ({n: p.detach().to(torch.float32, copy=True)
               for n, p in named.items()} if needs_master else None)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu, master=master)


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% (f32, on step's device)."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in tensors)
    return torch.sqrt(sq)


def opt_spec_like(param_spec: dict, *, use_master: bool = True) -> dict:
    """The logical-axis specs of an ``AdamWState`` beside ``param_spec``:
    the moments (and master copies) are laid out as their parameters."""
    return {"step": (), "mu": param_spec, "nu": param_spec,
            "master": param_spec if use_master else None}


@torch.no_grad()
def adamw_update(cfg: TrainConfig, params, grads: dict, state: AdamWState,
                 *, gnorm: Optional[torch.Tensor] = None):
    """One AdamW step with global-norm clipping, in place on ``params``
    and ``state`` (grads: name -> tensor, any float dtype). ``gnorm``: the
    gradients' global norm when ``grads`` are shards of them (the mesh
    step); by default the norm of ``grads``. Returns (params, state,
    {"grad_norm", "lr"}) as 0-d f32 tensors."""
    state.step += 1
    if gnorm is None:
        gnorm = global_norm(grads.values())
    clip = (torch.clamp(torch.div(cfg.grad_clip,
                                  torch.clamp(gnorm, min=1e-12)), max=1.0)
            if cfg.grad_clip else torch.ones((), device=gnorm.device))
    lr = lr_schedule(cfg, state.step)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    s = state.step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, s)
    bc2 = 1 - torch.pow(b2, s)

    for name, p in params.named_parameters():
        p32 = state.master[name] if state.master is not None else p
        g = grads[name].to(torch.float32) * clip
        mu, nu = state.mu[name], state.nu[name]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        del g
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if reference_ndim(name, p) >= 2:
            u.add_(wd * p32)
        p32.sub_(lr * u)
        del u
        if p32 is not p:
            p.copy_(p32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
