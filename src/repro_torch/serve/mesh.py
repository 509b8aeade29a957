"""Per-rank prefill and decode on a device mesh: the port's counterparts of
the programs that the reference's ``prefill_cell`` and ``decode_cell``
leave to GSPMD.

They follow the port's ZeRO-3 design (``train/trainer.py``; a declared
deviation, ROADMAP queue 3). Each rank holds:

  - its shards of the params (``param_spec``'s rules, ``shard_params``);
  - its shards of the decode cache (``cache_spec``'s rules,
    ``shard_cache``): its batch rows (``cache_batch`` over pod and data),
    and a slice of the axis that ``model`` splits (``cache_seq`` for most
    archs, whose KV heads do not divide 16; ``ssm_heads`` for mamba2);
  - its rows of the batch (``batch`` over pod and data).

A step gathers the weights whole at use (``gather_params``) and computes
on the rank's rows; over ``model`` its compute is replicated.

``make_mesh_prefill``: the forward on the rank's rows, returning the
next-token logits of each of its sequences (``logits[:, -1]``); a MoE's
dispatch groups are the reference's (``n_groups`` = dp, as its
``prefill_cell`` sets it; a rank routes the groups of its rows).

``make_mesh_decode``: one token against the cache. Each cache leaf that a
mesh axis splits beyond the batch rows is gathered at use, one layer at a
time (the rank's rows, every position or head), and after the layer only
the rank's own slice is written back: the same rule as for the weights.
A MoE routes the global batch as one dispatch group, as the reference's
decode step does (``parallel.sharding.global_routing``). The step returns
the rank's logits rows and its shards of the new cache.

A sequence-parallel decode (each rank attends over its own slice of the
cache and the ranks merge their softmax sums) would move far fewer bytes;
it is later work (ROADMAP queue 2).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.parallel import sharding as sh
from repro_torch.train import trainer as tr

# the cache groups that a decode step writes in place (the self-attention
# KV stacks of every family); the others come back as new tensors or are
# only read
IN_PLACE_GROUPS = ("kv",)


def _leaves(tree: dict, prefix: str = "") -> dict:
    """A nested dict -> {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, name + "/"))
        else:
            out[name] = v
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def param_layout(specs: dict, shapes: dict, mesh) -> sh.Layout:
    """The params' ``Layout`` under the trainer's names ("params/<n>")."""
    return sh.Layout(mesh, {f"params/{n}": s for n, s in specs.items()},
                     {f"params/{n}": shapes[n] for n in specs})


def shard_cache(api, cache: dict, mesh) -> tuple:
    """A full cache -> (this rank's shards of it, their ``Layout`` keyed
    "group/leaf"), by ``api.cache_spec()``'s rules."""
    tr._check_mesh(mesh)
    full = _leaves(cache)
    logical = _leaves(api.cache_spec())
    specs = {n: sh.resolve(logical[n], tuple(t.shape), mesh)
             for n, t in full.items()}
    layout = sh.Layout(mesh, specs, {n: tuple(t.shape)
                                     for n, t in full.items()})
    local = {n: tr._own(t, layout.local(n, t)) for n, t in full.items()}
    return _nest(local), layout


def _rest(api, name: str, spec) -> sh.P:
    """``spec`` without its batch-rows entry: the split that a rank
    gathers at use."""
    logical = _leaves(api.cache_spec())[name]
    entries = list(spec) + [None] * (len(logical) - len(spec))
    return sh.P(*(None if lg == "cache_batch" else e
                  for lg, e in zip(logical, entries)))


class _GatheredAtUse:
    """One stacked cache leaf of a rank (its rows, its slice of the other
    split axes) that hands the decode step layer i whole over those axes
    (``leaf[i]``): gathered when asked, and for an in-place group its
    own slice written back when the step moves on to the next layer or
    ends (``flush``)."""

    def __init__(self, local: torch.Tensor, spec: sh.P, mesh,
                 write_back: bool):
        self.local = local
        self.spec = sh.P(*tuple(spec)[1:])     # a layer's: no stack axis
        self.mesh = mesh
        self.write_back = write_back
        self._open: tuple = ()

    def __getitem__(self, i: int) -> torch.Tensor:
        self.flush()
        full = sh.gather_shard(self.local[i], self.spec, self.mesh)
        self._open = (i, full)
        return full

    def flush(self) -> None:
        if self._open and self.write_back:
            i, full = self._open
            self.local[i].copy_(sh.local_shard(full, self.spec, self.mesh))
        self._open = ()


def make_mesh_prefill(api, mesh, layout: sh.Layout) -> Callable:
    """``fwd(params, batch) -> logits (rows, V)``: this rank's sequences'
    next-token logits, from its param shards (``layout``) and the global
    batch (the rank takes its rows)."""
    tr._check_mesh(mesh)

    def fwd(params, batch: dict):
        bspecs = tr.batch_shardings(mesh, batch)
        local = {k: sh.local_shard(v, bspecs[k], mesh)
                 for k, v in batch.items()}
        kw = tr.moe_groups(api, mesh, batch, bspecs)
        full = tr.gather_params(params, layout)
        logits, _ = api.forward(full, local, **kw)
        return logits[:, -1, :]

    return fwd


def make_mesh_decode(api, mesh, layout: sh.Layout,
                     cache_layout: sh.Layout) -> Callable:
    """``step(params, cache, tokens, pos) -> (logits (rows, 1, V), cache)``
    on this rank's param and cache shards (``layout``, ``cache_layout``)
    and the global tokens (B, 1) (the rank takes its rows). The returned
    cache is the rank's shards: those written in place are the ones given,
    the others new tensors."""
    tr._check_mesh(mesh)

    def step(params, cache: dict, tokens: Any, pos):
        tspec = sh.resolve(("batch", None), tuple(tokens.shape), mesh)
        tok = sh.local_shard(tokens, tspec, mesh)
        full = tr.gather_params(params, layout)
        flat = _leaves(cache)
        lazy = {}
        for n, t in flat.items():
            rest = _rest(api, n, cache_layout.specs[n])
            if any(sh.entry_axes(e) for e in rest):
                lazy[n] = _GatheredAtUse(
                    t, rest, mesh, n.split("/")[0] in IN_PLACE_GROUPS)
            else:
                lazy[n] = t
        with sh.global_routing(tspec, mesh):
            logits, new = api.decode_step(full, _nest(lazy), tok, pos)
        out = {}
        for n, v in _leaves(new).items():
            if isinstance(v, _GatheredAtUse):
                v.flush()
                out[n] = v.local
            elif n in lazy and v is lazy[n]:
                out[n] = v
            else:       # a new tensor of the rank's rows: keep its slice
                rest = _rest(api, n, cache_layout.specs[n])
                out[n] = tr._own(v, sh.local_shard(v, rest, mesh))
        return logits, _nest(out)

    return step
