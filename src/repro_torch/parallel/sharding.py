"""Logical-axis sharding: models name the axes of their params and caches
with logical names; this module resolves them against a device mesh.

PyTorch port of the reference's ``repro.parallel.sharding``, with its
rules (production mesh: data = DP/FSDP axis, model = TP axis, pod = extra
DP axis):

  batch      -> (pod, data)     data parallelism
  heads      -> model           tensor parallelism on attention heads
  kv_heads   -> model
  ff         -> model
  experts    -> model           expert parallelism
  vocab      -> model           sharded embedding / logits
  fsdp       -> data            the parameters' d_model dim (ZeRO-3: the
                                weights are gathered at use)
  ssm_heads  -> model           Mamba2 head dim
  cache_seq  -> (data, model)   sequence-parallel decode caches
  (anything unknown)            replicated

Divisibility: with concrete dims, an axis that does not divide falls back
to the largest dividing prefix of its rule (often: replication), and no
mesh axis backs two dims of one tensor.

A spec is a ``P``: a tuple with one entry a dim, each None (replicated),
an axis name, or a tuple of axis names (the dim split over their product,
the first axis major), trailing Nones dropped, as the reference's
``PartitionSpec``. ``resolve`` runs on an ``AbstractMesh`` (sizes and
names, no process group) or on a live ``torch.distributed`` ``DeviceMesh``
(``make_mesh_from_config``). On a live mesh a tensor is held as plain
local shards: ``local_shard`` cuts a rank's shard out of the full tensor,
``gather_shard`` all-gathers the full tensor back from the shards, and
``placements`` gives the same layout as DTensor placements.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "cache_batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "expert_ff": ("model",),
    "vocab": ("model",),
    "fsdp": ("data",),
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    # decode-cache axes: kv heads shard over model ONLY when divisible (no
    # padding: that would double the cache's bytes); cache_seq takes the
    # axes that remain (sequence parallelism)
    "cache_kv_heads": ("model",),
    "cache_seq": ("data", "model"),
    "seq": (),
    "d_model": (),
}


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``. A tuple, so
    it equals the reference's ``PartitionSpec`` entry for entry; a
    one-axis tuple entry is normalized to the axis name, as the installed
    JAX's ``PartitionSpec`` normalizes it (``P(("pod",)) == P("pod")``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names without devices or a process group:
    enough to resolve specs."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return self.axis_names


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of an ``AbstractMesh`` or a ``DeviceMesh``."""
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.shape)))


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mesh",
                                                         default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh (the reference's ``set_mesh``) for
    ``resolve``, ``constrain`` and the ICI noise modes inside the block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The mesh of the enclosing ``use_mesh`` block, or None."""
    mesh = _ACTIVE.get()
    if mesh is None or not axis_names(mesh):
        return None
    return mesh


def resolve(logical: Sequence[Optional[str]],
            dims: Optional[Sequence[int]] = None, mesh: Optional[Any] = None,
            rules: Optional[dict[str, tuple[str, ...]]] = None) -> P:
    """Resolve logical axis names to a ``P`` for ``mesh`` (default: the
    active mesh; without one every dim is replicated).

    ``dims`` (optional) enables the divisibility fallback. Mesh axes absent
    from the mesh are dropped, so the same names work for (data, model),
    (pod, data, model) and test meshes.
    """
    rules = rules or LOGICAL_RULES
    if mesh is None:
        mesh = active_mesh()
    sizes = mesh_axis_sizes(mesh) if mesh is not None else {}
    out: list = []
    used: set[str] = set()
    for i, name in enumerate(logical):
        if name is None or not sizes:
            out.append(None)
            continue
        mesh_axes = tuple(a for a in rules.get(name, ())
                          if a in sizes and a not in used)
        if not mesh_axes:
            out.append(None)
            continue
        total = 1
        for a in mesh_axes:
            total *= sizes[a]
        truncated = False
        if dims is not None and dims[i] % total != 0:
            # a prefix of the axes that divides (e.g. batch=1 -> none)
            chosen: tuple[str, ...] = ()
            acc = 1
            for a in mesh_axes:
                if dims[i] % (acc * sizes[a]) == 0:
                    acc *= sizes[a]
                    chosen = chosen + (a,)
                else:
                    break
            mesh_axes = chosen
            truncated = True
        if not mesh_axes:
            out.append(None)
            continue
        used.update(mesh_axes)
        # a truncated multi-axis rule stays a tuple (('pod',), not 'pod'),
        # as the reference's code keeps it (``P`` then normalizes it)
        out.append(mesh_axes if len(mesh_axes) > 1 or truncated
                   else mesh_axes[0])
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, P) and all(
        isinstance(e, (str, type(None))) for e in x)


def _shape_of(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def resolve_tree(logical_tree, shape_tree=None, mesh=None, rules=None):
    """``resolve`` over a tree (nested dicts, lists) of logical-axis tuples.
    ``shape_tree``, when given, has the same structure with a shape (a
    tuple, or anything with ``.shape``) at each leaf."""
    if _is_logical(logical_tree):
        dims = None if shape_tree is None else _shape_of(shape_tree)
        return resolve(logical_tree, dims, mesh, rules)
    if isinstance(logical_tree, dict):
        return {k: resolve_tree(v, None if shape_tree is None
                                else shape_tree[k], mesh, rules)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        return type(logical_tree)(
            resolve_tree(v, None if shape_tree is None else shape_tree[i],
                         mesh, rules)
            for i, v in enumerate(logical_tree))
    return logical_tree


def constrain(x, *logical, rules=None):
    """The reference's sharding hint by logical axes. A no-op without an
    active mesh; with one the spec is resolved (unknown names and bad dims
    raise as there) and ``x`` is returned: the port's mesh step runs each
    rank's batch shard with gathered weights (``train/trainer.py``), so a
    layout hint on an activation has nothing to move."""
    mesh = active_mesh()
    if mesh is not None:
        resolve(logical, x.shape, mesh, rules)
    return x


def make_mesh_from_config(mesh_cfg, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``mesh_cfg``'s shape and axis names over the live
    world's first ``n_devices`` ranks (``init_device_mesh`` when the world
    is exactly that size). ``device_type``: "cuda" or "cpu" (default: cuda
    under an NCCL process group, else cpu). Fewer ranks than the mesh needs
    raise the reference's ``ValueError``."""
    n = mesh_cfg.n_devices
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise ValueError(
            f"mesh {mesh_cfg.shape} needs {n} devices, have {have} (start "
            "one process a device, e.g. torchrun --nproc-per-node)")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if device_type is None:
        device_type = ("cuda" if dist.is_initialized()
                       and dist.get_backend() == "nccl" else "cpu")
    if have == n:
        return init_device_mesh(device_type, tuple(mesh_cfg.shape),
                                mesh_dim_names=tuple(mesh_cfg.axes))
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(tuple(mesh_cfg.shape)),
                      mesh_dim_names=tuple(mesh_cfg.axes))


def entry_axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes: () for None, (a,) for "a", the tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh) -> list:
    """``spec`` as DTensor placements on ``mesh``: ``Shard(dim)`` on every
    mesh dim that splits a tensor dim, ``Replicate()`` on the others. A dim
    split over several axes takes them in mesh order, the first major, as
    the rules list them."""
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:                         # torch < 2.4
        from torch.distributed._tensor import Replicate, Shard
    names = axis_names(mesh)
    out: list = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


# process groups over several mesh axes (flattened), made once a mesh
_GROUPS: dict = {}


_COORDS: dict = {}


def _coords(mesh) -> dict:
    """{global rank: {axis: coordinate}} of every rank of ``mesh`` (made
    once a mesh, from the rank grid read as a list: no tensor op)."""
    key = id(mesh)
    if key not in _COORDS or _COORDS[key][0] is not mesh:
        names = axis_names(mesh)
        grid = mesh.mesh.tolist()
        out = {}
        for idx in itertools.product(*(range(s) for s in mesh.mesh.shape)):
            g = grid
            for i in idx:
                g = g[i]
            out[int(g)] = dict(zip(names, idx))
        _COORDS[key] = (mesh, out)
    return _COORDS[key][1]


def axis_group(mesh, axes: Sequence[str]):
    """The process group of this rank over the mesh ``axes`` (one axis:
    ``mesh.get_group``; several: their flattened product). The groups over
    several axes are all made at the first call for a mesh, on every rank
    in one order, as ``new_group`` requires."""
    names = axis_names(mesh)
    axes = tuple(sorted(axes, key=names.index))
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        coords = _coords(mesh)
        me = dist.get_rank()
        for r in range(2, len(names) + 1):
            for sub in itertools.combinations(names, r):
                rest = [a for a in names if a not in sub]
                made = {}
                for fixed in itertools.product(
                        *(range(mesh_axis_sizes(mesh)[a]) for a in rest)):
                    ranks = sorted(g for g, c in coords.items()
                                   if all(c[a] == v
                                          for a, v in zip(rest, fixed)))
                    group = dist.new_group(ranks)
                    if me in ranks:
                        made = group
                _GROUPS[(id(mesh), sub)] = (mesh, made)
    return _GROUPS[key][1]


def _index(coord: dict, axes: Sequence[str], sizes: dict) -> int:
    """The flattened index of ``coord`` over ``axes``, the first major."""
    i = 0
    for a in axes:
        i = i * sizes[a] + coord[a]
    return i


def local_shard(full: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec`` (a view)."""
    sizes = mesh_axis_sizes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    out = full
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        n = 1
        for a in axes:
            n *= sizes[a]
        if n > 1:
            size = out.shape[dim] // n
            out = out.narrow(dim, _index(coord, axes, sizes) * size, size)
    return out


def gather_shard(local: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``local`` shard under ``spec``
    (an all-gather over each split dim's axes; ``local`` itself when no dim
    is split)."""
    sizes = mesh_axis_sizes(mesh)
    out = local
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        n = 1
        for a in axes:
            n *= sizes[a]
        if n == 1:
            continue
        group = axis_group(mesh, axes)
        pieces = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(pieces, out.contiguous(), group=group)
        coords = _coords(mesh)
        members = dist.get_process_group_ranks(group)
        order = sorted(range(n), key=lambda j: _index(coords[members[j]],
                                                      axes, sizes))
        out = torch.cat([pieces[j] for j in order], dim=dim)
    return out


@dataclasses.dataclass
class Layout:
    """Where a set of named tensors lives on a mesh: each name's spec and
    its logical (unsharded) shape; a rank holds ``local_shard`` of each."""
    mesh: Any
    specs: dict
    shapes: dict

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return local_shard(full, self.specs[name], self.mesh)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        return gather_shard(local, self.specs[name], self.mesh)


# -- reductions over the batch axes inside a mesh step ----------------------

_BATCH: contextvars.ContextVar = contextvars.ContextVar("batch_group",
                                                        default=None)


@contextlib.contextmanager
def batch_reduction(group, size: int):
    """Inside the block the models' global batch statistics (the MoE's
    load-balance terms, a masked NLL's sums) are summed over ``group``, the
    process group of the mesh's batch axes, of ``size`` ranks."""
    token = _BATCH.set((group, size))
    try:
        yield
    finally:
        _BATCH.reset(token)


def batch_ranks() -> int:
    """The ranks of the active batch reduction (0 without one)."""
    active = _BATCH.get()
    return 0 if active is None else active[1]


class _AllReduceSum(torch.autograd.Function):
    """A differentiable all-reduce SUM: the gradient of every rank's copy of
    the sum flows back to every rank's term (an all-reduce of the
    gradients)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active batch reduction's ranks
    (differentiable); ``x`` itself without one."""
    active = _BATCH.get()
    if active is None:
        return x
    return _AllReduceSum.apply(x, active[0])


# -- a MoE routing the global batch inside a per-rank decode ---------------

_ROUTE: contextvars.ContextVar = contextvars.ContextVar("global_routing",
                                                        default=None)


@contextlib.contextmanager
def global_routing(spec: Sequence, mesh):
    """Inside the block a MoE routes the global batch as one dispatch
    group, as the reference's decode step does: its input's rows (dim 0,
    laid out by ``spec``'s first entry) are all-gathered over the batch
    axes, and each rank keeps its own rows of the output
    (``routed``/``own_rows``)."""
    token = _ROUTE.set((P(*(tuple(spec) + (None,))[:1]), mesh))
    try:
        yield
    finally:
        _ROUTE.reset(token)


def routed(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``x`` under ``global_routing``; ``x``
    itself without it."""
    active = _ROUTE.get()
    return x if active is None else gather_shard(x, *active)


def own_rows(y: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch ``y`` under ``global_routing``;
    ``y`` itself without it."""
    active = _ROUTE.get()
    return y if active is None else local_shard(y, *active)
