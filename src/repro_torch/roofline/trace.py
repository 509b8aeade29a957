"""The op trace of one eager program: the port's counterpart of the
roofline half of the reference's ``repro.hlo.parse``.

The reference lowers and compiles a cell's program and parses the
optimized HLO text. PyTorch has no HLO: the port runs the program itself,
rank 0's per-rank program, on meta tensors (nothing is allocated) under
``OpTrace``, a ``TorchDispatchMode`` that records one ``OpRecord`` per
aten op that runs, collectives included. Counterparts:

  parse_module         -> ``OpTrace.ops``, the recorded op list (one entry
                          per op that ran, in the order it ran);
  nesting_multipliers  -> none: the eager program has no loops to
                          multiply; the microbatch and layer loops are
                          unrolled by running them, so every executed op
                          is recorded once;
  shape_bytes          -> ``TensorInfo.nbytes``: numel x element size,
                          capped at the bytes of the tensor's storage (an
                          expanded view reads its storage once);
  replica_groups       -> ``OpRecord.group_size``: the size of the process
                          group a c10d op ran on.

Each record holds the op's name, its tensor operands' and results'
shapes and dtypes, whether it is a view or alias, whether it writes in
place and the bytes it writes there, and, for an f32 product, whether
TF32 was allowed when it ran. ``OpTrace`` also keeps the live bytes of
the storages that the traced ops create, and their peak
(``weakref.finalize`` on each new storage: it fires when the last tensor
on it dies).

The same mode records a run on the card, so a trace on meta can be held
against the ops the card ran (``signature``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops whose result is metadata over an existing storage, or an empty
# allocation: no memory traffic (the reference's _SKIP_TRAFFIC:
# parameter, bitcast, reshape, broadcast, ...)
FREE_OPS = frozenset({
    "aten._unsafe_view.default", "aten.lift_fresh.default",
    "aten.empty.memory_format", "aten.empty_like.default",
    "aten.empty_strided.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.set_.source_Storage",
    "aten.set_.source_Storage_storage_offset", "aten.resize_.default",
    "aten._reshape_alias.default",
})


# the products (the reference's dot and convolution); an f32 product's
# record keeps whether TF32 may run it
PRODUCTS = frozenset({"aten.mm.default", "aten.addmm.default",
                      "aten.bmm.default", "aten.baddbmm.default",
                      "aten.convolution.default"})


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    shape: tuple
    dtype: str
    nbytes: int          # numel x element size, capped at the storage's


@dataclasses.dataclass
class OpRecord:
    name: str                       # "aten.mm.default", "c10d.allreduce_..."
    inputs: tuple                   # TensorInfo of each tensor operand
    outputs: tuple                  # TensorInfo of each tensor result
    view: bool                      # a view or alias of an operand
    inplace: bool                   # writes into an operand
    written: tuple = ()             # indices into ``inputs`` written in place
    group_size: Optional[int] = None   # c10d ops: the process group's size
    tf32: bool = False              # f32 products: TF32 allowed at run time

    def signature(self) -> tuple:
        """What two runs of one program must agree on: the name and the
        operands' and results' shapes and dtypes."""
        return (self.name,
                tuple((t.shape, t.dtype) for t in self.inputs),
                tuple((t.shape, t.dtype) for t in self.outputs))


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results, in order (lists and
    tuples flattened)."""
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            out.extend(_tensors(x))
    elif isinstance(tree, dict):
        for x in tree.values():
            out.extend(_tensors(x))
    return out


def info(t: torch.Tensor) -> TensorInfo:
    nbytes = t.numel() * t.element_size()
    try:
        nbytes = min(nbytes, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):   # no storage (sparse)
        pass
    return TensorInfo(tuple(t.shape), str(t.dtype).replace("torch.", ""),
                      nbytes)


def _group_size(args) -> Optional[int]:
    """The size of the process group among a c10d op's arguments."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue
    return None


# func -> (name, is a view, the (position, name) of each argument it
# writes by its schema's alias annotations, ``Tensor(a!)``)
_FUNCS: dict = {}


def _func_info(func) -> tuple:
    got = _FUNCS.get(func)
    if got is None:
        written = tuple((i, a.name)
                        for i, a in enumerate(func._schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
        got = _FUNCS[func] = (str(func), bool(getattr(func, "is_view", False)),
                              written)
    return got


def _written_args(written, args, kwargs) -> list:
    """The tensor arguments at ``written``'s positions or names."""
    out = []
    for i, name in written:
        out.extend(_tensors(args[i] if i < len(args) else kwargs.get(name)))
    return out


class OpTrace(TorchDispatchMode):
    """Records every aten op run inside the block (see the module
    docstring). ``ops``: the records; ``live_bytes`` / ``peak_bytes``: the
    bytes of the storages that the traced ops created and that are still
    alive, now and at their peak."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._owned: set = set()

    def _released(self, key: int, nbytes: int) -> None:
        self._owned.discard(key)
        self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(s)
        if key in self._owned or s.nbytes() == 0:
            return
        self._owned.add(key)
        self.live_bytes += s.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._released, key, s.nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, is_view, written = _func_info(func)
        ins = _tensors(args) + _tensors(kwargs) if kwargs else _tensors(args)
        in_infos = tuple(info(t) for t in ins)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        written_ids = ()
        if written:
            wrote = _written_args(written, args, kwargs)
            written_ids = tuple(i for i, t in enumerate(ins)
                                if any(t is w for w in wrote))
        self.ops.append(OpRecord(
            name=name, inputs=in_infos,
            outputs=tuple(info(t) for t in outs), view=is_view,
            inplace=bool(written), written=written_ids,
            group_size=(_group_size(args) if name.startswith("c10d.")
                        else None),
            tf32=(name in PRODUCTS
                  and (torch.get_float32_matmul_precision() != "highest"
                       or torch.backends.cuda.matmul.allow_tf32))))
        if not is_view and outs:
            held = {id(t.untyped_storage()) for t in ins
                    if t.layout == torch.strided}
            for t in outs:
                if t.layout == torch.strided \
                        and id(t.untyped_storage()) not in held:
                    self._track(t)
        return out

    # ------------------------------------------------------------------
    def signatures(self) -> list:
        return [r.signature() for r in self.ops]


def tensors_of(x: Any) -> list:
    """Every tensor of a tree (dicts, lists, tuples, modules' parameters,
    dataclasses' fields), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors_of(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors_of(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in tensors_of(getattr(x, f.name))]
    return []


def tensor_bytes(tree: Any, exclude: Any = ()) -> int:
    """The bytes of every tensor in ``tree``, each storage once, leaving
    out the storages of ``exclude``'s tensors."""
    seen = {id(t.untyped_storage()) for t in tensors_of(exclude)}
    total = 0
    for t in tensors_of(tree):
        if id(t.untyped_storage()) not in seen:
            seen.add(id(t.untyped_storage()))
            total += t.numel() * t.element_size()
    return total
