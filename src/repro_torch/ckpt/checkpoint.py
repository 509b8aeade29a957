"""Async, atomic checkpointing of a training state, with elastic
reshard-on-load.

PyTorch port of the reference's ``repro.ckpt.checkpoint``. A state is its
named tensors (``TrainState.tensors()``, or a plain dict of tensors): each
is stored in its logical (unsharded) layout as a host numpy array in a
``leaf_NNNNN.npy``, with a manifest of the step, a fingerprint of the names
and logical shapes, and each leaf's name, shape and dtype. bf16 does not
survive ``np.save``, so it is stored as same-width integers and carried
back bit for bit. The fingerprint is the port's own; the reference's
checkpoints are not read.

A sharded state (one with a ``layout``: the trainer's mesh path) is saved
by every rank together: each leaf is all-gathered, one at a time, and rank
0 writes it; ``wait()`` then holds every rank at a barrier until the write
is done. Restore reads the logical leaves on every rank and cuts each
rank's shard of ``like``'s layout out of them, so a checkpoint saved on
one mesh resumes on another mesh or on one device.

Atomicity: write to ``step_N.tmp`` then ``os.rename`` — a crash mid-save
never corrupts the latest checkpoint. Async: the host snapshot is taken
synchronously (a copy: the trainer updates its tensors in place), the disk
write runs on a worker thread, ``wait()`` joins it and re-raises its error.
Retention: the ``keep`` newest. ``restore`` writes the stored values INTO
the tensors of ``like`` (in place: a full-width state is not held twice)
and returns it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

# torch dtypes numpy holds; any other (bf16, the f8s) is stored as the
# unsigned integers of its width, as the reference stores them
_NATIVE = {torch.float16, torch.float32, torch.float64, torch.int8,
           torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool}
_INT_OF = {1: torch.int8, 2: torch.int16}
_UINT_OF = {1: np.uint8, 2: np.uint16}


def _tensors(state: Any) -> dict:
    return state if isinstance(state, dict) else state.tensors()


def _layout(state: Any):
    return None if isinstance(state, dict) else getattr(state, "layout",
                                                        None)


def _shapes(tensors: dict, layout) -> dict:
    """Every leaf's logical shape."""
    if layout is not None:
        return {name: list(layout.shapes[name]) for name in tensors}
    return {name: list(t.shape) for name, t in tensors.items()}


def _fingerprint(shapes: dict) -> str:
    s = json.dumps([[name, shape] for name, shape in shapes.items()])
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy (the caller's tensor may change while it is written)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype in _NATIVE:
        return t.numpy()
    width = t.element_size()
    return t.view(_INT_OF[width]).numpy().view(_UINT_OF[width])


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype in _NATIVE:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(f"i{a.dtype.itemsize}")).view(dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False     # a sharded save: every rank meets at wait()

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = True) -> None:
        self.wait()
        tensors = _tensors(state)
        layout = _layout(state)
        shapes = _shapes(tensors, layout)
        manifest = {"step": step, "fingerprint": _fingerprint(shapes),
                    "n_leaves": len(tensors),
                    "leaves": [{"name": name, "shape": shapes[name],
                                "dtype": str(t.dtype).removeprefix("torch.")}
                               for name, t in tensors.items()]}
        if layout is None:
            host = {name: _to_host(t) for name, t in tensors.items()}
        else:                       # every rank gathers; rank 0 writes
            writer = dist.get_rank() == 0
            host = {}
            for name, t in tensors.items():
                full = layout.gather(name, t)
                if writer:
                    host[name] = _to_host(full)
                del full
            self._barrier = True
            if not writer:
                if blocking:
                    self.wait()
                return

        def work():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, a in enumerate(host.values()):
                    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a,
                            allow_pickle=False)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:      # surfaced on the next wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:           # the sharded save is on disk for all
            self._barrier = False
            dist.barrier()
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, step: int, *, like: Any) -> Any:
        """Load checkpoint ``step`` into the tensors of ``like`` (in place,
        each keeping its dtype and device; a sharded ``like`` takes its
        shards of the logical leaves) and return ``like``."""
        self.wait()
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        tensors = _tensors(like)
        layout = _layout(like)
        if manifest["fingerprint"] != _fingerprint(_shapes(tensors, layout)):
            raise ValueError("checkpoint tree structure mismatch "
                             f"(ckpt step {step})")
        with torch.no_grad():
            for i, ((name, t), rec) in enumerate(zip(tensors.items(),
                                                     manifest["leaves"])):
                a = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
                src = _from_host(a, getattr(torch, rec["dtype"]))
                if layout is not None:
                    src = layout.local(name, src)
                t.copy_(src.to(t.dtype))
        return like

    def restore_latest(self, *, like: Any) -> tuple[Optional[Any], int]:
        steps = self.steps()
        if not steps:
            return None, 0
        s = steps[-1]
        return self.restore(s, like=like), s
