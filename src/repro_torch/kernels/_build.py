"""Build and load the port's CUDA kernels (``nvcc`` → shared library →
``ctypes``).

Two builds of every kernel, both from ``src/repro_torch/csrc/``:

* **runtime k** — one shared library holding every kernel, each templated
  on its noise mode, with k a plain ``int`` argument clipped to [0, K_MAX].
  Each ``.cu`` compiles to an object in its own ``nvcc`` process, all
  started together, and one ``nvcc -shared`` links them;
* **static k** — one library per (kernel, mode, k), compiled with
  ``-DREPRO_STATIC_MODE=<mode id> -DREPRO_STATIC_K=<k>`` so the noise loop
  is fully unrolled: the trace-per-k fallback and the payload-check build.
  A kernel with several variants (attention: head dim and element type)
  adds its own ``-D`` defines, so a static build compiles the one variant
  it is launched for.

Libraries land in ``build/repro_torch/`` at the repository root, named by a
hash of every source file, so an edited source rebuilds and an unchanged one
is loaded as it is. Builds happen at first use, never at import. Every C
entry point returns ``cudaGetLastError()`` as an int; ``launch`` raises
when it is not 0. There is no fallback: without ``nvcc`` a build raises.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build",
                         "repro_torch")
KERNEL_SOURCES = ("noise_probes", "spmv_ell", "noisy_matmul", "flash_attention")

# no fast-math: the fp noise chain of k adds must not fold into k*c
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCKS: dict[str, threading.Lock] = {}   # one per library: builds of
_LOCKS_GUARD = threading.Lock()          # different libraries run together


def _lock_for(path: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(path, threading.Lock())


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else the toolkit's default location; raises
    when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc;"
                       " the CUDA kernels cannot be built")


@functools.lru_cache(maxsize=1)
def source_hash() -> str:
    """Hash of every CUDA source and of the compiler flags (read once per
    process: every launch names its library by it)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode:
            errors.append(f"$ {' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    _LIBS[path] = lib
    return lib


def runtime_lib_path() -> str:
    """Where the runtime-k library of the current sources lives."""
    return os.path.join(BUILD_DIR, f"librepro_rt_{source_hash()}.so")


def runtime_lib() -> ctypes.CDLL:
    """The runtime-k library of every kernel, built on first use."""
    path = runtime_lib_path()
    with _lock_for(path):
        if path in _LIBS:
            return _LIBS[path]
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = nvcc_path()
            tag = f"{os.getpid()}.{threading.get_ident()}"
            objs = [os.path.join(BUILD_DIR, f"{name}.{tag}.o")
                    for name in KERNEL_SOURCES]
            _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                   os.path.join(CSRC, f"{name}.cu")]
                  for name, obj in zip(KERNEL_SOURCES, objs)])
            tmp = f"{path}.{tag}.tmp"
            _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
            for obj in objs:
                os.remove(obj)
            os.replace(tmp, path)   # atomic: no reader sees a partial file
        return _load(path)


def static_lib_path(kernel: str, mode_id: int, k: int,
                    defines: tuple = ()) -> str:
    """Where the static-k library of one (kernel, mode, k[, variant
    defines]) lives."""
    variant = "".join(f"_{name.lower()}{value}" for name, value in defines)
    return os.path.join(
        BUILD_DIR,
        f"librepro_{kernel}_m{mode_id}_k{k}{variant}_{source_hash()}.so")


def static_lib(kernel: str, mode_id: int, k: int,
               defines: tuple = ()) -> ctypes.CDLL:
    """The static-k library of one (kernel, mode, k), built on first use;
    ``defines``: ((name, value), ...) selecting the kernel's variant."""
    if kernel not in KERNEL_SOURCES:
        raise ValueError(f"unknown kernel source {kernel!r}")
    path = static_lib_path(kernel, mode_id, k, defines)
    with _lock_for(path):
        if path in _LIBS:
            return _LIBS[path]
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            _run([[nvcc_path(), *NVCC_FLAGS, "-shared",
                   f"-DREPRO_STATIC_MODE={mode_id}", f"-DREPRO_STATIC_K={k}",
                   *(f"-D{name}={value}" for name, value in defines),
                   "-o", tmp, os.path.join(CSRC, f"{kernel}.cu")]])
            os.replace(tmp, path)   # atomic: no reader sees a partial file
        return _load(path)


def _bind(lib: ctypes.CDLL, name: str, n_ptrs: int, n_ints: int):
    """The C entry ``name`` with its signature declared: ``n_ptrs`` device
    pointers, ``n_ints`` ints, then the stream; returns a cudaError_t."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch(kernel: str, entry: str, tensors, ints, *, mode_id: int, k: int,
           static: bool, defines: tuple = ()) -> None:
    """Launch one kernel on the current stream of the tensors' device.

    ``static``: ``repro_<entry>_static`` of the (kernel, mode, k,
    ``defines``) build; else ``repro_<entry>_rt`` of the runtime-k library,
    with the mode and ``k`` passed after ``ints``. Raises when the entry
    reports a CUDA error."""
    dev = tensors[0].device
    ptrs = [t.data_ptr() for t in tensors]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if static:
            fn = _bind(static_lib(kernel, mode_id, k if mode_id else 0,
                                  defines),
                       f"repro_{entry}_static", len(ptrs), len(ints))
            err = fn(*ptrs, *ints, stream)
        else:
            fn = _bind(runtime_lib(), f"repro_{entry}_rt", len(ptrs),
                       len(ints) + 2)
            err = fn(*ptrs, *ints, mode_id, int(k), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} (mode {mode_id}, k={k}): CUDA error "
                           f"{err} at launch")


def on_card(t) -> bool:
    """True for a CUDA tensor (the wrapper launches its kernel), False for a
    CPU tensor (the wrapper takes its plain version); raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensors on {t.device} are not supported")


def sass_count(path: str, opcode: str) -> Optional[int]:
    """How many SASS instructions of ``opcode`` (e.g. ``FADD``) a built
    library holds, from ``cuobjdump -sass``; None when the toolkit has no
    ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    # e.g. "        /*0090*/   @P0 FADD R5, R5, R4 ;   /* 0x000... */"
    pat = re.compile(rf"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                     rf"{re.escape(opcode)}(?:\.\S+)?\s")
    return sum(1 for line in out.splitlines() if pat.match(line))
