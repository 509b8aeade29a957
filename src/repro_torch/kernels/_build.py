"""Build and load the port's CUDA kernels (``nvcc`` → shared library →
``ctypes``).

Two builds of every kernel, both from ``src/repro_torch/csrc/``:

* **runtime k** — one shared library holding every kernel, each templated
  on its noise mode, with k a plain ``int`` argument clipped to [0, K_MAX].
  Each ``.cu`` compiles to an object in its own ``nvcc`` process, all
  started together, and one ``nvcc -shared`` links them; ptxas's register
  and spill report of every kernel (``-Xptxas -v``) is kept beside the
  library (``ptxas_usage``);
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

``launch`` is the host path every wrapper call takes, so it stays lean: the
bound C entry is looked up once per (kernel, entry, build) and kept, the
stream is the raw handle of the current one, and the device guard is
entered only for tensors off the current device. The ctypes route is kept
(``torch.utils.cpp_extension`` builds take minutes), and no CUDA graph
stands in for the call: a sweep times one dispatched call per point, as
the reference does.

The static noise audit (``repro_torch.analysis``) reads the SASS of static
builds (``site_sass``: a ``SassSite`` names the build and the functions
that carry a region's noise). ``REPRO_NOISE_SABOTAGE=const`` (the audit's
fail-fast switch; never set in a measuring run) reaches every static build
as ``-DREPRO_NOISE_SABOTAGE=1`` and tags its library's path, so a
sabotaged library is never loaded in place of a clean one.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import json
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
# the four Pallas kernels' counterparts, the paper's validation loops
# (csrc/loop_regions.cu: STREAM, lat_mem_rd, HACCmk, SPMXV, matmul O0/O3),
# its DECAN loops (csrc/decan_loops.cu: Table 3, Fig. 6) and the graph-level
# noise modes (csrc/graph_noise.cu)
KERNEL_SOURCES = ("noise_probes", "spmv_ell", "noisy_matmul", "flash_attention",
                  "loop_regions", "decan_loops", "graph_noise")

# no fast-math: the fp noise chain of k adds must not fold into k*c
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCKS: dict[str, threading.Lock] = {}   # one per library: builds of
_LOCKS_GUARD = threading.Lock()          # different libraries run together


def use_sources(sources: tuple, build_dir: str) -> None:
    """From now on build only ``sources`` (names in ``KERNEL_SOURCES``), into
    ``build_dir``: for a tool that measures a few kernels without building
    the rest, or the library the main path loads."""
    global KERNEL_SOURCES, BUILD_DIR
    unknown = set(sources) - set(KERNEL_SOURCES)
    if unknown:
        raise ValueError(f"unknown kernel sources {sorted(unknown)}")
    KERNEL_SOURCES, BUILD_DIR = tuple(sources), build_dir


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


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands together; their merged stdout and stderr, in order.
    Raises with the output of every command that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, errors = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode:
            errors.append(f"$ {' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return outs


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
        if not (os.path.exists(path) and os.path.exists(_usage_path(path))):
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = nvcc_path()
            tag = f"{os.getpid()}.{threading.get_ident()}"
            objs = [os.path.join(BUILD_DIR, f"{name}.{tag}.o")
                    for name in KERNEL_SOURCES]
            outs = _run([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                          obj, os.path.join(CSRC, f"{name}.cu")]
                         for name, obj in zip(KERNEL_SOURCES, objs)])
            usage = {name: _parse_ptxas(out, nvcc)
                     for name, out in zip(KERNEL_SOURCES, outs)}
            with open(f"{path}.{tag}.ptxas", "w") as f:
                json.dump(usage, f)
            os.replace(f"{path}.{tag}.ptxas", _usage_path(path))
            tmp = f"{path}.{tag}.tmp"
            _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
            for obj in objs:
                os.remove(obj)
            os.replace(tmp, path)   # atomic: no reader sees a partial file
        return _load(path)


def _usage_path(lib_path: str) -> str:
    return lib_path[:-len(".so")] + ".ptxas.json"


def _parse_ptxas(out: str, nvcc: str) -> dict:
    """{kernel entry: [registers, spill store bytes, spill load bytes]}
    from ``-Xptxas -v`` output; entries are demangled when the toolkit has
    ``cu++filt``."""
    usage, entry, spills = {}, None, [0, 0]
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            usage[entry] = [int(m.group(1)), *spills]
            entry, spills = None, [0, 0]
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if usage and os.path.isfile(filt):
        names = subprocess.run([filt], input="\n".join(usage), text=True,
                               capture_output=True, check=True).stdout
        usage = dict(zip(names.splitlines(), usage.values()))
    return usage


def ptxas_usage(kernel: str) -> dict:
    """{kernel entry: [registers, spill store bytes, spill load bytes]} of
    every entry in ``csrc/<kernel>.cu`` as the runtime-k build compiled it
    (its ``-Xptxas -v`` output, kept beside the library)."""
    path = runtime_lib_path()
    if not os.path.exists(_usage_path(path)):
        runtime_lib()
    with open(_usage_path(path)) as f:
        return json.load(f)[kernel]


SABOTAGE_VAR = "REPRO_NOISE_SABOTAGE"
SABOTAGE_DEFINE = ("REPRO_NOISE_SABOTAGE", 1)


def sabotaged() -> bool:
    """True when ``REPRO_NOISE_SABOTAGE=const`` asks the static builds for a
    payload nvcc removes (the audit's fail-fast switch)."""
    return os.environ.get(SABOTAGE_VAR) == "const"


def _with_sabotage(defines: tuple, sabotage: Optional[bool]) -> tuple:
    if sabotaged() if sabotage is None else sabotage:
        return (*defines, SABOTAGE_DEFINE)
    return tuple(defines)


def static_lib_path(kernel: str, mode_id: int, k: int,
                    defines: tuple = (), *,
                    sabotage: Optional[bool] = None) -> str:
    """Where the static-k library of one (kernel, mode, k[, variant
    defines]) lives; ``sabotage`` (default: the environment's switch) tags
    the sabotaged build's path."""
    defines = _with_sabotage(defines, sabotage)
    variant = "".join(f"_{name.lower()}{value}" for name, value in defines)
    return os.path.join(
        BUILD_DIR,
        f"librepro_{kernel}_m{mode_id}_k{k}{variant}_{source_hash()}.so")


def static_build(kernel: str, mode_id: int, k: int, defines: tuple = (), *,
                 sabotage: Optional[bool] = None) -> str:
    """Build (if it is not there) the static-k library of one (kernel, mode,
    k[, variant]) without loading it; returns its path. Its ``-Xptxas -v``
    output is kept beside it (``static_ptxas_usage``)."""
    if kernel not in KERNEL_SOURCES:
        raise ValueError(f"unknown kernel source {kernel!r}")
    path = static_lib_path(kernel, mode_id, k, defines, sabotage=sabotage)
    with _lock_for(path):
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            nvcc = nvcc_path()
            (out,) = _run([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                            f"-DREPRO_STATIC_MODE={mode_id}",
                            f"-DREPRO_STATIC_K={k}",
                            *(f"-D{name}={value}" for name, value
                              in _with_sabotage(defines, sabotage)),
                            "-o", tmp, os.path.join(CSRC, f"{kernel}.cu")]])
            with open(f"{tmp}.ptxas", "w") as f:
                json.dump(_parse_ptxas(out, nvcc), f)
            os.replace(f"{tmp}.ptxas", _usage_path(path))
            os.replace(tmp, path)   # atomic: no reader sees a partial file
    return path


def static_ptxas_usage(path: str) -> dict:
    """{kernel entry: [registers, spill store bytes, spill load bytes]} of
    the static-k library at ``path`` (``static_build``'s ``-Xptxas -v``)."""
    with open(_usage_path(path)) as f:
        return json.load(f)


def static_lib(kernel: str, mode_id: int, k: int,
               defines: tuple = ()) -> ctypes.CDLL:
    """The static-k library of one (kernel, mode, k), built on first use;
    ``defines``: ((name, value), ...) selecting the kernel's variant."""
    path = static_build(kernel, mode_id, k, defines)
    with _lock_for(path):
        if path in _LIBS:
            return _LIBS[path]
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


# (kernel, entry, static, mode id, k, defines) -> the bound C entry; the
# runtime-k entries are keyed with mode and k at -1 (they take both as
# arguments). Filled at a launch's first call, read without a lock after.
_ENTRIES: dict = {}


def _entry(kernel: str, entry: str, n_ptrs: int, n_ints: int, mode_id: int,
           k: int, static: bool, defines: tuple):
    key = ((kernel, entry, True, mode_id, k, defines, sabotaged())
           if static else (kernel, entry, False, -1, -1, ()))
    fn = _ENTRIES.get(key)
    if fn is None:
        if static:
            fn = _bind(static_lib(kernel, mode_id, k, defines),
                       f"repro_{entry}_static", n_ptrs, n_ints)
        else:
            fn = _bind(runtime_lib(), f"repro_{entry}_rt", n_ptrs,
                       n_ints + 2)
        _ENTRIES[key] = fn
    return fn


def stream_handle(device_index: int) -> int:
    """The raw handle of the device's current stream, without building a
    ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def launch(kernel: str, entry: str, tensors, ints, *, mode_id: int, k: int,
           static: bool, defines: tuple = (),
           stream: Optional[int] = None) -> None:
    """Launch one kernel on ``stream`` (default: the current stream of the
    tensors' device).

    ``static``: ``repro_<entry>_static`` of the (kernel, mode, k,
    ``defines``) build; else ``repro_<entry>_rt`` of the runtime-k library,
    with the mode and ``k`` passed after ``ints``. The device guard is
    entered only when the tensors' device is not the current one. Raises
    when the entry reports a CUDA error."""
    dev = tensors[0].get_device()
    if stream is None:
        stream = stream_handle(dev)
    if static:
        k = k if mode_id else 0
        fn = _entry(kernel, entry, len(tensors), len(ints), mode_id, k, True,
                    defines)
        args = (*[t.data_ptr() for t in tensors], *ints, stream)
    else:
        fn = _entry(kernel, entry, len(tensors), len(ints), mode_id, k,
                    False, ())
        args = (*[t.data_ptr() for t in tensors], *ints, mode_id, int(k),
                stream)
    if dev == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
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


def cuobjdump_path() -> Optional[str]:
    """``cuobjdump`` beside ``nvcc``; None when the toolkit (or it) is
    missing."""
    try:
        tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    except RuntimeError:
        return None
    return tool if os.path.isfile(tool) else None


_DUMPS: dict[str, str] = {}


def sass_dump(path: str) -> Optional[str]:
    """``cuobjdump -sass`` of a built library (read once per process); None
    when the toolkit has no ``cuobjdump``."""
    if path in _DUMPS:
        return _DUMPS[path]
    tool = cuobjdump_path()
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    _DUMPS[path] = out
    return out


@dataclasses.dataclass(frozen=True)
class SassSite:
    """Where a region's noise lives in SASS for one (mode, k): the static
    build of ``source`` (``csrc/<source>.cu``) at ``mode_id`` and ``k``
    with the variant ``defines``, the functions that carry the noise
    (``kernels``) and the other functions one call launches (``aux``),
    each as (base name, mangled-tail prefix; "" for any instance). ``body``:
    whether the kernel is the region's own body (False for a step region,
    whose body is a CUDA graph of library kernels). ``unroll``: the
    region's iterations one pass of the kernel's innermost loop runs, which
    |body| is divided by."""
    source: str
    mode_id: int
    k: int
    defines: tuple = ()
    kernels: tuple = ()
    aux: tuple = ()
    body: bool = True
    sabotage: Optional[bool] = None
    unroll: int = 1


def site_sass(site: SassSite) -> Optional[str]:
    """The SASS of a site's functions (``kernels`` and ``aux``), its static
    library built first if needed; None without ``cuobjdump``."""
    from repro_torch.sass.parse import select

    path = static_build(site.source, site.mode_id, site.k, site.defines,
                        sabotage=site.sabotage)
    text = sass_dump(path)
    if text is None:
        return None
    return select(text, site.kernels + site.aux)


def sass_census(path: str, opcode: str) -> Optional[dict]:
    """{function: {opcode with its modifiers: count}} of the SASS
    instructions of ``opcode`` (e.g. ``LDG`` counts ``LDG.E`` and
    ``LDG.E.STRONG.SM`` apart) in each function of a built library, from
    ``cuobjdump -sass``; functions by their mangled names. None when the
    toolkit has no ``cuobjdump``."""
    out = sass_dump(path)
    if out is None:
        return None
    # e.g. "        /*0090*/   @P0 FADD R5, R5, R4 ;   /* 0x000... */"
    pat = re.compile(rf"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                     rf"({re.escape(opcode)}(?:\.\S+)?)\s")
    census: dict = {}
    ops = census.setdefault("", {})
    for line in out.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            ops = census.setdefault(m.group(1), {})
            continue
        m = pat.match(line)
        if m:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return {fn: c for fn, c in census.items() if fn or c}


def sass_count(path: str, opcode: str) -> Optional[int]:
    """How many SASS instructions of ``opcode`` (e.g. ``FADD``) a built
    library holds in all; None when the toolkit has no ``cuobjdump``."""
    census = sass_census(path, opcode)
    if census is None:
        return None
    return sum(sum(ops.values()) for ops in census.values())
