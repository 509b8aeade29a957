"""Noise modes — the graph-level vocabulary of the paper's noise language N.

The PyTorch port of the reference's graph-level modes (``repro.core.noise``,
where one pattern is one group of XLA ops inside the jitted step). Here every
mode's patterns are one CUDA kernel a call (``csrc/graph_noise.cu``): a
Python loop of PyTorch operations would launch one kernel a pattern, and k
launch gaps would absorb the noise they carry. Each mode is:

  make_state(generator)  allocate DISJOINT noise buffers on the modes'
                         device (the paper's R_n ∩ R_s = ∅ argument)
  apply(state, k)        k patterns, k static: the kernel's static build of
                         (mode, k), unrolled (the reference's trace-per-k
                         path) -> (aux, new_state)
  apply_rt(state, k)     the same patterns with k a run-time ``int`` (one
                         build serves a whole sweep); for k >= 1 the
                         arithmetic matches ``apply`` pattern for pattern;
                         only the k=0 aux differs (fp_add32 and vmem_ld:
                         the sum of the carried accumulators instead of 0)
                         (both take ``plain=True``: the kernels' plain
                         versions on any device, what a kernel is held
                         against)
  pattern_cost(hw)       per-pattern resource cost, for the analytic
                         saturation model (``core/analytic.py``)

States are dicts of tensors as the reference's are dicts of arrays, with
the same keys; ``convert.noise_state_to_torch`` turns a reference state
into the port's, so both packages can apply the same noise to the same
buffers. New states are written out of place, as JAX's are.

Buffer sizes: ``NoiseScale()`` is the reference's. On the card
``default_scale`` takes 256 MiB for hbm_stream's buffer and the chase
table (``CARD_SCALE``): the reference's 64 MiB and 16 MiB would sit in or
near the H100's 50 MB L2, and a "memory" pattern would not reach device
memory.

The ICI modes keep the reference's no-mesh branch (one device):
``ici_allreduce`` runs fp_add32's patterns on the (1,128) fallback state,
``ici_allgather`` and ``ici_a2a`` return sum(v). A mesh is refused: NCCL
collectives are ROADMAP's later work, and nothing here gives way to
another noise silently.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import torch

from repro_torch.core.loopnoise import chase_table
from repro_torch.kernels.graph_noise import kernel as gk

NOISE_SCOPE = "noise_pattern"

# Independent accumulator chains, like the paper's fadd d31/d30/d29/d28 round
# robin — keeps noise throughput-bound instead of latency-bound.
N_CHAINS = 4


@dataclasses.dataclass(frozen=True)
class PatternCost:
    """Per-pattern resource footprint on the target hardware."""
    flops: float = 0.0          # FLOPs issued per pattern
    hbm_bytes: float = 0.0      # HBM traffic per pattern
    ici_bytes: float = 0.0      # per-chip ICI traffic per pattern
    serial_s: float = 0.0       # unavoidable serial latency per pattern
    vmem_bytes: float = 0.0     # VMEM-local traffic (not an HBM cost)

    def time_on(self, hw) -> dict[str, float]:
        """Seconds this pattern adds to each resource timeline of one chip."""
        return {
            "compute": self.flops / hw.peak_flops,
            "memory": self.hbm_bytes / hw.hbm_bw,
            "ici": self.ici_bytes / hw.ici_bw,
            "latency": self.serial_s,
        }


@dataclasses.dataclass(frozen=True)
class NoiseMode:
    name: str
    target: str                              # compute | memory | latency | ici | vmem
    make_state: Callable[..., Any]           # generator -> state dict
    apply: Callable[[Any, int], tuple[torch.Tensor, Any]]
    pattern_cost: Callable[[Any], PatternCost]
    # runtime-k variant (compile-once sweeps); None = trace-per-k only
    apply_rt: Optional[Callable[[Any, int], tuple[torch.Tensor, Any]]] = None
    description: str = ""


@dataclasses.dataclass(frozen=True)
class NoiseScale:
    """Buffer sizing. Tests shrink these; benchmarks enlarge them."""
    vpu_rows: int = 8              # VPU tile (rows, 128) ~ one vreg row group
    mxu_dim: int = 128             # MXU-aligned square matmul
    vmem_rows: int = 64            # small resident buffer (stays in VMEM/L1)
    hbm_mib: int = 64              # dedicated streaming buffer (>> LLC)
    hbm_tile_rows: int = 256       # rows of 128 f32 per streaming pattern
    chase_len: int = 1 << 22       # pointer-chase table entries (16 MiB)
    ici_kib: int = 256             # collective noise buffer per pattern


# the card's sizes: both memory buffers 256 MiB, 5x the H100's 50 MB L2
CARD_SCALE = NoiseScale(hbm_mib=256, chase_len=1 << 26)


def default_scale(device) -> NoiseScale:
    """``CARD_SCALE`` on a CUDA device, the reference's sizes elsewhere."""
    return CARD_SCALE if torch.device(device).type == "cuda" else NoiseScale()


def _randn(generator, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Normal draws from a CPU generator, made on ``device`` (a device
    generator seeded from it, so the card's 256 MiB buffers need no host
    copy)."""
    gen = generator if generator is not None else torch.Generator()
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.randn(shape, generator=gen, dtype=torch.float32).to(dtype)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    dgen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=dgen, dtype=torch.float32,
                       device=dev).to(dtype)


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Compute noise
# ---------------------------------------------------------------------------

def _fp_add_state(generator=None, *, sc: NoiseScale, device):
    c = _randn(generator, (sc.vpu_rows, 128), device) * 1e-3
    return {"c": c, "accs": tuple(_zeros((sc.vpu_rows, 128), device)
                                  for _ in range(N_CHAINS))}


def _fp_add_apply(state, k: int, static: bool = True, plain: bool = False):
    aux, accs = gk.fp_add32(state["c"], state["accs"], k=k, static=static,
                            plain=plain)
    return aux, dict(state, accs=accs)


def _mxu_state(generator=None, *, sc: NoiseScale, device):
    d = sc.mxu_dim
    # c = identity: the chained product stays exactly bounded, and c is a
    # run-time buffer, so no compiler can simplify the product away
    return {"m": _randn(generator, (d, d), device, torch.bfloat16),
            "c": torch.eye(d, dtype=torch.bfloat16, device=device)}


def _mxu_apply(state, k: int, static: bool = True, plain: bool = False):
    aux, m = gk.mxu_fma128(state["m"], state["c"], k=k, static=static,
                           plain=plain)
    return aux, dict(state, m=m)


# ---------------------------------------------------------------------------
# Data-access noise
# ---------------------------------------------------------------------------

def _vmem_state(generator=None, *, sc: NoiseScale, device):
    return {"buf": _randn(generator, (sc.vmem_rows, 128), device),
            "accs": tuple(_zeros((8, 128), device) for _ in range(N_CHAINS))}


def _vmem_apply(state, k: int, static: bool = True, plain: bool = False):
    """l1_ld analogue: k re-reads of a small resident buffer at rotating
    offsets (shared memory on the card)."""
    aux, accs = gk.vmem_ld(state["buf"], state["accs"], k=k, static=static,
                           plain=plain)
    return aux, dict(state, accs=accs)


def _hbm_stream_state(generator=None, *, sc: NoiseScale, device):
    rows = sc.hbm_mib * (1 << 20) // 4 // 128
    return {"buf": _randn(generator, (rows, 128), device),
            "acc": _zeros((sc.hbm_tile_rows, 128), device)}


def _hbm_stream_apply(state, k: int, tile_rows: int, static: bool = True,
                      plain: bool = False):
    """memory_ld (bandwidth flavour): k streaming reads of a TILE from a
    dedicated buffer at stride-scattered offsets (defeats reuse within a
    call; every call reads the same k tiles, as the reference's, so on the
    card a call's tiles are L2 hits after the first call while k tiles fit
    in the 50 MB L2: k below about 380 at 128 KiB a tile)."""
    aux, acc = gk.hbm_stream(state["buf"], state["acc"], k=k,
                             tile_rows=tile_rows, static=static, plain=plain)
    return aux, dict(state, acc=acc)


def _chase_state(generator=None, *, sc: NoiseScale, device):
    # A random single-cycle permutation: idx -> table[idx] visits every entry.
    gen = generator if generator is not None else torch.Generator()
    dev = torch.device(device)
    if dev.type == "cpu":
        perm = torch.randperm(sc.chase_len, generator=gen)
    else:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        perm = torch.randperm(sc.chase_len, device=dev,
                              generator=torch.Generator(dev).manual_seed(seed))
    return {"table": chase_table(perm).to(torch.int32),
            "idx": perm[0].to(torch.int32),
            "acc": torch.zeros((), dtype=torch.int32, device=dev)}


def _chase_apply(state, k: int, static: bool = True, plain: bool = False):
    """memory_ld (latency flavour): k serially dependent 1-element gathers —
    the paper's chaotic pointer chase. The dependency chain is the point."""
    acc, idx, acc = gk.hbm_latency(state["table"], state["idx"], state["acc"],
                                   k=k, static=static, plain=plain)
    return acc, dict(state, idx=idx, acc=acc)


# ---------------------------------------------------------------------------
# ICI collective noise (per mesh axis): the no-mesh branch only
# ---------------------------------------------------------------------------

def _ici_state(generator=None, *, sc: NoiseScale, device):
    n = sc.ici_kib * 1024 // 4
    return {"v": _randn(generator, (n,), device)}


def _no_mesh(mesh, name: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{name} over a device mesh needs NCCL collectives, which the "
            "port does not have yet (ROADMAP: the ICI modes over "
            "torch.distributed); without a mesh it runs the reference's "
            "no-mesh branch")


_FALLBACK_ACCS: dict = {}


def _fallback_accs(device) -> tuple:
    """The (1,128) zero accumulators of the ici modes' fallback state."""
    key = str(device)
    if key not in _FALLBACK_ACCS:
        z = _zeros((1, 128), device)
        _FALLBACK_ACCS[key] = (z,) * N_CHAINS
    return _FALLBACK_ACCS[key]


def _ici_allreduce_apply(state, k: int, static: bool = True,
                        plain: bool = False):
    """No mesh: degrade to vpu work, fp_add32's patterns on c = v[:128] *
    1e-3 and zero (1,128) accumulators; the state is unchanged."""
    v = state["v"]
    aux, _ = gk.fp_add32(v, _fallback_accs(v.device), k=k, static=static,
                         ici=True, plain=plain)
    return aux, state


def _ici_sum_apply(state, k: int, static: bool = True, plain: bool = False):
    """No mesh (all-gather, all-to-all): sum(v), no noise pattern; the
    state is unchanged."""
    return torch.sum(state["v"]), state


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def make_modes(scale: Optional[NoiseScale] = None, *, mesh=None,
               ici_axis: str = "model", device="cuda") -> dict[str, NoiseMode]:
    """The standard noise-mode registry at a given scale (default:
    ``default_scale(device)``), its states made on ``device`` (the card
    unless the caller asks for the CPU). ``mesh``: refused by the ICI modes
    (one device: their no-mesh branch)."""
    sc = scale if scale is not None else default_scale(device)
    dev = torch.device(device)

    def _c(**kw):
        return lambda hw: PatternCost(**kw)

    def state(fn):
        return partial(fn, sc=sc, device=dev)

    def ici(fn, name, static=True):
        def apply(s, k, plain=False):
            _no_mesh(mesh, name)
            return fn(s, k, static=static, plain=plain)
        return apply

    vpu_flops = sc.vpu_rows * 128
    mxu_flops = 2 * sc.mxu_dim ** 3
    tile_bytes = sc.hbm_tile_rows * 128 * 4
    ici_bytes = sc.ici_kib * 1024

    modes = {
        "fp_add32": NoiseMode(
            "fp_add32", "compute", state(_fp_add_state), _fp_add_apply,
            _c(flops=vpu_flops),
            apply_rt=partial(_fp_add_apply, static=False),
            description="chained FP32 vector adds on disjoint f32 tiles "
                        "(paper: fp_add64)"),
        "mxu_fma128": NoiseMode(
            "mxu_fma128", "compute", state(_mxu_state), _mxu_apply,
            _c(flops=mxu_flops, vmem_bytes=2 * sc.mxu_dim ** 2),
            apply_rt=partial(_mxu_apply, static=False),
            description="chained 128x128 bf16 matmuls — stresses the tensor "
                        "cores"),
        "vmem_ld": NoiseMode(
            "vmem_ld", "vmem", state(_vmem_state), _vmem_apply,
            _c(flops=8 * 128, vmem_bytes=8 * 128 * 4),
            apply_rt=partial(_vmem_apply, static=False),
            description="re-reads of a shared-memory-resident tile "
                        "(paper: l1_ld64)"),
        "hbm_stream": NoiseMode(
            "hbm_stream", "memory", state(_hbm_stream_state),
            partial(_hbm_stream_apply, tile_rows=sc.hbm_tile_rows),
            _c(flops=tile_bytes / 4, hbm_bytes=tile_bytes),
            apply_rt=partial(_hbm_stream_apply, tile_rows=sc.hbm_tile_rows,
                             static=False),
            description="streaming tile reads from a dedicated device-"
                        "memory buffer (bandwidth)"),
        "hbm_latency": NoiseMode(
            "hbm_latency", "latency", state(_chase_state), _chase_apply,
            lambda hw: PatternCost(hbm_bytes=4.0, serial_s=hw.hbm_latency_s),
            apply_rt=partial(_chase_apply, static=False),
            description="serially dependent pointer chase (paper: "
                        "memory_ld64 chaotic)"),
        "ici_allreduce": NoiseMode(
            "ici_allreduce", "ici", state(_ici_state),
            ici(_ici_allreduce_apply, "ici_allreduce"),
            _c(ici_bytes=2 * ici_bytes),   # ring all-reduce ≈ 2(n-1)/n·B
            apply_rt=ici(_ici_allreduce_apply, "ici_allreduce", static=False),
            description=f"chained psum over mesh axis {ici_axis!r} on a "
                        "disjoint buffer"),
        "ici_allgather": NoiseMode(
            "ici_allgather", "ici", state(_ici_state),
            ici(_ici_sum_apply, "ici_allgather"), _c(ici_bytes=ici_bytes),
            apply_rt=ici(_ici_sum_apply, "ici_allgather", static=False),
            description=f"chained all-gather over mesh axis {ici_axis!r}"),
        "ici_a2a": NoiseMode(
            "ici_a2a", "ici", state(_ici_state),
            ici(_ici_sum_apply, "ici_a2a"), _c(ici_bytes=ici_bytes),
            apply_rt=ici(_ici_sum_apply, "ici_a2a", static=False),
            description=f"chained all-to-all over mesh axis {ici_axis!r}"),
    }
    return modes


# Paper-facing aliases (AArch64 names -> the graph-level modes).
PAPER_ALIASES = {
    "fp_add64": "fp_add32",
    "l1_ld64": "vmem_ld",
    "memory_ld64": "hbm_stream",
    "memory_chase": "hbm_latency",
}
