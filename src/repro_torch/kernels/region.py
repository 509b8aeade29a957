"""``pallas_region`` — RegionTargets over the port's kernel layer.

The name is the reference's, so region names, mode names and campaign
stores compare directly between the packages; the kernels behind it are the
port's hand-written CUDA (``csrc/``), or their plain PyTorch versions for
tensors on the CPU:

  * ``build(mode, k)``  — one static-k build (trace-per-k fallback);
  * ``build_rt(mode)``  — ONE runtime-k library function per (kernel, mode):
    k is a plain ``int`` argument, so ``Controller.run_mode`` sweeps a whole
    k-grid on ≤2 builds (runtime-k sweep + static payload check);
  * campaigns persist and replay (region, mode, k, t) records for these
    regions like any other RegionTarget;
  * payload verification runs the static-k build once and compares ``nacc``
    against the exact per-mode oracle — proof that ALL k patterns executed
    and none was duplicated.

``device``: "cuda" (the default; raises when no card is present) or "cpu"
(the plain versions — what the tests use).

On the card each region names, for (mode, k), the static build and the
kernel functions that carry its noise (``RegionTarget.sass``, a
``_build.SassSite``): the static noise audit and the payload census read
their SASS. ``audit_hint["steps"]`` is the loop a CTA runs over its grid
steps (``steps_per_cta``): CTAs stand in for the reference's sequential
grid steps, so a CTA of one step holds its noise outside any loop.

``pallas_family`` spans a kernel's size (× q for spmxv) family under one
store namespace, and ``family_names`` enumerates its region names without
building anything — what fleet plans and their status queries use.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.convert import to_torch
from repro_torch.core.controller import RegionTarget
from repro_torch.core.payload import InjectionReport
from repro_torch.kernels import noise_slots as ns
from repro_torch.kernels._build import SassSite
from repro_torch.kernels.flash_attention.kernel import (WGMMA_HEAD_DIMS,
                                                        flash_attention,
                                                        flash_attention_rt,
                                                        live_blocks)
from repro_torch.kernels.noise_probes.kernel import probe, probe_rt
from repro_torch.kernels.noise_probes.ref import probe_ref
from repro_torch.kernels.noisy_matmul.kernel import matmul, matmul_rt
from repro_torch.kernels.noisy_matmul.ref import default_noise_operand
from repro_torch.kernels.spmv_ell.kernel import (RING_MAX_L, blocks_per_cta,
                                                spmv_ell, spmv_ell_rt)
from repro_torch.kernels.spmv_ell.ref import (fp_noise_ell_ref, make_band_ell,
                                              vmem_noise_ell_ref)

# noise modes each kernel supports (spmv has no noise operand -> no mxu)
KERNEL_MODES = {
    "matmul": ("fp", "mxu", "vmem"),
    "spmxv": ("fp", "vmem"),
    "attention": ("fp", "mxu", "vmem"),
    "probe": ("fp", "mxu", "vmem"),
}

# per-kernel meaning of the one "size" knob, its default, and the block width
# it must tile (sizes below one block are allowed: the block shrinks)
SIZE_KW = {"matmul": "n", "spmxv": "n", "attention": "seq", "probe": "n_steps"}
SIZE_DEFAULT = {"matmul": 256, "spmxv": 512, "attention": 128, "probe": 64}
SIZE_ALIGN = {"matmul": 128, "spmxv": 128, "attention": 64, "probe": 1}

def validate_size(kernel: str, n: int) -> None:
    """The size rule every entry point shares: noise patterns read 8-row
    groups, and sizes past one block must tile evenly."""
    if kernel not in SIZE_KW:
        raise ValueError(f"unknown pallas kernel {kernel!r}; "
                         f"one of {sorted(SIZE_KW)}")
    align = SIZE_ALIGN[kernel]
    if n < 1:
        raise ValueError(f"size for {kernel!r} must be positive; got {n}")
    if align > 1 and (n < 8 or (n > align and n % align)):
        raise ValueError(
            f"size for {kernel!r} must be >= 8 and a multiple of its "
            f"{align}-wide block (or smaller than one block); got {n}")


# which resource one pattern of each kernel mode stresses (payload reports)
MODE_TARGETS = {"fp": "compute", "mxu": "compute", "vmem": "vmem"}


def _matmul_name(*, n=256, **_):
    return f"pallas_matmul_n{n}"


def _spmxv_name(*, n=512, nnz_per_row=16, q=0.0, **_):
    return f"pallas_spmxv_n{n}_L{nnz_per_row}_q" + f"{q:g}".replace(".", "p")


def _attention_name(*, batch=1, heads=2, seq=128, head_dim=64, **_):
    # kv_heads is not in the name: the reference's naming, kept so stores
    # of both packages share region names
    return f"pallas_attn_b{batch}h{heads}s{seq}d{head_dim}"


def _probe_name(*, n_steps=64, **_):
    return f"pallas_probe_s{n_steps}"


_NAMERS = {"matmul": _matmul_name, "spmxv": _spmxv_name,
           "attention": _attention_name, "probe": _probe_name}


def resolve_device(device) -> torch.device:
    """The device a region computes on; "cuda" without a card raises (there
    is no fallback to the CPU — ask for "cpu" explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu; got {device!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class _KernelSpec:
    """Everything ``pallas_region`` needs about one kernel: its arguments,
    its static-k and runtime-k callables, and the exact nacc oracle."""
    name: str
    args: tuple
    static_fn: Callable[[str, int], Callable]   # (mode, k) -> fn(*args)
    rt_fn: Callable[[str], Callable]            # mode -> fn(k, *args)
    oracle: Callable[[str, int], Optional[torch.Tensor]]
    n_steps: int                                # grid steps visiting the slot
    body_size: int                              # |l1.l2| stand-in for Abs^rel
    steps_per_cta: int                          # most grid steps one partial holds
    n_cta: int = 0                              # partials (0: n_steps/steps_per_cta)
    source: str = ""                            # csrc/<source>.cu
    kernels: tuple = ()                         # functions carrying the noise
    aux: tuple = ()                             # other kernels a call launches
    defines: tuple = ()                         # the static build's variant


def _chain(steps_per_cta: int, n_cta: int, k: int) -> int:
    """Longest chain of f32 additions into one nacc element: k patterns per
    step into a CTA's partial, then the two-level reduction of partials."""
    return steps_per_cta * k + ns.REDUCE_CHUNK + -(-n_cta // ns.REDUCE_CHUNK)


def payload_rtol(spec: "_KernelSpec", k: int) -> float:
    """Relative tolerance of the nacc oracle comparison: 1e-4 (the
    reference's), widened to the recursive-summation bound chain * 2^-24 for
    long chains. The oracle's terms are all non-negative, so the bound
    holds; at the main path's sizes it stays below 1/(2k), so one pattern
    too many or too few still fails the check."""
    n_cta = spec.n_cta or -(-spec.n_steps // spec.steps_per_cta)
    return max(1e-4, _chain(spec.steps_per_cta, n_cta, k) * 2.0 ** -24)


def _matmul_spec(device, *, n: int = 256, bm: int = 128, bn: int = 128,
                 bk: int = 128) -> _KernelSpec:
    # numpy RandomState(0)/(1) stand in for the reference's PRNGKey(0)/(1):
    # jax's random bits cannot be reproduced here, so the operands differ
    # from the reference region's (the tests feed both the same arrays)
    a, b = to_torch((np.random.RandomState(0).standard_normal((n, n))
                     .astype(np.float32),
                     np.random.RandomState(1).standard_normal((n, n))
                     .astype(np.float32)), device)
    noise = default_noise_operand(device)
    bm, bn, bk = min(bm, n), min(bn, n), min(bk, n)
    grid_steps = (n // bm) * (n // bn) * (n // bk)

    def static_fn(mode, k):
        return lambda a, b, noise: matmul(a, b, noise, mode=mode, k_noise=k,
                                          bm=bm, bn=bn, bk=bk)

    def rt_fn(mode):
        return lambda k, a, b, noise: matmul_rt(k, a, b, noise, mode=mode,
                                                bm=bm, bn=bn, bk=bk)

    def oracle(mode, k):
        if mode == "fp":
            return ns.expected_fp_noise(noise, k, grid_steps)
        return None

    return _KernelSpec(_matmul_name(n=n), (a, b, noise), static_fn, rt_fn,
                       oracle, grid_steps, body_size=3,
                       steps_per_cta=n // bk, source="noisy_matmul",
                       kernels=(("matmul_kernel", ""),),
                       aux=(("transpose_tf32", ""), ("nacc_reduce", "")))


def _spmxv_spec(device, *, n: int = 512, nnz_per_row: int = 16,
                q: float = 0.0, br: int = 128, seed: int = 0) -> _KernelSpec:
    vals, cols = make_band_ell(n, nnz_per_row, q, seed=seed)
    x = np.random.RandomState(seed + 1).standard_normal(n).astype(np.float32)
    vals, cols, x = to_torch((vals, cols, x), device)
    br = min(br, n)
    nb = n // br

    def static_fn(mode, k):
        return lambda vals, cols, x: spmv_ell(vals, cols, x, br=br, mode=mode,
                                              k_noise=k)

    def rt_fn(mode):
        return lambda k, vals, cols, x: spmv_ell_rt(k, vals, cols, x, br=br,
                                                    mode=mode)

    def oracle(mode, k):
        if mode == "fp":
            return fp_noise_ell_ref(vals, k, br)
        if mode == "vmem":
            return vmem_noise_ell_ref(vals, k, br)
        return None

    kernel = "spmv_ring_kernel" if nnz_per_row <= RING_MAX_L else "spmv_kernel"
    return _KernelSpec(_spmxv_name(n=n, nnz_per_row=nnz_per_row, q=q),
                       (vals, cols, x), static_fn, rt_fn, oracle, nb,
                       body_size=4, steps_per_cta=blocks_per_cta(nb),
                       source="spmv_ell", kernels=((kernel, ""),))


def _attention_spec(device, *, batch: int = 1, heads: int = 2,
                    kv_heads: int = 2, seq: int = 128, head_dim: int = 64,
                    bq: int = 64, bk: int = 64, causal: bool = True
                    ) -> _KernelSpec:
    # numpy RandomState(0)/(1)/(2) stand in for the reference's split of
    # PRNGKey(0): jax's random bits cannot be reproduced here, so q, k, v
    # differ from the reference region's (the tests feed both the same
    # arrays)
    q, k, v = to_torch(tuple(
        np.random.RandomState(seed).standard_normal(
            (batch, h, seq, head_dim)).astype(np.float32)
        for seed, h in ((0, heads), (1, kv_heads), (2, kv_heads))), device)
    noise = default_noise_operand(device)
    bq, bk = min(bq, seq), min(bk, seq)
    nq = seq // bq
    # only LIVE kv blocks visit the noise slot (causal skip)
    live = live_blocks(nq, seq // bk, bq, bk, causal, 0).sum(dim=1)
    grid_steps = batch * heads * int(live.sum())

    def static_fn(mode, kn):
        return lambda q, k, v, noise: flash_attention(
            q, k, v, noise, causal=causal, bq=bq, bk=bk, mode=mode,
            k_noise=kn)

    def rt_fn(mode):
        return lambda kn, q, k, v, noise: flash_attention_rt(
            kn, q, k, v, noise, causal=causal, bq=bq, bk=bk, mode=mode)

    def oracle(mode, kn):
        if mode == "fp":
            return ns.expected_fp_noise(noise, kn, grid_steps)
        return None

    return _KernelSpec(_attention_name(batch=batch, heads=heads, seq=seq,
                                       head_dim=head_dim),
                       (q, k, v, noise), static_fn, rt_fn, oracle,
                       grid_steps, body_size=12,
                       steps_per_cta=int(live.max()),
                       n_cta=batch * heads * nq, source="flash_attention",
                       kernels=(("fa_kernel_wgmma" if head_dim in
                                 WGMMA_HEAD_DIMS else "fa_kernel_mma", ""),),
                       aux=((("fa_prep", ""),) if head_dim in WGMMA_HEAD_DIMS
                            else ()) + (("nacc_reduce", ""),),
                       defines=(("REPRO_STATIC_HD", head_dim),
                                ("REPRO_STATIC_BF16", 0)))


def _probe_spec(device, *, n_steps: int = 64) -> _KernelSpec:
    noise = default_noise_operand(device)

    def static_fn(mode, k):
        return lambda noise: probe(noise, mode=mode, k_noise=k,
                                   n_steps=n_steps)

    def rt_fn(mode):
        return lambda k, noise: probe_rt(k, noise, mode=mode, n_steps=n_steps)

    def oracle(mode, k):
        # the card's mxu pattern runs on TF32 tensor cores: hold it against
        # the product of TF32-rounded operands
        return probe_ref(noise, mode=mode, k_noise=k, n_steps=n_steps,
                         tf32=noise.is_cuda)

    return _KernelSpec(_probe_name(n_steps=n_steps), (noise,), static_fn,
                       rt_fn, oracle, n_steps, body_size=1, steps_per_cta=1,
                       source="noise_probes",
                       kernels=(("probe_kernel", ""),))


_SPECS = {
    "matmul": _matmul_spec,
    "spmxv": _spmxv_spec,
    "attention": _attention_spec,
    "probe": _probe_spec,
}


def launch_counts() -> dict[str, list[int]]:
    """This process's calls of each kernel: {kernel: [CUDA launches,
    plain-version calls]}, read from the wrappers' counters (a fleet worker
    reports them in its stats file). The loop regions' kernels (all in
    ``csrc/loop_regions.cu``) count one by one, under their region names;
    the DECAN loops and the graph-noise modes under their kernel names."""
    from repro_torch.kernels.decan_loops.kernel import DECAN_KERNELS
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.graph_noise.kernel import GRAPH_KERNELS
    from repro_torch.kernels.loop_regions.kernel import REGION_KERNELS
    from repro_torch.kernels.noise_probes import kernel as probe_k
    from repro_torch.kernels.noisy_matmul import kernel as matmul_k
    from repro_torch.kernels.spmv_ell import kernel as spmv_k

    return {
        "noise_probes": [probe_k.probe_cuda.launches,
                         probe_k.probe_plain.launches],
        "spmv_ell": [spmv_k.spmv_ell_cuda.launches,
                     spmv_k.spmv_ell_plain.launches],
        "noisy_matmul": [matmul_k.matmul_cuda.launches,
                         matmul_k.matmul_plain.launches],
        "flash_attention": [fa_k.flash_attention_cuda.launches,
                            fa_k.flash_attention_plain.launches],
        **{name: [cuda.launches, plain.launches]
           for name, (cuda, plain) in (*REGION_KERNELS.items(),
                                       *DECAN_KERNELS.items(),
                                       *GRAPH_KERNELS.items())},
    }


def _nacc_of(result):
    return result[-1] if isinstance(result, (tuple, list)) else result


def pallas_region(kernel: str, *, device="cuda", name: str = "",
                  trace_hook: Optional[Callable[[], None]] = None,
                  **sizes) -> RegionTarget:
    """A RegionTarget over one kernel, ready for ``Controller.characterize``
    / ``Campaign.sweep_mode``.

    ``trace_hook`` (tests): called once per build this region hands out —
    each runtime-k function resolution and each static-k build — so it
    counts builds (the ≤2-per-sweep guarantee). ``sizes``: forwarded to the
    kernel's spec builder (e.g. ``n=``, ``q=``).
    """
    if kernel not in _SPECS:
        raise ValueError(f"unknown pallas kernel {kernel!r}; "
                         f"one of {sorted(KERNEL_MODES)}")
    dev = resolve_device(device)
    spec = _SPECS[kernel](dev, **sizes)
    modes = KERNEL_MODES[kernel]

    def _built(fn):
        if trace_hook is not None:
            trace_hook()
        return fn

    def _check_mode(mode):
        if mode not in modes:
            raise ValueError(f"kernel {kernel!r} supports noise modes "
                             f"{modes}, not {mode!r}")

    def build(mode: str, k: int):
        if not mode or k == 0:
            return _built(spec.static_fn("none", 0))
        _check_mode(mode)
        return _built(spec.static_fn(mode, k))

    def args_for(mode: str, k: int):
        return spec.args

    def build_rt(mode: str):
        _check_mode(mode)
        return _built(spec.rt_fn(mode))

    def args_for_rt(mode: str):
        return spec.args

    def payload_check(mode: str, k: int) -> InjectionReport:
        """Arithmetic-level static payload check: run the static-k build
        once; an exact oracle match (or a nonzero accumulator for modes
        without a closed-form oracle) proves all k patterns executed."""
        _check_mode(mode)
        nacc = _nacc_of(build(mode, k)(*spec.args)).to(torch.float32)
        want = spec.oracle(mode, k)
        if want is not None:
            ok = bool(torch.allclose(nacc, want.to(nacc.device, torch.float32),
                                     rtol=payload_rtol(spec, k), atol=1e-5))
        else:
            ok = bool(nacc.abs().sum() > 0) if k else True
        return InjectionReport(
            mode=mode, target=MODE_TARGETS[mode], expected=k,
            payload=k if ok else 0, overhead=0,
            payload_dynamic=k * spec.n_steps, body_ops=spec.body_size)

    def sass(mode: str, k: int) -> SassSite:
        """The static build carrying k patterns of ``mode`` (the clean
        build, mode 0, for ``("", 0)``) and the region's functions in it."""
        mode_id = 0
        if mode and k:
            _check_mode(mode)
            mode_id = ns.MODE_IDS[mode]
        return SassSite(spec.source, mode_id, k if mode_id else 0,
                        spec.defines, spec.kernels, spec.aux)

    return RegionTarget(name=name or spec.name, build=build,
                        args_for=args_for, body_size=spec.body_size,
                        payload_target=dict(MODE_TARGETS),
                        build_rt=build_rt, args_for_rt=args_for_rt,
                        payload_check=payload_check,
                        audit_hint={"scoped": False, "in_loop": True,
                                    "steps": spec.steps_per_cta},
                        sass=sass if dev.type == "cuda" else None)


def family_params(kernel: str) -> frozenset:
    """Keyword params the kernel's spec builder accepts — the allowlist
    plan validation checks declarative params against."""
    import inspect

    sig = inspect.signature(_SPECS[kernel])
    return frozenset(p.name for p in sig.parameters.values()
                     if p.kind == p.KEYWORD_ONLY)


def check_family_args(kernel: str, sizes, qs, common: dict) -> None:
    """The family argument rules, shared by ``pallas_family``,
    ``family_names`` and SweepPlan validation — so a bad family is rejected
    when the plan is BUILT, not when a worker subprocess resolves it."""
    if kernel not in _SPECS:
        raise ValueError(f"unknown pallas kernel {kernel!r}; "
                         f"one of {sorted(_SPECS)}")
    if qs is not None and kernel != "spmxv":
        raise ValueError(f"qs= applies to the 'spmxv' kernel only, "
                         f"not {kernel!r}")
    allowed = family_params(kernel) - {SIZE_KW[kernel], "q"}
    bad = sorted(set(common) - allowed)
    if bad:
        raise ValueError(f"kernel {kernel!r} spec does not accept param(s) "
                         f"{bad}; allowed: {sorted(allowed)}")
    for n in sizes:
        validate_size(kernel, int(n))


def _family_grid(kernel: str, sizes, qs):
    for n in sizes:
        for q in (qs if qs is not None else (None,)):
            kw = {SIZE_KW[kernel]: int(n)}
            if q is not None:
                kw["q"] = float(q)
            yield kw


def family_names(kernel: str, sizes, *, qs=None, **common) -> list[str]:
    """The region names ``pallas_family(kernel, sizes, qs=qs, **common)``
    would produce, WITHOUT building a single tensor — what fleet status and
    the launcher use to enumerate a plan's grid cheaply."""
    check_family_args(kernel, sizes, qs, common)
    return [_NAMERS[kernel](**{**common, **kw})
            for kw in _family_grid(kernel, sizes, qs)]


def pallas_family(kernel: str, sizes, *, qs=None, device="cuda",
                  trace_hook: Optional[Callable[[], None]] = None,
                  **common) -> list[RegionTarget]:
    """One RegionTarget per size (× swap probability q for spmxv), sharing
    one campaign-store namespace: every member's name encodes its
    coordinates, so one store (and one fleet plan) holds the whole family.
    ``sizes`` drives the kernel's size knob (``SIZE_KW``); ``qs`` is
    spmxv-only; ``common`` (e.g. ``heads=``) goes to every member's spec.
    """
    check_family_args(kernel, sizes, qs, common)
    out = [pallas_region(kernel, device=device, trace_hook=trace_hook,
                         **{**common, **kw})
           for kw in _family_grid(kernel, sizes, qs)]
    names = [r.name for r in out]
    if len(set(names)) != len(names):
        raise ValueError(f"family members collide in one store namespace: "
                         f"{names}")
    return out
