"""Graph-level noise injection — wrap a whole model step (train / serve) with
k patterns of a noise mode.

PyTorch port of the reference's ``repro.core.injector``. In the reference,
noise and step share one XLA program under ``optimization_barrier``, so
they compete for the chip. On one CUDA stream the noise kernel would just
run after the step; here it is forked onto a dedicated noise stream
instead (``NoiseFork``):

  1. the noise stream waits on the current stream (an event);
  2. it launches the mode's kernel inside ``record_function(NOISE_SCOPE)``;
  3. the step runs on the current stream, beside the noise, on the same SMs;
  4. the current stream waits on the noise's end before ``out`` and ``aux``
     are returned.

On the CPU the step and the noise run one after the other.

``jax.jit``'s counterpart: the reference times one compiled executable per
region. On the card ``step_region`` captures the clean step once as a
``torch.cuda.CUDAGraph`` and replays it; the noise launch stays outside the
graph (its run-time k is a launch argument). A step that cannot be
captured fails the region: there is no eager fallback.

Semantics preservation is by construction: noise reads and writes only its
own state (R_n ∩ R_s = ∅) and the step's outputs are returned untouched —
``verify_semantics`` checks bit-identical outputs. A region's noise states
are fixed (made once, not threaded from call to call), as in the
reference's ``step_region``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch.profiler import record_function

from repro_torch.core import payload as payload_mod
from repro_torch.core.absorption import (DEFAULT_KS, AbsorptionCurve,
                                         AbsorptionFit, absorption, sweep)
from repro_torch.core.noise import (NOISE_SCOPE, NoiseMode, NoiseScale,
                                    default_scale, make_modes)

# the reference's step and serve regions' noise scale (its
# launch/probe.py:build_step_region); the card takes CARD_SCALE instead,
# whose buffers are not the L2's (core/noise.py)
STEP_SCALE = NoiseScale(hbm_mib=32, chase_len=1 << 20)


def _tensors(obj):
    """Every tensor of a (nested) tuple / list / dict, in order (a module's
    parameters included)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _map(fn, obj):
    """``obj`` with ``fn`` applied to every tensor (a clone of its tree)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    return obj


def _device(state) -> torch.device:
    return next(_tensors(state)).device


class NoiseFork:
    """The noise stream of one injection site (one per device, made at
    first use), and the fork/join around a step."""

    def __init__(self):
        self._streams: dict = {}

    def stream(self, dev: torch.device) -> torch.cuda.Stream:
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def run(self, step_fn: Callable, apply: Callable, state, k: int, args,
            kw) -> tuple:
        """``(step_fn(*args, **kw), *apply(state, k))``, the noise forked
        onto the noise stream on the card."""
        dev = _device(state)
        if dev.type != "cuda":
            out = step_fn(*args, **kw)
            with record_function(NOISE_SCOPE):
                aux, new_state = apply(state, k)
            return out, aux, new_state
        cur = torch.cuda.current_stream(dev)
        noise = self.stream(dev)
        noise.wait_stream(cur)
        with torch.cuda.stream(noise), record_function(NOISE_SCOPE):
            aux, new_state = apply(state, k)
        out = step_fn(*args, **kw)
        cur.wait_stream(noise)
        # made on the noise stream, read on this one: the allocator must not
        # hand their blocks back to the noise stream before this one is done
        for t in _tensors((aux, new_state)):
            t.record_stream(cur)
        return out, aux, new_state


def inject(step_fn: Callable, mode: NoiseMode, k: int,
           fork: Optional[NoiseFork] = None) -> Callable:
    """Return ``noisy(noise_state, *args, **kw) -> (out, aux, new_state)``.

    ``out`` is bit-identical to ``step_fn(*args, **kw)``; ``aux`` is the
    noise's scalar (the reference's DCE-proof output); ``new_state`` the
    mode's next state. k is static: the mode's unrolled build.
    """
    fork = fork or NoiseFork()

    def noisy(noise_state, *args, **kw):
        return fork.run(step_fn, mode.apply, noise_state, k, args, kw)

    return noisy


def inject_rt(step_fn: Callable, mode: NoiseMode,
              fork: Optional[NoiseFork] = None) -> Callable:
    """Compile-once variant of ``inject``: k is a run-time ``int``, so ONE
    build of the mode's kernel serves the whole k-sweep.

    Returns ``noisy(k, noise_state, *args, **kw) -> (out, aux, new_state)``.
    """
    if mode.apply_rt is None:
        raise ValueError(f"mode {mode.name!r} has no runtime-k apply")
    fork = fork or NoiseFork()

    def noisy(k, noise_state, *args, **kw):
        return fork.run(step_fn, mode.apply_rt, noise_state, int(k), args,
                        kw)

    return noisy


def step_modes(device) -> dict[str, NoiseMode]:
    """The graph-level noise registry of step and serve regions on
    ``device``: the reference's ``STEP_SCALE`` on the CPU,
    ``default_scale`` (``CARD_SCALE``) on the card."""
    dev = torch.device(device)
    scale = STEP_SCALE if dev.type == "cpu" else default_scale(dev)
    return make_modes(scale, device=dev)


def init_state(mode: NoiseMode, generator: Optional[torch.Generator] = None):
    """The mode's state, drawn from ``generator`` (default: seeded 0)."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    return mode.make_state(gen)


class GraphStep:
    """A step captured once as a CUDA graph on its fixed arguments and
    replayed: ``GraphStep(step_fn, args)(*args)`` returns the graph's
    static outputs (overwritten by every replay). The capture follows two
    warm-up calls on a side stream (library handles and workspaces are
    made outside the graph). A step that cannot be captured raises."""

    def __init__(self, step_fn: Callable, args: tuple):
        self.step_fn = step_fn
        self.args = args
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None

    def capture(self) -> None:
        dev = _device(self.args)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(2):
                self.step_fn(*self.args)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self.step_fn(*self.args)
        self.graph = graph

    def __call__(self, *args):
        if args and any(a is not b for a, b in zip(args, self.args)):
            raise ValueError("a captured step replays on the arguments it "
                             "was captured with")
        if self.graph is None:
            self.capture()
        self.graph.replay()
        return self.out


def step_region(name: str, step_fn: Callable, args: tuple,
                registry: dict[str, NoiseMode], *, body_size: int = 0,
                generator: Optional[torch.Generator] = None):
    """Adapt a step + graph-level noise registry into a RegionTarget (with
    both the trace-per-k and the compile-once build paths, and the aux
    oracle as its payload check).

    On the card the clean step is a ``GraphStep`` (captured at its first
    call); on the CPU it is ``step_fn`` itself. Every build of the region
    shares it and one noise stream.
    """
    from repro_torch.core.controller import RegionTarget  # controller->here

    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    states = {m: registry[m].make_state(gen) for m in registry}
    clean = GraphStep(step_fn, args) if _device(args).type == "cuda" \
        else step_fn
    fork = NoiseFork()

    def build(mode: str, k: int):
        if not mode or k == 0:
            return clean
        return inject(clean, registry[mode], k, fork)

    def args_for(mode: str, k: int):
        if not mode or k == 0:
            return args
        return (states[mode], *args)

    def build_rt(mode: str):
        if registry[mode].apply_rt is None:
            return None
        return inject_rt(clean, registry[mode], fork)

    def args_for_rt(mode: str):
        return (states[mode], *args)

    def payload_check(mode: str, k: int) -> payload_mod.InjectionReport:
        """Run the static-k noisy build once and hold its aux against the
        mode's plain version on the same state."""
        got = want = None
        if k:
            got = build(mode, k)(*args_for(mode, k))[1]
            want = registry[mode].apply(states[mode], k, plain=True)[0]
        return payload_mod.analyze_aux(
            got, want, mode=mode, target=registry[mode].target, expected=k,
            body_ops=body_size)

    return RegionTarget(name=name, build=build, args_for=args_for,
                        body_size=body_size, build_rt=build_rt,
                        args_for_rt=args_for_rt, payload_check=payload_check,
                        audit_hint={"scoped": True, "in_loop": False})


@dataclasses.dataclass
class StepProbe:
    """Measured absorption of one step × one mode, with its payload."""
    mode: str
    curve: AbsorptionCurve
    fit: AbsorptionFit
    injection: payload_mod.InjectionReport


def probe_step(step_fn: Callable, args: tuple, mode: NoiseMode, *,
               ks: Sequence[int] = DEFAULT_KS, reps: int = 5,
               tol: float = 0.05, verify_payload: bool = True,
               compile_once: bool = True) -> StepProbe:
    """Sweep k for ``mode`` against ``step_fn(*args)`` and verify the payload
    with the aux oracle (a static-k build at k = max(8, last k // 2)).

    ``compile_once`` (default): k is a run-time operand, so the sweep uses
    ONE build of the mode's kernel; otherwise one static build per k.
    """
    state0 = init_state(mode)
    fork = NoiseFork()
    if compile_once and mode.apply_rt is not None:
        fn_rt = inject_rt(step_fn, mode, fork)
        curve = sweep(lambda k: fn_rt, mode=mode.name, ks=ks,
                      args_for=lambda k: (int(k), state0, *args), reps=reps)
    else:
        curve = sweep(lambda k: inject(step_fn, mode, k, fork),
                      mode=mode.name, ks=ks,
                      args_for=lambda k: (state0, *args), reps=reps)
    fit = absorption(curve, tol=tol)

    inj = None
    if verify_payload:
        k_chk = max(8, curve.ks[-1] // 2) if len(curve.ks) > 1 else 8
        got = inject(step_fn, mode, k_chk, fork)(state0, *args)[1]
        want = mode.apply(state0, k_chk, plain=True)[0]
        inj = payload_mod.analyze_aux(got, want, mode=mode.name,
                                      target=mode.target, expected=k_chk)
    return StepProbe(mode=mode.name, curve=curve, fit=fit, injection=inj)


def _same(a: torch.Tensor, b: torch.Tensor, rtol: float,
          atol: float) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if rtol == 0.0 and atol == 0.0:
        if a.is_floating_point():
            return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        return bool(torch.equal(a, b))
    return bool(torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol,
                               equal_nan=True))


def verify_semantics(step_fn: Callable, args: tuple, mode: NoiseMode,
                     k: int = 8, *, rtol: float = 0.0, atol: float = 0.0
                     ) -> bool:
    """Paper §2.3 property: injection must not change program semantics.
    Checks the wrapped output equals the clean output (bitwise by default).
    The clean output is cloned before the noisy call (a step may write its
    cache in place, and a captured step reuses its outputs)."""
    clean = _map(torch.clone, step_fn(*args))
    state0 = init_state(mode)
    noisy_out, _, _ = inject(step_fn, mode, k)(state0, *args)
    a, b = list(_tensors(clean)), list(_tensors(noisy_out))
    return len(a) == len(b) and all(_same(x, y, rtol, atol)
                                    for x, y in zip(a, b))
