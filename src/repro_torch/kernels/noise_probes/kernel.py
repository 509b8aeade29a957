"""Pure-noise calibration kernel: ``n_steps`` grid steps, each emitting k
noise patterns into the (8,128) ``nacc``; nothing else is computed.

Timing ``probe_rt(k, noise, mode=..., n_steps=...)`` against k gives the
per-pattern cost of each noise mode on the card. ``probe`` bakes k into a
static build (one library per (mode, k)); ``probe_rt`` takes k as a runtime
int (one library for every k). For tensors on the CPU both take the plain
version ``probe_plain``; for CUDA tensors they launch
``csrc/noise_probes.cu`` or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import noise_slots as ns


def probe_plain(noise: torch.Tensor, *, mode: str, k_noise: int,
                n_steps: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic: one partial per
    grid step (the kernel's CTA) holding its ``k_noise`` patterns, then the
    partials reduced in the card's order."""
    probe_plain.launches += 1
    parts = ns.new_partials(n_steps, noise.device)
    if mode != "none" and k_noise:
        for i in range(n_steps):
            ns.emit_noise(mode, k_noise, parts[i], noise, src=noise, step=i)
    return ns.reduce_partials(parts)


probe_plain.launches = 0


def _check(noise: torch.Tensor, mode: str, n_steps: int) -> None:
    if mode not in ns.MODES:
        raise ValueError(f"unknown kernel noise mode {mode!r}; one of {ns.MODES}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be positive; got {n_steps}")
    if tuple(noise.shape) != ns.NOISE_REF_SHAPE:
        raise ValueError(f"noise must be {ns.NOISE_REF_SHAPE}; got "
                         f"{tuple(noise.shape)}")


def probe_cuda(noise: torch.Tensor, *, mode: str, k_noise: int, n_steps: int,
               static: bool) -> torch.Tensor:
    """Launch ``csrc/noise_probes.cu``: the static-k build of (mode, k) or
    the runtime-k library (k clipped to [0, K_MAX] there). One launch: the
    CTAs reduce their partials into ``nacc`` in the kernel's epilogue, with
    the current stream's workspace."""
    if not (noise.is_cuda and noise.dtype == torch.float32
            and noise.is_contiguous()):
        raise ValueError("the CUDA probe takes a contiguous float32 CUDA "
                         "noise operand")
    dev = noise.device
    stream = _build.stream_handle(dev.index)
    ws = ns.workspace(n_steps, dev, stream)
    nacc = ns.new_nacc(dev)
    _build.launch("noise_probes", "probe",
                  (noise, ws.partials, ws.chunk_sums, ws.counters, nacc),
                  (n_steps,), mode_id=ns.MODE_IDS[mode], k=k_noise,
                  static=static, stream=stream)
    probe_cuda.launches += 1
    return nacc


probe_cuda.launches = 0


def probe(noise: torch.Tensor, *, mode: str, k_noise: int,
          n_steps: int) -> torch.Tensor:
    """nacc of the probe with a static noise quantity ``k_noise``."""
    _check(noise, mode, n_steps)
    if _build.on_card(noise):
        return probe_cuda(noise, mode=mode, k_noise=int(k_noise),
                          n_steps=n_steps, static=True)
    return probe_plain(noise, mode=mode, k_noise=int(k_noise),
                       n_steps=n_steps)


def probe_rt(k: int, noise: torch.Tensor, *, mode: str,
             n_steps: int) -> torch.Tensor:
    """nacc of the probe with a runtime noise quantity ``k`` (clipped to
    [0, K_MAX]); bitwise equal to ``probe`` at the same k."""
    _check(noise, mode, n_steps)
    if _build.on_card(noise):
        return probe_cuda(noise, mode=mode, k_noise=int(k), n_steps=n_steps,
                          static=False)
    return probe_plain(noise, mode=mode, k_noise=ns.clip_k(k),
                       n_steps=n_steps)
