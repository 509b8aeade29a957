"""Gradient compression with error feedback for the data-parallel
all-reduce (4× fewer wire bytes at int8).

PyTorch port of the reference's ``repro.train.grad_compression``. Scheme
(per leaf): scale = max|g| / 127, agreed across the group by an
all-reduce MAX; q = round(g / scale) as int8; the all-reduce SUMs int32
partial sums (|q| <= 127, so a group of up to 2^24 ranks cannot overflow);
the residual g - q·scale is carried to the next step (error feedback keeps
convergence). ``make_compressed_psum`` runs over the ``torch.distributed``
process group of a mesh's batch axes (one axis, or the flattened
(pod, data) group) where the reference runs inside ``shard_map`` over
them: each rank brings its own gradients and keeps its own residuals.
A leaf is the reference's: it stacks the per-layer parameters on a
leading (L, ...) axis, so the port's ``layers.i.<leaf>`` tensors share one
scale, the max over all L of them (``convert.reference_leaf``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _quantize(gf: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, gf - q.to(torch.float32) * scale


def compress_int8(g: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """g f32/bf16 -> (q int8, scale f32 scalar, new_residual f32)."""
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual
    scale = torch.clamp(torch.max(torch.abs(gf)) / 127.0, min=1e-30)
    q, new_residual = _quantize(gf, scale)
    return q, scale, new_residual


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_compressed_psum(axis_names: Optional[Sequence[str]] = None, *,
                         mesh=None):
    """``cpsum(grads, residuals) -> (mean_grads, new_residuals)``: the
    int8-quantized all-reduce with error feedback over ``mesh``'s
    ``axis_names`` (their flattened process group; without a mesh, the
    world). grads and residuals are {name: tensor};
    residuals may be None. The shared scale is the group's max of the local
    scales, so the quantization error stays bounded on every rank; the
    int8 values are summed as int32 and the mean is that sum × scale / n."""
    from repro_torch.convert import reference_leaf

    group = None
    if mesh is not None:
        from repro_torch.parallel.sharding import axis_group

        group = axis_group(mesh, axis_names)

    def cpsum(grads: dict, residuals: Optional[dict]):
        gfs = {}
        for name, g in grads.items():
            gf = g.to(torch.float32)
            if residuals is not None:
                gf = gf + residuals[name]
            gfs[name] = gf
        leaves = {reference_leaf(name): None for name in grads}
        index = {leaf: i for i, leaf in enumerate(leaves)}
        local = torch.zeros((len(index),), dtype=torch.float32,
                            device=next(iter(gfs.values())).device)
        for name, gf in gfs.items():
            i = index[reference_leaf(name)]
            local[i] = torch.maximum(local[i], torch.max(torch.abs(gf)))
        # every leaf's scale agreed in one all-reduce MAX
        scales = torch.clamp(local / 127.0, min=1e-30)
        dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=group)
        n = dist.get_world_size(group)
        means, new_rs = {}, {}
        for name, gf in gfs.items():
            scale = scales[index[reference_leaf(name)]]
            q, new_rs[name] = _quantize(gf, scale)
            total = q.to(torch.int32)
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
            means[name] = (total.to(torch.float32) * (scale / n)).to(
                grads[name].dtype)
        return means, new_rs

    return cpsum


def init_residuals(params) -> dict:
    """f32 zeros beside every parameter of ``params`` (an nn.Module)."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.named_parameters()}
