"""Three-term roofline of one traced per-rank program.

    compute term    = sum over products of FLOPs / the peak of the unit
                      that runs the product
    memory term     = HBM bytes per rank / HBM bandwidth
    collective term = wire bytes per rank / link bandwidth

PyTorch port of the reference's ``repro.roofline.terms``. The reference
parses the compiled per-device HLO (``analyze_compiled_text``); the port
reads the op trace of rank 0's per-rank program run on meta tensors
(``roofline/trace.py``; ``analyze_trace``). Every quantity is per rank.

  - FLOPs: every product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``convolution``), 2·prod(out)·prod(contract), as the reference counts
    ``dot`` and ``convolution``; elementwise FLOPs are ignored, as there.
  - HBM bytes: the reference's traffic model, transcribed for eager code.
    Every op that is not a view reads its operands and writes its result
    once (eager PyTorch fuses nothing, so each op is one kernel that
    streams through HBM). Views, reshapes, ``expand``, ``detach``,
    ``empty*`` and other metadata ops are free (``FREE_OPS``, the
    reference's ``_SKIP_TRAFFIC``). An in-place write (``index_copy_``,
    ``index_put_``, ``copy_`` into a slice, AdamW's ``*_`` updates) counts
    the bytes it writes, not the whole buffer it writes into: the
    counterpart of the reference's dynamic-update-slice correction. Its
    mirror image, a gather (``index``, ``index_select``, ``gather``,
    ``embedding``), reads as many bytes of its source as it writes, not
    the whole source: a gather kernel touches the rows it fetches.
  - Wire bytes: the reference's ring factors by collective
    (``WIRE_FACTOR``: all-reduce 2(g-1)/g·B, all-gather, reduce-scatter
    and all-to-all (g-1)/g·B, send/recv 1·B), g the size of the process
    group the traced collective ran on.

The compute term charges each product at the peak of the unit that runs
it: a bf16 or f16 product runs on the tensor cores (989.4 TFLOP/s dense),
an f32 product with TF32 allowed at trace time too (494.7 TFLOP/s), and an
f32 product in IEEE f32 outside them, at ``hw.peak_flops`` (67 TFLOP/s):
NVIDIA H100 SXM data sheet, dense rates (``TENSOR_CORE_PEAKS``). The
peaks are the data sheet's, so every term is a prediction, not a
measurement. ``HardwareConfig`` keeps the reference's fields (``pred``
records fingerprint it), so the tensor-core table lives here.

The reference hard-codes its TPU's bf16 peak in two places (``_PEAK`` in
its ``terms.py`` and the useful-fraction line of its ``report.py``); the
port carries no such constant and takes every peak from ``hw`` and the
table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import HardwareConfig, ModelConfig, ShapeConfig
from repro_torch.roofline.trace import FREE_OPS, PRODUCTS, OpRecord

# dense tensor-core peaks of the NVIDIA H100 SXM (data sheet), by the
# products' dtype; "tf32" is an f32 product with TF32 allowed
TENSOR_CORE_PEAKS = {"bfloat16": 989.4e12, "float16": 989.4e12,
                     "tf32": 494.7e12}

GATHERS = frozenset({"aten.index.Tensor", "aten.index_select.default",
                     "aten.gather.default", "aten.embedding.default"})

# in-place writes of a source into selected positions: they write (and,
# accumulating, read back) the source's bytes, not the destination's
SCATTERS = frozenset({"aten.index_put_.default",
                      "aten._index_put_impl_.default",
                      "aten.index_copy_.default", "aten.index_add_.default",
                      "aten.scatter_.src", "aten.scatter_.value",
                      "aten.scatter_add_.default",
                      "aten.masked_scatter_.default"})
ACCUMULATING = frozenset({"aten.index_add_.default",
                          "aten.scatter_add_.default"})

# writes that do not read the tensor they write
OVERWRITES = frozenset({"aten.copy_.default", "aten.fill_.Scalar",
                        "aten.fill_.Tensor", "aten.zero_.default",
                        "aten.normal_.default", "aten.uniform_.default"})

# factories shaped like an operand: they write, and read nothing
LIKE_FACTORIES = frozenset({"aten.zeros_like.default",
                            "aten.ones_like.default",
                            "aten.full_like.default",
                            "aten.rand_like.default",
                            "aten.randn_like.default"})

# c10d op -> the reference's collective opcode
COLLECTIVES = {
    "c10d.allreduce_.default": "all-reduce",
    "c10d.allreduce_coalesced_.default": "all-reduce",
    "c10d.allgather_.default": "all-gather",
    "c10d._allgather_base_.default": "all-gather",
    "c10d.allgather_into_tensor_coalesced_.default": "all-gather",
    "c10d.reduce_scatter_.default": "reduce-scatter",
    "c10d._reduce_scatter_base_.default": "reduce-scatter",
    "c10d.alltoall_.default": "all-to-all",
    "c10d.alltoall_base_.default": "all-to-all",
    "c10d.send.default": "collective-permute",
    "c10d.recv_.default": "collective-permute",
}

WIRE_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def product_flops(rec: OpRecord) -> float:
    """2 · prod(result dims) · prod(contracting dims) of one product (0 for
    any other op)."""
    if rec.name not in PRODUCTS or not rec.outputs:
        return 0.0
    out = _prod(rec.outputs[0].shape)
    ins = [t.shape for t in rec.inputs]
    if rec.name == "aten.convolution.default":
        weight = ins[1]                  # (C_out, C_in / groups, *kernel)
        return 2.0 * out * _prod(weight[1:])
    lhs = ins[1] if rec.name in ("aten.addmm.default",
                                 "aten.baddbmm.default") else ins[0]
    return 2.0 * out * lhs[-1]


def product_unit(rec: OpRecord) -> str:
    """The unit a product runs on: its dtype's tensor-core row, "tf32", or
    "fp32" (IEEE f32 outside the tensor cores)."""
    dt = rec.inputs[0].dtype if rec.inputs else "float32"
    if rec.name in ("aten.addmm.default", "aten.baddbmm.default"):
        dt = rec.inputs[1].dtype
    if dt in TENSOR_CORE_PEAKS:
        return dt
    if dt == "float32" and rec.tf32:
        return "tf32"
    return "fp32"


def unit_peak(unit: str, hw: HardwareConfig) -> float:
    return TENSOR_CORE_PEAKS.get(unit, hw.peak_flops)


def dot_flops(ops) -> float:
    """Every product's FLOPs summed (the reference's ``parsed_dot_flops``)."""
    return sum(product_flops(r) for r in ops)


# ---------------------------------------------------------------------------
# HBM traffic model
# ---------------------------------------------------------------------------

def op_traffic(rec: OpRecord) -> float:
    """The HBM bytes one op moves under the traffic model (module
    docstring)."""
    if rec.view or rec.name in FREE_OPS or rec.name.startswith("c10d."):
        return 0.0
    ins = [t.nbytes for t in rec.inputs]
    if rec.name in LIKE_FACTORIES:
        return float(sum(t.nbytes for t in rec.outputs))
    if rec.name in GATHERS:
        src = 1 if rec.name == "aten.embedding.default" else 0
        got = sum(t.nbytes for t in rec.outputs)
        idx = sum(b for i, b in enumerate(ins) if i != src)
        return float(2 * got + idx)
    if rec.inplace:
        dst = set(rec.written)
        rest = sum(b for i, b in enumerate(ins) if i not in dst)
        if rec.name in SCATTERS:
            # the source (the largest operand that is not the destination
            # or an index) is written; the indices are read
            src = max((b for i, b in enumerate(ins) if i not in dst),
                      default=0)
            return float(rest + src * (2 if rec.name in ACCUMULATING
                                       else 1))
        wrote = sum(ins[i] for i in dst)
        if rec.name in OVERWRITES:
            return float(rest + wrote)
        return float(rest + 2 * wrote)      # read, modify, write
    return float(sum(ins) + sum(t.nbytes for t in rec.outputs))


def traffic_bytes(ops) -> float:
    return sum(op_traffic(r) for r in ops)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def collective_wire_bytes(ops, *, default_group: int
                          ) -> tuple[float, dict[str, float]]:
    """Per-rank wire bytes (ring models) and a per-collective breakdown.
    Payload: the gathered bytes for an all-gather, the larger of the
    operand and result bytes otherwise (the reference's rule)."""
    total = 0.0
    by_op: dict[str, float] = {}
    for r in ops:
        kind = COLLECTIVES.get(r.name)
        if kind is None:
            continue
        g = r.group_size or default_group
        # a c10d op's results are the buffers it writes, which are among
        # its operands too (an all-reduce's are its inputs themselves)
        ins = sum(t.nbytes for t in r.inputs)
        outs = sum(t.nbytes for t in r.outputs)
        payload = outs if kind == "all-gather" else max(ins - outs, outs)
        wire = payload * WIRE_FACTOR[kind](g)
        total += wire
        by_op[kind] = by_op.get(kind, 0.0) + wire
    return total, by_op


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful" flops)
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D for training, 2·N_active·tokens for inference-only steps."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    t_compute: float
    t_memory: float
    t_ici: float
    dominant: str
    model_flops_total: float
    useful_ratio: float            # MODEL_FLOPS / (chips · flops_per_chip)
    collective_breakdown: dict[str, float]
    xla_flops: Optional[float] = None      # the trace's product FLOPs
    xla_bytes: Optional[float] = None      # the trace's HBM bytes
    memory_stats: Optional[dict] = None
    # the peak the useful fraction is taken against (the products' unit)
    peak_flops: float = TENSOR_CORE_PEAKS["bfloat16"]

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_ici)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute utilization at the modeled bound: the MFU the step
        would reach if it ran exactly at max(term)."""
        if self.bound_time <= 0:
            return 0.0
        t_useful = (self.model_flops_total / self.n_chips) / self.peak_flops
        return t_useful / self.bound_time

    def row(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:6s} "
                f"Tc={self.t_compute*1e3:9.3f}ms Tm={self.t_memory*1e3:9.3f}ms "
                f"Ti={self.t_ici*1e3:9.3f}ms -> {self.dominant:8s} "
                f"useful={self.useful_ratio:6.1%} "
                f"roofline_frac={self.roofline_fraction:6.1%}")


def compute_seconds(ops, hw: HardwareConfig) -> tuple[float, float]:
    """(product FLOPs, seconds at each product's unit peak)."""
    flops = seconds = 0.0
    for r in ops:
        f = product_flops(r)
        if f:
            flops += f
            seconds += f / unit_peak(product_unit(r), hw)
    return flops, seconds


def model_unit_peak(cfg: ModelConfig, hw: HardwareConfig) -> float:
    """The peak of the unit that runs the model's products (its compute
    dtype's tensor-core rate; IEEE f32 at ``hw.peak_flops``)."""
    return TENSOR_CORE_PEAKS.get(cfg.compute_dtype, hw.peak_flops)


def analyze_trace(ops, *, arch: str, shape: ShapeConfig, mesh_name: str,
                  n_chips: int, hw: HardwareConfig, cfg: ModelConfig,
                  memory_stats: Optional[dict] = None) -> RooflineReport:
    """The port's ``analyze_compiled_text``: the three terms of one traced
    per-rank program."""
    flops, t_c = compute_seconds(ops, hw)
    hbm = traffic_bytes(ops)
    wire, by_op = collective_wire_bytes(ops, default_group=n_chips)
    t_m = hbm / hw.hbm_bw
    t_i = wire / hw.ici_bw
    dom = max(("compute", t_c), ("memory", t_m), ("ici", t_i),
              key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    useful = mf / (n_chips * flops) if flops else 0.0
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        flops_per_chip=flops, hbm_bytes_per_chip=hbm,
        wire_bytes_per_chip=wire, t_compute=t_c, t_memory=t_m, t_ici=t_i,
        dominant=dom, model_flops_total=mf, useful_ratio=useful,
        collective_breakdown=by_op, xla_flops=flops, xla_bytes=hbm,
        memory_stats=memory_stats, peak_flops=model_unit_peak(cfg, hw))
