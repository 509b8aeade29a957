"""Hardware models for the analytic saturation model (``core/analytic.py``).

``HardwareConfig`` has the reference's field names and order, so a ``pred``
record (``core/campaign.py:AnalyticCampaign``, which stores
``dataclasses.asdict(hw)``) written by either package matches the other's
field for field. Its defaults are the NVIDIA H100 SXM's; no TPU figure is
kept here. Tests that compare the two packages hand the reference's own
configurations to both.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareConfig:
    """One chip's peaks. Defaults: the NVIDIA H100 SXM (``H100_SXM``)."""
    name: str = "h100_sxm"
    # FP32 outside the tensor cores, 67 TFLOP/s (NVIDIA H100 SXM data
    # sheet, dense): the peak chip_smoke.py's bounds use for the loop
    # kernels and the noise patterns, whose arithmetic is FP32 FADD/FMUL
    peak_flops: float = 67e12
    hbm_bw: float = 3.35e12          # HBM3, bytes/s (data sheet)
    # NVLink 4: 900 GB/s to the other cards of the host, 450 GB/s each way
    # (data sheet); the model reads it as one direction's bytes/s
    ici_bw: float = 450e9
    hbm_bytes: int = 80 * 1024**3    # 80 GB: five HBM3 stacks of 16 GiB
    # the data sheet gives no latency: one dependent hop of a pointer chase
    # through a 256 MiB table that goes on from call to call, so its lines
    # are not the L2's (chip_smoke.py's phase-6 hbm_latency row, 340.75 ns
    # on the device, NVIDIA H100 80GB HBM3 at 700 W; PERF.md). The
    # lat_mem_rd loop's 146.63 ns hop repeats its 8,192 hops every call:
    # an L2 hit time.
    hbm_latency_s: float = 340.75e-9


H100_SXM = HardwareConfig()
# A DDR-class point for the paper's Table-1/4 style comparison: the H100's
# compute behind a disaggregated, CXL-attached memory with the generic
# bandwidth and latency the reference's CXL_MEM point uses (256 GB/s,
# 1.4 µs) and its capacity (512 GiB).
H100_CXL_DDR = HardwareConfig(name="h100_cxl_ddr", hbm_bw=256e9,
                              hbm_bytes=512 * 1024**3,
                              hbm_latency_s=1400e-9)
