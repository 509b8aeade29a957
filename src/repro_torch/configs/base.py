"""Model, shape and hardware configurations.

``ModelConfig`` and ``ShapeConfig`` are the reference's (``repro.configs.
base``), field for field, so the ten ``configs/<arch>.py`` data modules
resolve to the same names, widths and smoke reductions in both packages.

Hardware models for the analytic saturation model (``core/analytic.py``):

``HardwareConfig`` has the reference's field names and order, so a ``pred``
record (``core/campaign.py:AnalyticCampaign``, which stores
``dataclasses.asdict(hw)``) written by either package matches the other's
field for field. Its defaults are the NVIDIA H100 SXM's; no TPU figure is
kept here. Tests that compare the two packages hand the reference's own
configurations to both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    act: str = "swiglu"          # swiglu | geglu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- attention extras ---
    window: int = 0              # sliding-window size; 0 = full attention
    attn_impl: str = "blocked"   # blocked | flash (online-softmax, static
    #                              triangular/window pruning) — §Perf lever

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden size (d_ff used for dense part if any)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0           # N (state size per head); 0 = no ssm blocks
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (zamba2) ---
    attn_every: int = 0          # insert the shared attention block every N ssm blocks

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 0          # encoder sequence length (precomputed frame embeds)

    # --- vlm (llava) ---
    n_img_tokens: int = 0        # precomputed patch-embedding tokens per example

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ---- derived helpers -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    # Parameter count estimate (for MODEL_FLOPS = 6 N D and memory budgeting).
    def param_count(self) -> int:
        n = 0
        d = self.d_model
        # embeddings (+ untied head)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm", "moe"):
            per = self._attn_params() + self._mlp_params()
            n += self.n_layers * per
        elif self.family == "encdec":
            enc = self.enc_layers * (self._attn_params() + self._mlp_params())
            dec = self.n_layers * (2 * self._attn_params() + self._mlp_params())
            n += enc + dec
        elif self.family == "ssm":
            n += self.n_layers * self._ssm_params()
        elif self.family == "hybrid":
            n += self.n_layers * self._ssm_params()
            n += self._attn_params() + self._mlp_params()  # one shared block
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.family == "moe" and self.n_experts:
            return self.n_experts * 3 * d * self.moe_d_ff
        return 3 * d * self.d_ff  # gated MLPs (swiglu/geglu): w_gate, w_up, w_down

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        nh, ns = self.ssm_nheads, self.ssm_state
        ng = self.ssm_ngroups
        in_proj = d * (2 * di + 2 * ng * ns + nh)   # x, z, B, C, dt
        conv = self.ssm_conv * (di + 2 * ng * ns)
        out = di * d
        extra = nh * 2 + di                          # A_log, D, norm
        return in_proj + conv + out + extra


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


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
