"""Model, shape and hardware configurations.

``ModelConfig``, ``ShapeConfig`` (with ``SHAPES`` and ``shape_applicable``),
``MeshConfig`` and ``TrainConfig`` are the reference's (``repro.configs.
base``), field for field and default for default, so the ten
``configs/<arch>.py`` data modules resolve to the same names, widths and
smoke reductions in both packages, and a training run takes the same
hyperparameters.

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

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode at 500k context without a full-attention KV
        scan? True for SSM / hybrid and sliding-window attention."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window > 0

    @property
    def has_decode(self) -> bool:
        """Every assigned arch decodes (whisper's decoder does)."""
        return True

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

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        moe_active = 3 * d * self.moe_d_ff * self.top_k
        n += self.n_layers * (self._attn_params() + moe_active)
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


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("full attention at 524288 ctx — skipped per "
                       "assignment (sub-quadratic only)")
    if shape.is_decode and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    return True, ""


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names (the reference's); a live mesh
    is ``parallel.sharding.make_mesh_from_config``'s."""
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1            # grad accumulation
    remat: str = "nothing"           # nothing | dots | full  (what to SAVE)
    scan_group: int = 1              # layers per checkpointed group
    grad_compress: str = "none"      # none | int8
    seed: int = 0
    ckpt_every: int = 200
    ckpt_dir: str = "/tmp/repro_ckpt"
    step_deadline_s: float = 0.0     # straggler watchdog; 0 = off


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
