"""Shared building blocks: norms, rope, embeddings, gated MLPs, cross-entropy.

PyTorch port of the reference's ``repro.models.layers``. Parameters live in
small ``nn.Module``s whose attribute names are the reference's param-tree
keys (``RMSNorm.scale``, ``Embedding.table``/``head``, ``MLP.w_gate`` ...),
so ``convert.lm_params_to_torch`` maps one tree onto the other key for key.
The functions take those modules where the reference takes dicts.

``init_*`` draw the reference's distributions (N(0,1)·scale in f32, cast to
``param_dtype``; norms ones) from a ``torch.Generator`` on the module's
device: the draws are not JAX's bits, so the tests hand both packages the
reference's own initialised params. ``constrain`` (a sharding hint in the
reference) has no counterpart on one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    """The parameters' dtype."""
    return _DTYPES[cfg.param_dtype]


def cdtype_of(cfg) -> torch.dtype:
    """The activations' (compute) dtype."""
    return _DTYPES[cfg.compute_dtype]


def param(t: torch.Tensor) -> nn.Parameter:
    """A frozen parameter (the port serves and probes; it does not train)."""
    return nn.Parameter(t, requires_grad=False)


def _normal(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """N(0, 1)·scale drawn in f32 on the generator's device, cast to
    ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


# ----------------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = param(scale)


def init_rmsnorm(dim: int, cfg, device) -> RMSNorm:
    return RMSNorm(torch.ones((dim,), dtype=dtype_of(cfg), device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in f32, returned in ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: int tensor (...,) -> (cos, sin) of shape (..., head_dim//2),
    f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate by halves (not interleaved). x: (..., S, H, D); cos/sin: (S,
    D//2), (B, S, D//2) (per-example positions) or broadcastable."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if cos.ndim in (x1.ndim - 2, x1.ndim - 1):  # insert the head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------------

class Embedding(nn.Module):
    """``table`` (V, D); ``head`` (D, V) only when embeddings are untied."""

    def __init__(self, table: torch.Tensor, head=None):
        super().__init__()
        self.table = param(table)
        self.head = None if head is None else param(head)


def init_embedding(gen: torch.Generator, cfg) -> Embedding:
    table = _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype_of(cfg))
    head = None
    if not cfg.tie_embeddings:
        head = _normal(gen, (cfg.d_model, cfg.vocab_size),
                       cfg.d_model ** -0.5, dtype_of(cfg))
    return Embedding(table, head)


def embed(p: Embedding, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return p.table[tokens].to(cdtype_of(cfg))


def unembed(p: Embedding, h: torch.Tensor, cfg) -> torch.Tensor:
    table = p.head if p.head is not None else p.table.T
    logits = h @ table.to(cdtype_of(cfg))
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ----------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ----------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate = param(w_gate)
        self.w_up = param(w_up)
        self.w_down = param(w_down)


def init_mlp(gen: torch.Generator, cfg, d_ff=None) -> MLP:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return MLP(_normal(gen, (d, f), d ** -0.5, dt),
               _normal(gen, (d, f), d ** -0.5, dt),
               _normal(gen, (f, d), f ** -0.5, dt))


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "geglu":
        # jax.nn.gelu's default is the tanh approximation; torch's is erf
        return F.gelu(x, approximate="tanh")
    return F.silu(x)  # swiglu


def mlp(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    g = x @ p.w_gate.to(x.dtype)
    u = x @ p.w_up.to(x.dtype)
    hidden = _act(cfg.act, g) * u
    return hidden @ p.w_down.to(x.dtype)


# ----------------------------------------------------------------------------
# Cross-entropy (fp32)
# ----------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """logits (B,S,V), labels (B,S) int, mask (B,S) 1=count. Returns the
    mean nll (f32 scalar)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
