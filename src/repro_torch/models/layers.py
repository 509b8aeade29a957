"""Shared building blocks: norms, rope, embeddings, gated MLPs, cross-entropy.

PyTorch port of the reference's ``repro.models.layers``. Parameters live in
small ``nn.Module``s whose attribute names are the reference's param-tree
keys (``RMSNorm.scale``, ``Embedding.table``/``head``, ``MLP.w_gate`` ...),
so ``convert.lm_params_to_torch`` maps one tree onto the other key for key.
The functions take those modules where the reference takes dicts.

``init_*`` draw the reference's distributions (N(0,1)·scale in f32, cast to
``param_dtype``; norms ones) from a ``torch.Generator`` on the module's
device: the draws are not JAX's bits, so the tests hand both packages the
reference's own initialised params. ``spec_*`` give each module's logical
axes, the reference's, for ``parallel.sharding.resolve``.

Tensor parallelism over ``model`` (the reference's rules: ``vocab`` and
``ff`` to ``model``, which GSPMD splits where ``constrain`` places them):
a module whose weights are this rank's shard of the ``vocab`` or ``ff``
dim (the mesh step and the mesh serving gather such a leaf over the
other axes only; ``train/trainer.py``) computes its part, and the
functions tell the shard from the whole by the weight's shape against
the config's. ``embed`` looks up the rank's rows (the others give 0) and
sums the ranks' lookups; ``unembed`` gives the rank's vocabulary slice of
the logits (the softcap is element-wise, so per shard); ``mlp`` runs
``w_gate`` and ``w_up`` column-parallel and ``w_down`` row-parallel, its
partial sums added over ``model`` in f32 (``row_parallel``);
``softmax_xent`` with ``vocab`` reduces a slice's max, sum of
exponentials and gold logit over ``model``, so no rank holds the whole
logits. The input of a split product enters through
``copy_to_model``, whose backward sums the ranks' gradients
(``parallel.sharding``). With whole weights nothing of this runs. Under a
mesh step a masked NLL also sums its numerator and denominator over the
batch axes (``parallel.sharding.batch_sum``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel import sharding as sh

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    """The parameters' dtype."""
    return _DTYPES[cfg.param_dtype]


def cdtype_of(cfg) -> torch.dtype:
    """The activations' (compute) dtype."""
    return _DTYPES[cfg.compute_dtype]


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter created frozen: serving and probing take no gradient,
    and the trainer turns ``requires_grad`` on for its step only
    (``train/trainer.py``)."""
    return nn.Parameter(t, requires_grad=False)


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, where none
    can be made: ``_normal`` draws nothing from it and makes an empty meta
    tensor of the shape and dtype it would draw."""
    device = torch.device("meta")


def _normal(gen: torch.Generator, shape, scale, dtype) -> torch.Tensor:
    """N(0, 1)·scale drawn in f32 on the generator's device, cast to
    ``dtype`` (shape and dtype only on the meta device)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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


def spec_rmsnorm() -> dict:
    return {"scale": (None,)}


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in f32, returned in ``x``'s dtype."""
    return rms_scale(x, p.scale, eps)


def rms_scale(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """``rmsnorm`` with a bare scale tensor (the SSM's gated ``norm``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def stacked(n: int, one: dict) -> dict:
    """One layer's cache tensors repeated on a leading (n, ...) axis, as the
    reference stacks a scanned cache (a ring's ``kpos`` keeps its -1s)."""
    return {name: t.expand((n,) + tuple(t.shape)).clone()
            for name, t in one.items()}


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


def spec_embedding(cfg) -> dict:
    s = {"table": ("vocab", "fsdp")}
    if not cfg.tie_embeddings:
        s["head"] = ("fsdp", "vocab")
    return s


def embed(p: Embedding, tokens: torch.Tensor, cfg) -> torch.Tensor:
    rows = p.table.shape[0]
    if rows == cfg.vocab_size:
        return p.table[tokens].to(cdtype_of(cfg))
    # this rank's vocabulary rows: ids outside them look up 0
    local = tokens.long() - sh.model_rank() * rows
    inside = (local >= 0) & (local < rows)
    x = p.table[torch.where(inside, local, 0)]
    x = torch.where(inside[..., None], x, 0).to(cdtype_of(cfg))
    return sh.reduce_from_model(x)


def unembed(p: Embedding, h: torch.Tensor, cfg) -> torch.Tensor:
    """h (..., D) -> logits (..., V), or this rank's vocabulary slice of
    them (..., V / model) when ``p`` holds its shard."""
    table = p.head if p.head is not None else p.table.T
    if table.shape[-1] != cfg.vocab_size:
        h = sh.copy_to_model(h)
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


def spec_mlp() -> dict:
    return {"w_gate": ("fsdp", "ff"), "w_up": ("fsdp", "ff"),
            "w_down": ("ff", "fsdp")}


# ----------------------------------------------------------------------------
# Spec trees
# ----------------------------------------------------------------------------

def named_specs(tree: dict, prefix: str = "") -> dict:
    """A nested spec dict (the reference's tree of logical-axis tuples) ->
    {``named_parameters`` name: logical tuple}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(named_specs(value, name + "."))
        else:
            out[name] = value
    return out


def per_layer_specs(name: str, n: int, layer: dict) -> dict:
    """The specs of ``n`` layer modules ``name.0`` .. ``name.{n-1}``, each
    ``layer``: the reference stacks the leaves on a leading (L, ...) axis
    named None, and the port holds one module a layer, so the port's spec
    of ``name.i.<leaf>`` is the reference's without that entry."""
    one = named_specs(layer)
    return {f"{name}.{i}.{leaf}": spec for i in range(n)
            for leaf, spec in one.items()}


def stack_spec(tree: dict) -> dict:
    """A cache spec tree with every leaf stacked on a leading layer (or
    invocation) axis, as the caches are (``stacked``)."""
    return {k: stack_spec(v) if isinstance(v, dict) else (None,) + v
            for k, v in tree.items()}


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "geglu":
        # jax.nn.gelu's default is the tanh approximation; torch's is erf
        return F.gelu(x, approximate="tanh")
    return F.silu(x)  # swiglu


def mlp(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    split = p.w_gate.shape[1] != cfg.d_ff
    if split:       # this rank's ff columns
        x = sh.copy_to_model(x)
    g = x @ p.w_gate.to(x.dtype)
    u = x @ p.w_up.to(x.dtype)
    hidden = _act(cfg.act, g) * u
    if split:
        return sh.row_parallel(hidden, p.w_down.to(x.dtype))
    return hidden @ p.w_down.to(x.dtype)


# ----------------------------------------------------------------------------
# Cross-entropy (fp32)
# ----------------------------------------------------------------------------

def _xent_terms_over_model(lf: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, gold logit) (B,S) from this rank's vocabulary slice
    ``lf`` (B,S,V / model) of f32 logits: the max, the sum of
    exponentials and the gold logit reduced over ``model``."""
    rows = lf.shape[-1]
    m = sh.max_over_model(lf.amax(dim=-1))
    se = sh.reduce_from_model(torch.exp(lf - m[..., None]).sum(dim=-1))
    local = labels.long() - sh.model_rank() * rows
    inside = (local >= 0) & (local < rows)
    gold = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])
    gold = sh.reduce_from_model(torch.where(inside, gold[..., 0], 0.0))
    return torch.log(se) + m, gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None, *,
                 vocab=None):
    """logits (B,S,V), labels (B,S) int, mask (B,S) 1=count. Returns the
    mean nll (f32 scalar). ``vocab``: the model's vocabulary; logits of
    fewer columns are this rank's slice over ``model`` (vocab-parallel)."""
    lf = logits.float()
    if vocab is None or lf.shape[-1] == vocab:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    else:
        lse, gold = _xent_terms_over_model(lf, labels)
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    num, den = torch.sum(nll * m), torch.sum(m)
    if sh.batch_ranks():    # a mesh step: the sums of the global batch
        num, den = sh.batch_sum(num), sh.batch_sum(den)
    return num / torch.clamp(den, min=1.0)
