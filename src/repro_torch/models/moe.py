"""Mixture-of-Experts: top-k routing with sort-based, capacity-bounded
dispatch.

PyTorch port of the reference's ``repro.models.moe``: the same router (f32),
softmax → top-k → renormalise, Switch load-balance and router z-losses, and
the same group-local dispatch — a stable argsort of the (token, choice)
pairs by expert, each pair's slot in its expert's buffer, and a scatter into
an (E, C, D) buffer whose pairs past the capacity C are dropped. The three
expert products are batched matmuls in the compute dtype, as the reference
leaves them to XLA outside any Pallas kernel.

Every op is capture-safe, so a CUDA graph can hold the step
(``core/injector.py``): the per-expert counts are a ``scatter_add_`` into a
zero (E,) tensor (``bincount`` reads its input's max on the host), and the
dropped pairs of jnp's ``mode="drop"`` scatter land in a trash row C of an
(E, C + 1, D) buffer that is sliced away. Nothing is read back to the host.

The router product stays IEEE f32 on the card (``_ieee_f32``): a TF32 router
moves the routing, and with it the tokens.

Under a mesh the MoE model's attention and embedding compute split over
``model`` (``models/transformer.py``), while the experts are gathered
whole and run replicated on the whole residual stream: expert
parallelism is later work. Each rank (``train/trainer.py``) routes its
own batch shard,
whose groups are the reference's (its groups are contiguous token blocks,
one a data-parallel shard). The load-balance loss is not linear in the
shards, so its two terms, ``me`` and ``ce``, are summed over the mesh's
batch axes before their product (``parallel.sharding.batch_sum``, an
all-reduce whose gradient reaches every rank's ``me``).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.models.layers import _act, _normal, cdtype_of, dtype_of, param
from repro_torch.parallel import sharding as sh


class MoE(nn.Module):
    """router (D, E) f32; w_gate / w_up (E, D, F), w_down (E, F, D) in the
    config's dtype."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router = param(router)
        self.w_gate = param(w_gate)
        self.w_up = param(w_up)
        self.w_down = param(w_down)


def init_moe(gen: torch.Generator, cfg) -> MoE:
    """The four tensors drawn from ``gen`` one at a time, in the order of
    the reference's ``jax.random.split``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    router = _normal(gen, (d, e), d ** -0.5, torch.float32)
    w_gate = _normal(gen, (e, d, f), d ** -0.5, dt)
    w_up = _normal(gen, (e, d, f), d ** -0.5, dt)
    w_down = _normal(gen, (e, f, d), f ** -0.5, dt)
    return MoE(router, w_gate, w_up, w_down)


def spec_moe() -> dict:
    return {"router": (None, None),
            "w_gate": ("experts", "fsdp", "expert_ff"),
            "w_up": ("experts", "fsdp", "expert_ff"),
            "w_down": ("experts", "expert_ff", "fsdp")}


def _capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor 8


@contextlib.contextmanager
def _ieee_f32():
    """f32 matmuls in full precision inside the block (no TF32)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _group_dispatch(xg, eg, n_experts: int, capacity: int):
    """xg (G, Tg, D); eg (G, Tg, k) -> buf (G, E, C, D), slots (G, Tg, k)
    each pair's slot in its expert (>= C: dropped)."""
    G, Tg, k = eg.shape
    dev = xg.device
    flat_e = eg.reshape(G, Tg * k).long()
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, n_experts), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts            # exclusive
    pos_sorted = (torch.arange(Tg * k, device=dev)[None]
                  - torch.gather(starts, 1, sorted_e))
    slots = torch.zeros_like(flat_e).scatter_(1, order, pos_sorted)
    tok_of = order // k                                      # (G, Tg*k)
    # mode="drop": pairs past the capacity go to the trash row C
    row = torch.clamp(pos_sorted, max=capacity)
    buf = torch.zeros((G, n_experts, capacity + 1, xg.shape[-1]),
                      dtype=xg.dtype, device=dev)
    g = torch.arange(G, device=dev)[:, None]
    buf[g, sorted_e, row] = xg[g, tok_of]
    return buf[:, :, :capacity], slots.reshape(G, Tg, k)


def _group_combine(out_buf, eg, slots, gates, capacity: int):
    """out_buf (G, E, C, D) -> y (G, Tg, D) weighted by the gates; dropped
    pairs weigh 0."""
    G = out_buf.shape[0]
    g = torch.arange(G, device=out_buf.device)[:, None, None]
    gathered = out_buf[g, eg.long(), torch.clamp(slots, max=capacity - 1)]
    w = torch.where(slots >= capacity, 0.0, gates).to(gathered.dtype)
    return torch.einsum("gtkd,gtk->gtd", gathered, w)


def moe_block(p: MoE, cfg, x, n_groups: int = 1):
    """x (B,S,D) -> (y (B,S,D), {"moe_lb_loss", "moe_z_loss"}). Under
    ``parallel.sharding.global_routing`` (a per-rank decode) x is this
    rank's rows, and the global batch's rows are routed."""
    x = sh.routed(x)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = n_groups if T % n_groups == 0 else 1
    Tg = T // G
    C = _capacity(Tg, cfg)

    xf = x.reshape(T, D)
    with _ieee_f32():
        logits = xf.float() @ p.router.float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)                  # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # aux losses: load balance (Switch) + router z-loss
    me = torch.mean(probs, dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ce.index_add_(0, eidx.reshape(-1), torch.ones_like(gates).reshape(-1))
    ranks = sh.batch_ranks()
    if ranks:       # a mesh step: the terms of the global batch
        me = sh.batch_sum(me) / ranks
        ce = sh.batch_sum(ce) / (T * ranks * k)
    else:
        ce = ce / (T * k)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    eg = eidx.reshape(G, Tg, k)
    buf, slots = _group_dispatch(xf.reshape(G, Tg, D), eg, E, C)
    out = _experts(p, cfg, buf)
    y = _group_combine(out, eg, slots, gates.reshape(G, Tg, k), C)
    return sh.own_rows(y.reshape(B, S, D)), {"moe_lb_loss": lb_loss,
                                             "moe_z_loss": z_loss}


def _experts(p: MoE, cfg, buf):
    """The gated expert FFNs over (G, E, C, D) -> (G, E, C, D): three
    batched matmuls over the E experts in the compute dtype (the weights
    are used as they are; ``.to`` of a tensor already in that dtype is the
    identity, so no copy of the experts is made)."""
    G, E, C, D = buf.shape
    cd = cdtype_of(cfg)
    h = buf.transpose(0, 1).reshape(E, G * C, D).to(cd)
    g = torch.bmm(h, p.w_gate.to(cd))
    u = torch.bmm(h, p.w_up.to(cd))
    out = torch.bmm(_act(cfg.act, g) * u, p.w_down.to(cd))      # (E, GC, D)
    return out.reshape(E, G, C, D).transpose(0, 1)
