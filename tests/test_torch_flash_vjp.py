"""The port's flash attention (``repro_torch.models.attention``:
``FlashAttention``, a ``torch.autograd.Function``) against the reference's
``custom_vjp`` (``repro.models.attention._sdpa_flash_core``) on the CPU:

* the forward and dq, dk, dv for a random dO, causal, windowed,
  non-causal, with S not a multiple of the block (the divisor fallback)
  and with unequal q and kv blocks;
* the static pruning ranges (``_flash_blocks``) equal the reference's;
* ``FlashAttention`` against autograd through the port's own blocked
  path, and ``attn_train`` with ``attn_impl="flash"`` against the
  reference's (MQA: the repeated KV heads' gradients summed);
* no (S, S) score tensor is saved for the backward.

Inputs from numpy seeds, f32. Tolerance: 1e-5 of each result's largest
|value| (both sides sum the same f32 tiles; measured differences ~1e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as rattn
from repro_torch import configs
from repro_torch.models import attention as attn

SHARE = 1e-5

# (label, B, H, S, hd, causal, window, q_block, kv_block)
CASES = (
    ("causal", 2, 3, 64, 16, True, 0, 16, 16),
    ("window", 2, 3, 64, 16, True, 24, 16, 16),
    ("non-causal", 1, 2, 64, 8, False, 0, 16, 16),
    ("non-causal window", 1, 2, 48, 8, False, 12, 16, 16),
    ("S not a block multiple", 2, 2, 60, 16, True, 0, 16, 16),
    ("unequal blocks", 1, 2, 64, 16, True, 20, 32, 8),
    ("one block", 1, 1, 24, 8, True, 0, 1024, 1024),
)


def _qkvdo(B, H, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, S, hd)).astype(np.float32)
                 for _ in range(4))


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= SHARE * scale, f"{what}: {err} > {SHARE} * {scale}"


def _port_vjp(q, k, v, do, causal, window, qb, kb):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attn.FlashAttention.apply(*ts, causal, window, qb, kb)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return out.detach(), grads


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_forward_and_vjp_equal_the_reference(case):
    _, B, H, S, hd, causal, window, qb, kb = case
    q, k, v, do = _qkvdo(B, H, S, hd)
    out, vjp = jax.vjp(lambda a, b, c: rattn._sdpa_flash_core(
        a, b, c, causal, window, qb, kb), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got_out, got = _port_vjp(q, k, v, do, causal, window, qb, kb)
    _close(got_out, out, "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pruning_ranges_equal_the_reference(case):
    _, _, _, S, _, causal, window, qb, kb = case
    assert attn._flash_blocks(S, qb, kb, causal, window) == \
        rattn._flash_blocks(S, qb, kb, causal, window)


@pytest.mark.parametrize("case", CASES[:5], ids=[c[0] for c in CASES[:5]])
def test_flash_against_autograd_through_the_blocked_path(case):
    """The hand-written backward against autograd's own, through the
    port's blocked softmax on the same inputs."""
    _, B, H, S, hd, causal, window, qb, kb = case
    q, k, v, do = _qkvdo(B, H, S, hd, seed=1)
    got_out, got = _port_vjp(q, k, v, do, causal, window, qb, kb)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    pos = torch.arange(S)

    def mask_fn(qpos, kidx):
        keep = torch.ones((qpos.shape[0], kidx.shape[0]), dtype=torch.bool)
        if causal:
            keep &= qpos[:, None] >= pos[kidx][None, :]
        if window:
            keep &= qpos[:, None] - pos[kidx][None, :] < window
        return keep

    out = attn._sdpa_blocked(None, *ts, mask_fn, pos, qb)
    want = torch.autograd.grad(out, ts, torch.from_numpy(do))
    _close(got_out, out.detach(), "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


@pytest.mark.parametrize("window", [0, 12])
def test_attn_train_flash_grads_equal_the_reference(window):
    """gemma smoke widths (MQA: 4 query heads on 1 KV head), seq 48 in q
    blocks of 16: output and the gradients of wq, wk, wv, wo and x."""
    rcfg = _f32(ref_configs.get_smoke_config("gemma_2b"), attn_impl="flash")
    cfg = _f32(configs.get_smoke_config("gemma_2b"), attn_impl="flash")
    rp = rattn.init_attention(jax.random.PRNGKey(3), rcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    positions = np.arange(48, dtype=np.int32)

    def ref(params, xx):
        return rattn.attn_train(params, rcfg, xx, jnp.asarray(positions),
                                window=window, q_block=16)

    y, vjp = jax.vjp(ref, rp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))

    tp = attn.Attention(*(torch.from_numpy(np.array(rp[w]))
                          for w in ("wq", "wk", "wv", "wo")))
    leaves = [tp.wq, tp.wk, tp.wv, tp.wo]
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = attn.attn_train(tp, cfg, tx, torch.from_numpy(positions),
                         window=window, q_block=16)
    got = torch.autograd.grad(ty, leaves + [tx], torch.from_numpy(dy))
    _close(ty.detach(), y, "y")
    for name, g in zip(("wq", "wk", "wv", "wo"), got[:4]):
        _close(g, gp[name], name)
    _close(got[4], gx, "x")


def test_flash_saves_no_score_matrix():
    """Only O(S·hd) tensors and the (S, 1) row stats are saved: no
    (q_block, kv_block) tile and no (S, S) scores."""
    S, hd, blk = 64, 8, 16
    q, k, v, _ = _qkvdo(1, 2, S, hd)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        attn.FlashAttention.apply(*ts, True, 0, blk, blk)
    assert saved, "nothing saved"
    for shape in saved:
        assert shape[-1] in (hd, 1), shape
