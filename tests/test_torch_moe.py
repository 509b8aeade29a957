"""The port's MoE family (``repro_torch.models.moe``) and sliding-window ring
cache against the reference's (``repro.models``) on the CPU, at smoke size
(qwen3-moe-30b-a3b: 4 experts top-2; mixtral-8x22b: 4 experts top-2,
window 16), with the reference's own initialised weights carried over by
``convert.lm_params_to_torch``:

* ``moe_block`` over n_groups in {1, 2} and capacity factors 1.25 and 0.25
  (the second drops pairs): the routed experts ``eidx`` and the dispatch
  slots EXACTLY equal, the output and both aux losses within 1e-5 in f32;
* the capture-safe dispatch (trash row in place of ``mode="drop"``, counts
  by ``scatter_add_``) against a plain per-pair scatter on the same inputs:
  buffer and slots exactly equal;
* ``lm_forward`` and ``loss`` (aux losses averaged over the layers, added
  with the reference's coefficients) on qwen3 and mixtral smoke, logits in
  f32 within 1e-4 (the dense models' tolerance in test_torch_models.py);
  mixtral's windowed ``attn_train`` past the window;
* mixtral's ``decode_step`` on a ring of 16 slots over positions 0..27,
  past the window, logits within 1e-4 of the reference's ring and ``kpos``
  equal; per-slot positions on a ring raise, as the reference's;
* ``convert`` on the ``moe`` subtree and the port's own init (shapes,
  dtypes, a router in f32);
* the "step" plan kind accepts every MoE config, the "serve" kind refuses
  mixtral's window; the probe CLI's ``--arch`` routes for the MoE family
  classify and replay with 0 measured under the synthetic clock.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as rmoe
from repro.models import transformer as rtf
from repro.models.model import build as ref_build
from repro_torch import configs
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.model import build

MOE_ARCHS = ("qwen3_moe_30b_a3b", "mixtral_8x22b")
TOL = dict(atol=1e-4, rtol=1e-4)        # whole models, f32
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)  # one MoE block, f32


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    """(reference cfg, params) and (port cfg, params), the same weights."""
    rcfg = _f32(ref_configs.get_smoke_config(request.param))
    cfg = _f32(configs.get_smoke_config(request.param))
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    params = lm_params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    return rcfg, rparams, cfg, params


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _block_inputs(cfg, seed=0, B=2, S=24):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    w = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return w, x


def _torch_moe(w):
    return moe.MoE(*(torch.from_numpy(w[k])
                     for k in ("router", "w_gate", "w_up", "w_down")))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25],
                         ids=["cf1.25", "cf0.25-drops"])
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_the_reference(arch, n_groups, capacity_factor):
    cfg = _f32(configs.get_smoke_config(arch),
               capacity_factor=capacity_factor)
    rcfg = _f32(ref_configs.get_smoke_config(arch),
                capacity_factor=capacity_factor)
    w, x = _block_inputs(cfg)
    rw = {k: jnp.asarray(v) for k, v in w.items()}
    B, S, D = x.shape
    T, k = B * S, cfg.top_k
    G = n_groups
    C = moe._capacity(T // G, cfg)
    assert C == rmoe._capacity(T // G, rcfg)

    # the routing: eidx exactly the reference's
    rprobs = jax.nn.softmax(jnp.asarray(x.reshape(T, D)) @ rw["router"], -1)
    _, reidx = jax.lax.top_k(rprobs, k)
    logits = torch.from_numpy(x.reshape(T, D)) @ torch.from_numpy(
        w["router"])
    _, eidx = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(reidx))

    # the dispatch: slots exactly, the buffer within tolerance
    eg = np.array(reidx).reshape(G, T // G, k)
    xg = x.reshape(G, T // G, D)
    rbuf, rslots = jax.vmap(lambda a, b: rmoe._group_dispatch(
        a, b, rcfg, C))(jnp.asarray(xg), jnp.asarray(eg))
    buf, slots = moe._group_dispatch(torch.from_numpy(xg),
                                     torch.from_numpy(eg), cfg.n_experts, C)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(rslots))
    _close(buf, rbuf, **BLOCK_TOL)
    if capacity_factor < 1:
        assert int((slots >= C).sum()) > 0

    # the block: output and both aux losses
    want, raux = rmoe.moe_block(rw, rcfg, jnp.asarray(x), n_groups=n_groups)
    got, aux = moe.moe_block(_torch_moe(w), cfg, torch.from_numpy(x),
                             n_groups=n_groups)
    _close(got, want, **BLOCK_TOL)
    assert aux.keys() == raux.keys()
    for name in aux:
        _close(aux[name], raux[name], **BLOCK_TOL)


def _plain_dispatch(xg, eg, n_experts, capacity):
    """jnp's ``.at[e, slot].set(x, mode="drop")`` one pair at a time, in
    the stable order of the pairs sorted by expert."""
    G, Tg, k = eg.shape
    buf = np.zeros((G, n_experts, capacity, xg.shape[-1]), xg.dtype)
    slots = np.zeros((G, Tg, k), np.int64)
    for g in range(G):
        fill = [0] * n_experts
        pairs = sorted(((int(eg[g, t, j]), t * k + j) for t in range(Tg)
                        for j in range(k)), key=lambda p: p[0])
        for e, flat in pairs:
            t, j = divmod(flat, k)
            slots[g, t, j] = fill[e]
            if fill[e] < capacity:
                buf[g, e, fill[e]] = xg[g, t]
            fill[e] += 1
    return buf, slots


@pytest.mark.parametrize("capacity", [8, 16])
def test_capture_safe_dispatch_equals_a_plain_scatter(capacity):
    rng = np.random.default_rng(3)
    G, Tg, k, E, D = 2, 40, 2, 4, 6
    xg = rng.standard_normal((G, Tg, D)).astype(np.float32)
    # skewed routing: expert 0 takes most pairs, so it overflows
    eg = np.stack([rng.choice(E, size=k, replace=False,
                              p=[0.55, 0.15, 0.15, 0.15])
                   for _ in range(G * Tg)]).reshape(G, Tg, k)
    want_buf, want_slots = _plain_dispatch(xg, eg, E, capacity)
    buf, slots = moe._group_dispatch(torch.from_numpy(xg),
                                     torch.from_numpy(eg), E, capacity)
    assert buf.shape == (G, E, capacity, D)
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    np.testing.assert_array_equal(buf.numpy(), want_buf)
    assert (want_slots >= capacity).any()


def test_combine_weighs_dropped_pairs_zero():
    G, E, C, D = 1, 2, 8, 3
    out = torch.arange(G * E * C * D, dtype=torch.float32).reshape(
        G, E, C, D)
    eg = torch.tensor([[[0, 1], [1, 0]]])
    slots = torch.tensor([[[0, 8], [3, 1]]])            # (t0, j1) dropped
    gates = torch.tensor([[[0.75, 0.25], [0.5, 0.5]]])
    y = moe._group_combine(out, eg, slots, gates, C)
    torch.testing.assert_close(y[0, 0], 0.75 * out[0, 0, 0])
    torch.testing.assert_close(y[0, 1], 0.5 * out[0, 1, 3]
                               + 0.5 * out[0, 0, 1])


def test_router_stays_ieee_f32(monkeypatch):
    """The block's router product runs at "highest" f32 precision whatever
    the caller set (a TF32 router moves the routing), and restores it."""
    cfg = _f32(configs.get_smoke_config("qwen3_moe_30b_a3b"))
    w, x = _block_inputs(cfg, seed=4)
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return real(a, b)

    prev = torch.get_float32_matmul_precision()
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    torch.set_float32_matmul_precision("high")
    try:
        moe.moe_block(_torch_moe(w), cfg, torch.from_numpy(x))
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen[0] == "highest" and after == "high"


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_lm_forward_logits_and_aux(pair):
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, (2, 24))            # past mixtral's window of 16
    want, raux = rtf.lm_forward(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tf.lm_forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, cfg.vocab_size)
    _close(got, want)
    assert set(aux) == set(raux) == {"moe_lb_loss", "moe_z_loss"}
    for name in aux:
        _close(aux[name], raux[name], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_loss_adds_the_aux_losses(pair, n_groups):
    rcfg, rparams, cfg, params = pair
    toks, labels = _tokens(cfg, (2, 16), 1), _tokens(cfg, (2, 16), 2)
    want, raux = ref_build(rcfg).loss(
        rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        n_groups=n_groups)
    got, aux = build(cfg).loss(
        params, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)}, n_groups=n_groups)
    _close(got, want)
    _close(aux["nll"], raux["nll"])
    expect = (aux["nll"] + cfg.router_aux_coef * aux["moe_lb_loss"]
              + 1e-3 * aux["moe_z_loss"])
    torch.testing.assert_close(got, expect)


def test_windowed_attn_train_past_the_window():
    from repro.models import attention as rattn
    from repro_torch.models import attention as attn

    rcfg = _f32(ref_configs.get_smoke_config("mixtral_8x22b"))
    cfg = _f32(configs.get_smoke_config("mixtral_8x22b"))
    assert cfg.window == 16
    rp = rattn.init_attention(jax.random.PRNGKey(1), rcfg)
    p = attn.Attention(*(torch.from_numpy(np.array(rp[w]))
                         for w in ("wq", "wk", "wv", "wo")))
    x = np.random.default_rng(5).standard_normal((2, 40, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    want = rattn.attn_train(rp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                            window=cfg.window)
    got = attn.attn_train(p, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                          window=cfg.window)
    _close(got, want)
    full = attn.attn_train(p, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos), window=0)
    assert not torch.allclose(full[:, 16:], got[:, 16:], atol=1e-3)
    torch.testing.assert_close(full[:, :16], got[:, :16])


def test_mixtral_ring_decode_past_the_window():
    """A ring of 16 slots (max_seq 32, window 16), decoded from empty
    over positions 0..27: each step's logits against the reference's ring,
    and the slots' stored positions."""
    rcfg = _f32(ref_configs.get_smoke_config("mixtral_8x22b"))
    cfg = _f32(configs.get_smoke_config("mixtral_8x22b"))
    rapi, api = ref_build(rcfg), build(cfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    params = lm_params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    B = 2
    rcache = rapi.decode_init(rparams, {"tokens": jnp.zeros((B, 1)),
                                        "max_seq": 32})
    cache = api.decode_init(params, {"tokens": torch.zeros((B, 1)),
                                     "max_seq": 32})
    assert tuple(cache["kv"]["k"].shape) == tuple(rcache["kv"]["k"].shape) \
        == (cfg.n_layers, B, cfg.n_kv_heads, 16, cfg.head_dim)
    assert (cache["kv"]["kpos"] == -1).all()
    cur = _tokens(cfg, (B, 1), 6)
    for pos in range(28):
        want, rcache = rapi.decode_step(rparams, rcache, jnp.asarray(cur),
                                        jnp.int32(pos))
        got, cache = api.decode_step(params, cache, torch.from_numpy(cur),
                                     torch.tensor(pos, dtype=torch.int32))
        _close(got, want)
        cur = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
    np.testing.assert_array_equal(cache["kv"]["kpos"].numpy(),
                                  np.asarray(rcache["kv"]["kpos"]))
    _close(cache["kv"]["v"], rcache["kv"]["v"])
    assert sorted(cache["kv"]["kpos"][0].tolist()) == list(range(12, 28))


def test_ring_decode_is_idempotent_and_refuses_per_slot_positions():
    cfg = _f32(configs.get_smoke_config("mixtral_8x22b"))
    api = build(cfg)
    params = api.init(0, "cpu")
    cache = api.decode_init(params, {"tokens": torch.zeros((2, 1)),
                                     "max_seq": 64})
    toks = torch.ones((2, 1), dtype=torch.int32)
    pos = torch.tensor(20, dtype=torch.int32)
    a, _ = api.decode_step(params, cache, toks, pos)
    snap = {k: v.clone() for k, v in cache["kv"].items()}
    b, _ = api.decode_step(params, cache, toks, pos)
    assert torch.equal(a, b)
    assert all(torch.equal(snap[k], cache["kv"][k]) for k in snap)
    assert int(cache["kv"]["kpos"][0, 20 % 16]) == 20
    with pytest.raises(NotImplementedError, match="per-slot positions"):
        api.decode_step(params, cache, toks,
                        torch.tensor([20, 21], dtype=torch.int32))


def test_full_cache_decode_masks_the_window_as_the_reference():
    """lm_prefill pads a windowed config's KV to max_seq (no ring); its
    decode masks positions outside the window, as the reference's does."""
    rcfg = _f32(ref_configs.get_smoke_config("mixtral_8x22b"))
    cfg = _f32(configs.get_smoke_config("mixtral_8x22b"))
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    params = lm_params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    toks = _tokens(cfg, (2, 20), 7)
    _, rcache = rtf.lm_prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                               32)
    _, cache = tf.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                             32)
    cur = toks[:, -1:]
    for step, per_slot in enumerate((False, True, False)):
        pos = np.int32(20 + step)
        if per_slot:
            pos = np.full((2,), pos, np.int32)
        want, rcache = rtf.lm_decode_step(rparams, rcfg, rcache,
                                          jnp.asarray(cur), jnp.asarray(pos))
        got, cache = tf.lm_decode_step(params, cfg, cache,
                                       torch.from_numpy(cur),
                                       torch.tensor(pos))
        _close(got, want)
        cur = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]


# ---------------------------------------------------------------------------
# weights: convert and init
# ---------------------------------------------------------------------------

def test_convert_carries_the_moe_subtree(pair):
    rcfg, rparams, cfg, params = pair
    rm = rparams["layers"]["moe"]
    assert np.asarray(rm["w_gate"]).shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    for i, layer in enumerate(params.layers):
        assert not hasattr(layer, "mlp")
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                getattr(layer.moe, name).numpy(), np.asarray(rm[name])[i])


def test_init_draws_the_reference_moe_shapes():
    cfg = configs.get_smoke_config("qwen3_moe_30b_a3b")
    rparams = ref_build(ref_configs.get_smoke_config(
        "qwen3_moe_30b_a3b")).init(jax.random.PRNGKey(0))
    conv = lm_params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    api = build(cfg)
    p = api.init(0, "cpu")
    mine, theirs = dict(p.named_parameters()), dict(conv.named_parameters())
    assert mine.keys() == theirs.keys()
    for name, t in mine.items():
        assert t.shape == theirs[name].shape and t.dtype == theirs[name].dtype
    assert p.layers[0].moe.router.dtype == torch.float32
    assert p.layers[0].moe.w_up.dtype == torch.bfloat16
    d = cfg.d_model
    std = float(p.layers[1].moe.w_gate.float().std())
    assert abs(std - d ** -0.5) < 0.1 * d ** -0.5
    assert torch.equal(api.init(0, "cpu").layers[1].moe.w_down,
                       p.layers[1].moe.w_down)


# ---------------------------------------------------------------------------
# the plan kinds and the probe CLI's routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mixtral_8x22b",
                                  "llava_next_34b"])
def test_step_targets_accept_the_moe_and_vlm_families(arch):
    from repro_torch.fleet.plan import TargetSpec

    TargetSpec("step", ("fp_add32",), {"arch": arch}).validate()


def test_plan_refusals_for_windows_and_the_next_families():
    from repro_torch.fleet.plan import PlanError, TargetSpec

    TargetSpec("serve", ("fp_add32",), {"arch": "qwen3_moe_30b_a3b"}) \
        .validate()
    with pytest.raises(PlanError, match="sliding-window.*ROADMAP queue 3"):
        TargetSpec("serve", ("fp_add32",),
                   {"arch": "mixtral_8x22b"}).validate()
    for arch in ("mamba2_780m", "zamba2_1p2b", "whisper_large_v3"):
        TargetSpec("step", ("fp_add32",), {"arch": arch}).validate()
    for arch in ("mamba2_780m", "zamba2_1p2b"):
        TargetSpec("step", ("fp_add32",),
                   {"arch": arch, "kind": "decode"}).validate()
    with pytest.raises(PlanError, match="KeyError: 'frames'"):
        TargetSpec("step", ("fp_add32",),
                   {"arch": "whisper_large_v3", "kind": "decode"}).validate()


@pytest.mark.parametrize("argv,names", [
    (["--arch", "mixtral-8x22b", "--kind", "decode"],
     ["mixtral-8x22b-smoke_decode_s32_b2"]),
    (["--arch", "qwen3-moe-30b-a3b", "--kind", "train"],
     ["qwen3-moe-30b-a3b-smoke_train_s32_b2"]),
    (["--serve", "--arch", "qwen3-moe-30b-a3b", "--max-new", "4"],
     ["qwen3-moe-30b-a3b-smoke_serve_prefill_s32_n4_p16_b2",
      "qwen3-moe-30b-a3b-smoke_serve_decode_s32_n4_p16_b2"]),
], ids=["mixtral-decode", "qwen3-train", "qwen3-serve"])
def test_probe_cli_moe_routes_classify_and_replay(tmp_path, monkeypatch,
                                                   argv, names):
    from repro_torch.launch.probe import main

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    argv = argv + ["--seq", "32", "--batch", "2", "--modes",
                   "fp_add32,hbm_stream", "--reps", "1", "--device", "cpu",
                   "--store", str(tmp_path / "p.jsonl")]
    reports, stats = main(argv)
    assert sorted(reports) == sorted(names) and stats.measured > 0
    _, again = main(argv + ["--expect-no-measure"])
    assert again.measured == 0


def test_probe_cli_refuses_to_serve_mixtral(tmp_path):
    from repro_torch.launch.probe import main

    with pytest.raises(SystemExit, match="sliding-window.*ROADMAP queue 3"):
        main(["--serve", "--arch", "mixtral-8x22b", "--device", "cpu",
              "--store", str(tmp_path / "m.jsonl")])


def test_step_region_names_equal_the_reference():
    from repro.launch.probe import build_step_region as ref_step_region
    from repro_torch.launch.probe import build_step_region

    for arch, kind in (("mixtral_8x22b", "decode"),
                       ("qwen3_moe_30b_a3b", "train")):
        region = build_step_region(arch, kind, ["fp_add32"], seq=16,
                                   batch=2, device="cpu")
        assert region.name == ref_step_region(arch, kind, ["fp_add32"],
                                              seq=16, batch=2).name
