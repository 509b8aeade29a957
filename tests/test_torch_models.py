"""The port's dense models (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU, at smoke size, with the reference's own
initialised weights carried over by ``convert.lm_params_to_torch``:

* the configs: every architecture and its smoke reduction field for field;
* the layers (rmsnorm, rope by halves, tied / untied embed and unembed with
  softcap, GeGLU with jax.nn.gelu's tanh approximation, SwiGLU, masked
  cross-entropy) on the same numpy inputs;
* ``lm_forward`` logits, the loss, ``lm_decode_step`` (scalar and per-slot
  positions) after ``lm_prefill``, and a paged prefill plus four paged
  decode steps, on gemma_2b smoke (MQA, GeGLU, tied) and
  deepseek_coder_33b smoke (GQA, SwiGLU, θ = 1e5).

Tolerance: f32 throughout, atol = rtol = 1e-4 (the two packages sum the
same products in other orders; measured differences are ~1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import transformer as rtf
from repro.models.model import build as ref_build
from repro_torch import configs
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.models.model import build

ARCHS = ("gemma_2b", "deepseek_coder_33b")
TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, params) and (port cfg, params), the same weights."""
    rcfg = _f32(ref_configs.get_smoke_config(request.param))
    cfg = _f32(configs.get_smoke_config(request.param))
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    params = lm_params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    return rcfg, rparams, cfg, params


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_match_the_reference(arch):
    assert configs.ARCHS == ref_configs.ARCHS
    assert (dataclasses.asdict(configs.get_config(arch))
            == dataclasses.asdict(ref_configs.get_config(arch)))
    assert (dataclasses.asdict(configs.get_smoke_config(arch))
            == dataclasses.asdict(ref_configs.get_smoke_config(arch)))
    cfg = configs.get_config(arch)
    assert cfg.param_count() == ref_configs.get_config(arch).param_count()
    assert (cfg.q_dim, cfg.kv_dim) == (cfg.n_heads * cfg.head_dim,
                                       cfg.n_kv_heads * cfg.head_dim)


@pytest.mark.parametrize("name", ["gemma-2b", "zamba2-1.2b", "Gemma_2B",
                                  "deepseek-coder-33b"])
def test_canonical_names(name):
    assert configs.canonical(name) == ref_configs.canonical(name)
    with pytest.raises(KeyError, match="unknown architecture"):
        configs.canonical("gpt-17")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = L.rmsnorm(L.RMSNorm(torch.from_numpy(scale)), torch.from_numpy(x),
                    1e-5)
    _close(got, want)


@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_by_halves(per_slot):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1 if per_slot else 7, 4, 16)).astype(
        np.float32)
    pos = (np.array([[5], [9], [130]], np.int32) if per_slot
           else np.arange(7, dtype=np.int32))
    rc, rs = RL.rope_angles(jnp.asarray(pos), 16, 1e5)
    c, s = L.rope_angles(torch.from_numpy(pos), 16, 1e5)
    _close(c, rc)
    _close(s, rs)
    _close(L.apply_rope(torch.from_numpy(x), c, s),
           RL.apply_rope(jnp.asarray(x), rc, rs))


@pytest.mark.parametrize("tied,softcap", [(True, 0.0), (False, 0.0),
                                          (True, 30.0)])
def test_embed_unembed(tied, softcap):
    cfg = dataclasses.replace(_f32(configs.get_smoke_config("gemma_2b")),
                              tie_embeddings=tied, logit_softcap=softcap)
    rng = np.random.default_rng(2)
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    head = rng.standard_normal((cfg.d_model, cfg.vocab_size)).astype(
        np.float32)
    rp = {"table": jnp.asarray(table)}
    p = L.Embedding(torch.from_numpy(table),
                    None if tied else torch.from_numpy(head))
    if not tied:
        rp["head"] = jnp.asarray(head)
    toks = _tokens(cfg, (2, 6))
    h = RL.embed(rp, jnp.asarray(toks), cfg)
    _close(L.embed(p, torch.from_numpy(toks), cfg), h)
    _close(L.unembed(p, torch.from_numpy(np.array(h)), cfg),
           RL.unembed(rp, h, cfg))


@pytest.mark.parametrize("act", ["geglu", "swiglu"])
def test_gated_mlp(act):
    cfg = dataclasses.replace(_f32(configs.get_smoke_config("gemma_2b")),
                              act=act)
    rng = np.random.default_rng(3)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                      ("w_down", (128, 64)))}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = RL.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                  cfg)
    got = L.mlp(L.MLP(*(torch.from_numpy(w[k])
                        for k in ("w_gate", "w_up", "w_down"))),
                torch.from_numpy(x), cfg)
    _close(got, want)


def test_geglu_is_the_tanh_gelu():
    """jax.nn.gelu defaults to the tanh approximation; the port must too
    (torch's default is the erf form, ~1e-3 away at |x| ~ 2)."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = L._act("geglu", torch.from_numpy(x))
    _close(got, jax.nn.gelu(jnp.asarray(x)), atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((erf - got).abs().max()) > 1e-4


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    labels = rng.integers(0, 32, size=(2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32) if masked else None
    want = RL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    _close(got, want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_lm_forward_logits(pair):
    rcfg, rparams, cfg, params = pair
    toks = _tokens(cfg, (2, 12))
    want, _ = rtf.lm_forward(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tf.lm_forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert aux == {} and got.shape == (2, 12, cfg.vocab_size)
    _close(got, want)


def test_loss_matches(pair):
    rcfg, rparams, cfg, params = pair
    toks, labels = _tokens(cfg, (2, 8), 1), _tokens(cfg, (2, 8), 2)
    want, _ = ref_build(rcfg).loss(rparams, {"tokens": jnp.asarray(toks),
                                             "labels": jnp.asarray(labels)})
    got, aux = build(cfg).loss(params, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
    _close(got, want)
    assert float(aux["nll"]) == float(got)


@pytest.mark.parametrize("per_slot", [False, True])
def test_lm_decode_step(pair, per_slot):
    """lm_prefill, then four decode steps (greedy on the reference's
    logits), logits and the written caches within tolerance."""
    rcfg, rparams, cfg, params = pair
    B, sp, max_seq = 2, 8, 16
    toks = _tokens(cfg, (B, sp))
    _, rcache = rtf.lm_prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                               max_seq)
    _, cache = tf.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                             max_seq)
    _close(cache["kv"]["k"], rcache["kv"]["k"])
    cur = toks[:, -1:]
    for step in range(4):
        pos = (np.full((B,), sp + step, np.int32) if per_slot
               else np.int32(sp + step))
        want, rcache = rtf.lm_decode_step(rparams, rcfg, rcache,
                                          jnp.asarray(cur), jnp.asarray(pos))
        got, cache = tf.lm_decode_step(params, cfg, cache,
                                       torch.from_numpy(cur),
                                       torch.tensor(pos))
        _close(got, want)
        cur = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
    _close(cache["kv"]["v"], rcache["kv"]["v"])


def test_paged_prefill_and_decode(pair):
    """A paged prefill scattered into the pool, then four paged decode
    steps, against the reference's paged path on the same page table."""
    rcfg, rparams, cfg, params = pair
    B, sp, page, max_seq = 2, 8, 4, 16
    maxp = max_seq // page
    toks = _tokens(cfg, (B, sp), 5)
    table = np.arange(B * maxp, dtype=np.int32).reshape(B, maxp)[:, ::-1]
    table = np.ascontiguousarray(table)
    rows = table[:, :sp // page]
    rc = rtf.lm_paged_decode_init(rparams, rcfg, B * maxp + 1, page)
    c = tf.lm_paged_decode_init(params, cfg, B * maxp + 1, page, "cpu")
    want, rc = rtf.lm_paged_prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                                    rc, jnp.asarray(rows))
    got, c = tf.lm_paged_prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                 c, torch.from_numpy(rows))
    _close(got, want)
    _close(c["kv"]["kp"], rc["kv"]["kp"])
    pos = np.full((B,), sp, np.int32)
    cur = toks[:, -1:]
    for _ in range(4):
        want, rc = rtf.lm_paged_decode_step(rparams, rcfg, rc,
                                            jnp.asarray(cur), jnp.asarray(pos),
                                            jnp.asarray(table))
        got, c = tf.lm_paged_decode_step(params, cfg, c,
                                         torch.from_numpy(cur),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(table))
        _close(got, want)
        cur = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1
    _close(c["kv"]["vp"], rc["kv"]["vp"])


def test_decode_writes_in_place_and_is_idempotent(pair):
    """A decode step writes position pos of the cache it was given (the
    same tensors come back) and a second call on the same arguments gives
    the same logits and cache."""
    _, _, cfg, params = pair
    toks = torch.from_numpy(_tokens(cfg, (2, 8), 6))
    _, cache = tf.lm_prefill(params, cfg, {"tokens": toks}, 16)
    k_before = cache["kv"]["k"].clone()
    pos = torch.tensor([8, 8], dtype=torch.int32)
    cur = toks[:, -1:]
    a, cache2 = tf.lm_decode_step(params, cfg, cache, cur, pos)
    assert cache2 is cache
    changed = (cache["kv"]["k"] != k_before).any(dim=(0, 2, 4))  # (B, S)
    assert changed[:, 8].all() and not changed[:, :8].any() \
        and not changed[:, 9:].any()
    snap = cache["kv"]["k"].clone()
    b, _ = tf.lm_decode_step(params, cfg, cache, cur, pos)
    assert torch.equal(a, b) and torch.equal(cache["kv"]["k"], snap)


def test_init_draws_the_reference_distributions():
    """The port's own init: the reference's shapes and dtypes, norms ones,
    N(0,1)·scale weights, drawn on the requested device from the seed."""
    cfg = configs.get_smoke_config("gemma_2b")
    rparams = ref_build(ref_configs.get_smoke_config("gemma_2b")).init(
        jax.random.PRNGKey(0))
    api = build(cfg)
    p = api.init(0, "cpu")
    conv = lm_params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    mine = dict(p.named_parameters())
    theirs = dict(conv.named_parameters())
    assert mine.keys() == theirs.keys()
    for name, t in mine.items():
        assert t.shape == theirs[name].shape and t.dtype == torch.bfloat16
    assert (p.layers[1].ln2.scale == 1).all()
    d = cfg.d_model
    std = float(p.layers[0].attn.wq.float().std())
    assert abs(std - d ** -0.5) < 0.1 * d ** -0.5
    assert torch.equal(api.init(0, "cpu").embed.table, p.embed.table)
    assert not torch.equal(api.init(1, "cpu").embed.table, p.embed.table)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mamba2_780m",
                                  "zamba2_1p2b", "whisper_large_v3",
                                  "llava_next_34b"])
def test_other_families_refused(arch):
    """Every family builds now: the moe and vlm families
    (``tests/test_torch_moe.py``, ``test_torch_vlm.py``) and the ssm,
    hybrid and encdec families (``test_torch_ssm.py``,
    ``test_torch_hybrid_encdec.py``); an unknown family is refused."""
    cfg = configs.get_smoke_config(arch)
    api = build(cfg)
    assert api.cfg is cfg
    assert api.init(0, "cpu") is not None
    with pytest.raises(ValueError, match="unknown model family"):
        build(dataclasses.replace(cfg, family="rnn"))


def test_input_specs_and_dummy_batch():
    from repro_torch.configs.base import ShapeConfig

    api = build(configs.get_smoke_config("gemma_2b"))
    shape = ShapeConfig("t", "train", 16, 3)
    specs = api.input_specs(shape)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "tokens": (3, 16), "labels": (3, 16)}
    assert tuple(api.input_specs(shape, for_decode=True)["tokens"].shape) \
        == (3, 1)
    b = api.dummy_batch(shape, torch.Generator().manual_seed(3))
    again = api.dummy_batch(shape, torch.Generator().manual_seed(3))
    assert torch.equal(b["tokens"], again["tokens"])
    assert b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < api.cfg.vocab_size
