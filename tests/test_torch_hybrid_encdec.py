"""The port's zamba2 hybrid (``repro_torch.models.hybrid``), whisper's
encoder-decoder (``repro_torch.models.encdec``) and cross-attention
(``models/attention.py``) against the reference's on the CPU, at smoke
size, with the reference's own initialised weights carried over by
``convert.params_to_torch``:

* zamba2 smoke ``forward`` and 8 decode steps, and at 5 layers with the
  shared block every 2 (invocations at layers 0, 2, 4) the stacked KV cache
  slice by slice; a decode step run twice on one cache;
* ``cross_kv`` and ``attn_cross`` (MHA and GQA);
* whisper smoke ``encode``, ``encdec_forward`` and its loss,
  ``encdec_decode_init`` with frames, 8 decode steps; the encoder at 1,500
  frames (q blocks of 750); ``input_specs`` with ``frames``.

Tolerance: f32, atol = rtol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShape
from repro.models import attention as rattn
from repro.models import encdec as rencdec
from repro.models.model import build as ref_build
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_to_torch
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models import hybrid
from repro_torch.models.model import build

TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _pair(arch, **kw):
    rcfg = _f32(ref_configs.get_smoke_config(arch), **kw)
    cfg = _f32(configs.get_smoke_config(arch), **kw)
    rapi, api = ref_build(rcfg), build(cfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    params = params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    return rapi, rparams, api, params


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=shape).astype(np.int32)


def _frames(cfg, B, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def zamba():
    return _pair("zamba2_1p2b")


@pytest.fixture(scope="module")
def whisper():
    return _pair("whisper_large_v3")


# ---------------------------------------------------------------------------
# zamba2
# ---------------------------------------------------------------------------

def test_hybrid_forward_matches_the_reference(zamba):
    rapi, rparams, api, params = zamba
    toks = _tokens(api.cfg, (2, 64))
    want, _ = rapi.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(params, {"tokens": torch.from_numpy(toks)})
    assert aux == {}
    _close(got, want)


def _decode_both(rapi, rparams, api, params, toks, max_seq):
    """Decode ``toks`` (B, T) one position at a time in both packages;
    yields (i, got, want, port cache, reference cache) a step."""
    B = toks.shape[0]
    rc = rapi.decode_init(rparams, {"tokens": jnp.zeros((B, 1), jnp.int32),
                                    "max_seq": max_seq})
    c = api.decode_init(params, {"tokens": torch.zeros((B, 1)),
                                 "max_seq": max_seq})
    for i in range(toks.shape[1]):
        want, rc = rapi.decode_step(rparams, rc,
                                    jnp.asarray(toks[:, i:i + 1]),
                                    jnp.int32(i))
        got, c = api.decode_step(params, c, torch.from_numpy(toks[:, i:i + 1]),
                                 torch.tensor(i, dtype=torch.int32))
        yield i, got, want, c, rc


def test_hybrid_eight_decode_steps_match_the_reference(zamba):
    rapi, rparams, api, params = zamba
    toks = _tokens(api.cfg, (2, 8), seed=2)
    for _, got, want, c, rc in _decode_both(rapi, rparams, api, params,
                                            toks, 16):
        _close(got, want)
    _close(c["ssm"]["state"], rc["ssm"]["state"])
    _close(c["kv"]["k"], rc["kv"]["k"])


def test_hybrid_stacked_kv_per_invocation():
    """5 layers, the shared block every 2: three invocations (layers 0, 2,
    4), each writing its own slice of the (3, B, Kh, S, hd) stack; every
    slice and the logits equal the reference's."""
    rapi, rparams, api, params = _pair("zamba2_1p2b", n_layers=5)
    assert hybrid.n_invocations(api.cfg) == 3
    toks = _tokens(api.cfg, (2, 6), seed=3)
    for i, got, want, c, rc in _decode_both(rapi, rparams, api, params,
                                            toks, 8):
        _close(got, want)
    assert c["kv"]["k"].shape == (3, 2, api.cfg.n_kv_heads, 8,
                                  api.cfg.head_dim)
    for inv in range(3):
        _close(c["kv"]["k"][inv], rc["kv"]["k"][inv])
        _close(c["kv"]["v"][inv], rc["kv"]["v"][inv])
        assert c["kv"]["k"][inv, :, :, :6].abs().sum() > 0
        assert c["kv"]["k"][inv, :, :, 6:].abs().sum() == 0
    assert not torch.equal(c["kv"]["k"][0], c["kv"]["k"][1])


def test_hybrid_decode_step_twice_on_one_cache_is_equal(zamba):
    """The KV is written in place at ``pos`` (a replay writes the same
    values), the Mamba states come back as new tensors: a replay on the
    same arguments gives the same logits."""
    _, _, api, params = zamba
    c = api.decode_init(params, {"tokens": torch.zeros((2, 1)),
                                 "max_seq": 8})
    tok = torch.from_numpy(_tokens(api.cfg, (2, 1), seed=4))
    _, c = api.decode_step(params, c, tok, torch.tensor(0,
                                                         dtype=torch.int32))
    state = c["ssm"]["state"].clone()
    pos = torch.tensor(1, dtype=torch.int32)
    a, ca = api.decode_step(params, c, tok, pos)
    b, cb = api.decode_step(params, c, tok, pos)
    assert torch.equal(a, b)
    assert torch.equal(ca["ssm"]["state"], cb["ssm"]["state"])
    assert torch.equal(c["ssm"]["state"], state)


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_heads", [4, 2])
def test_cross_kv_and_attn_cross_match_the_reference(kv_heads):
    cfg = _f32(configs.get_smoke_config("whisper_large_v3"),
               n_kv_heads=kv_heads)
    rcfg = _f32(ref_configs.get_smoke_config("whisper_large_v3"),
                n_kv_heads=kv_heads)
    rp = rattn.init_cross_attention(jax.random.PRNGKey(5), rcfg)
    p = attn.Attention(*(torch.from_numpy(np.array(rp[w]))
                         for w in ("wq", "wk", "wv", "wo")))
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    rkv = rattn.cross_kv(rp, rcfg, jnp.asarray(enc))
    kv = attn.cross_kv(p, cfg, torch.from_numpy(enc))
    assert kv["ck"].shape == (2, kv_heads, 24, cfg.head_dim)
    _close(kv["ck"], rkv["ck"])
    _close(kv["cv"], rkv["cv"])
    _close(attn.attn_cross(p, cfg, torch.from_numpy(x), kv),
           rattn.attn_cross(rp, rcfg, jnp.asarray(x), rkv))


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------

def test_encode_matches_the_reference(whisper):
    rapi, rparams, api, params = whisper
    frames = _frames(api.cfg, 2)
    _close(encdec.encode(params, api.cfg, torch.from_numpy(frames)),
           rencdec.encode(rparams, rapi.cfg, jnp.asarray(frames)))


def test_encdec_forward_and_loss_match_the_reference(whisper):
    rapi, rparams, api, params = whisper
    toks = _tokens(api.cfg, (2, 12))
    labels = _tokens(api.cfg, (2, 12), seed=7)
    frames = _frames(api.cfg, 2)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "frames": jnp.asarray(frames)}
    b = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
         "frames": torch.from_numpy(frames)}
    want, _ = rapi.forward(rparams, rb)
    got, aux = api.forward(params, b)
    assert aux == {}
    _close(got, want)
    _close(api.loss(params, b)[0], rapi.loss(rparams, rb)[0])


def test_encdec_decode_init_with_frames(whisper):
    rapi, rparams, api, params = whisper
    frames = _frames(api.cfg, 2)
    rc = rapi.decode_init(rparams, {"frames": jnp.asarray(frames),
                                    "max_seq": 16})
    c = api.decode_init(params, {"frames": torch.from_numpy(frames),
                                 "max_seq": 16})
    cfg = api.cfg
    assert c["cross"]["ck"].shape == (cfg.n_layers, 2, cfg.n_kv_heads,
                                      cfg.enc_frames, cfg.head_dim)
    assert c["kv"]["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, 16,
                                  cfg.head_dim)
    for name in ("ck", "cv"):
        _close(c["cross"][name], rc["cross"][name])
    with pytest.raises(KeyError, match="frames"):
        api.decode_init(params, {"tokens": torch.zeros((2, 1)),
                                 "max_seq": 16})


def test_encdec_eight_decode_steps_match_the_reference(whisper):
    rapi, rparams, api, params = whisper
    frames = _frames(api.cfg, 2, seed=8)
    toks = _tokens(api.cfg, (2, 8), seed=9)
    rc = rapi.decode_init(rparams, {"frames": jnp.asarray(frames),
                                    "max_seq": 16})
    c = api.decode_init(params, {"frames": torch.from_numpy(frames),
                                 "max_seq": 16})
    steps = []
    for i in range(8):
        want, rc = rapi.decode_step(rparams, rc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.int32(i))
        got, c = api.decode_step(params, c, torch.from_numpy(toks[:, i:i + 1]),
                                 torch.tensor(i, dtype=torch.int32))
        _close(got, want)
        steps.append(got[:, 0])
    full, _ = api.forward(params, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(frames)})
    _close(torch.stack(steps, 1), full)


def test_encoder_at_1500_frames_matches_the_reference():
    """Whisper's frame count at a tiny width: the blocked attention takes
    q blocks of 750, the largest divisor of 1500 up to 1024, as the
    reference's."""
    kw = dict(d_model=16, n_heads=2, n_kv_heads=2, head_dim=8, d_ff=32,
              enc_layers=1, n_layers=1, enc_frames=1500)
    rapi, rparams, api, params = _pair("whisper_large_v3", **kw)
    frames = _frames(api.cfg, 1, seed=10)
    seen = []
    softmax_attend = attn._softmax_attend

    def spy(q, k, v, keep, out_dtype):
        seen.append(q.shape[2])
        return softmax_attend(q, k, v, keep, out_dtype)

    attn._softmax_attend = spy
    try:
        got = encdec.encode(params, api.cfg, torch.from_numpy(frames))
    finally:
        attn._softmax_attend = softmax_attend
    assert seen == [750, 750]
    _close(got, rencdec.encode(rparams, rapi.cfg, jnp.asarray(frames)))


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_input_specs_with_frames(kind):
    cfg = configs.get_smoke_config("whisper_large_v3")
    api = build(cfg)
    rapi = ref_build(ref_configs.get_smoke_config("whisper_large_v3"))
    specs = api.input_specs(ShapeConfig("s", kind, 32, 2))
    rspecs = rapi.input_specs(RefShape("s", kind, 32, 2))
    assert sorted(specs) == sorted(rspecs)
    for name, spec in specs.items():
        assert spec.shape == rspecs[name].shape
        assert str(spec.dtype).split(".")[-1] == str(rspecs[name].dtype)
    if kind == "train":
        assert specs["frames"].shape == (2, cfg.enc_frames, cfg.d_model)
        batch = api.dummy_batch(ShapeConfig("s", kind, 32, 2))
        assert batch["frames"].dtype == torch.bfloat16
        loss, _ = api.loss(api.init(0, "cpu"), batch)
        assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the probe's routes for the three families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,name", [
    (["--arch", "mamba2-780m", "--kind", "decode"],
     "mamba2-780m-smoke_decode_s32_b2"),
    (["--arch", "mamba2-780m"], "mamba2-780m-smoke_train_s32_b2"),
    (["--arch", "zamba2-1.2b", "--kind", "decode"],
     "zamba2-1.2b-smoke_decode_s32_b2"),
    (["--arch", "zamba2-1.2b"], "zamba2-1.2b-smoke_train_s32_b2"),
    (["--arch", "whisper-large-v3"], "whisper-large-v3-smoke_train_s32_b2"),
], ids=["mamba2-decode", "mamba2-train", "zamba2-decode", "zamba2-train",
        "whisper-train"])
def test_probe_cli_routes_classify_and_replay(tmp_path, monkeypatch, argv,
                                              name):
    from repro_torch.launch.probe import main

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    argv = argv + ["--seq", "32", "--batch", "2", "--modes",
                   "fp_add32,hbm_stream", "--reps", "1", "--device", "cpu",
                   "--store", str(tmp_path / "p.jsonl")]
    reports, stats = main(argv)
    assert sorted(reports) == [name] and stats.measured > 0
    _, again = main(argv + ["--expect-no-measure"])
    assert again.measured == 0


@pytest.mark.parametrize("argv,match", [
    (["--serve", "--arch", "mamba2-780m"], "paged serving needs an "
     "attention KV cache without a sliding window \\(family='ssm'"),
    (["--serve", "--arch", "zamba2-1.2b"], "family='hybrid'"),
    (["--serve", "--arch", "whisper-large-v3"], "family='encdec'"),
    (["--arch", "whisper-large-v3", "--kind", "decode"],
     "KeyError: 'frames'.*ROADMAP queue 3"),
], ids=["mamba2-serve", "zamba2-serve", "whisper-serve", "whisper-decode"])
def test_probe_cli_refuses_what_the_reference_fails(tmp_path, argv, match):
    """Refused at plan time with the reference's fault named: a SystemExit
    with the message (the CLI prints it, no traceback) and no store."""
    from repro_torch.launch.probe import main

    store = tmp_path / "r.jsonl"
    with pytest.raises(SystemExit, match=match):
        main(argv + ["--device", "cpu", "--store", str(store)])
    assert not store.exists()


@pytest.mark.parametrize("arch,kind", [("mamba2_780m", "decode"),
                                       ("zamba2_1p2b", "decode"),
                                       ("whisper_large_v3", "train")])
def test_step_region_names_equal_the_reference(arch, kind):
    from repro.launch.probe import build_step_region as ref_step_region
    from repro_torch.launch.probe import build_step_region

    region = build_step_region(arch, kind, ["fp_add32"], seq=16, batch=2,
                               device="cpu")
    assert region.name == ref_step_region(arch, kind, ["fp_add32"], seq=16,
                                          batch=2).name


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1p2b"])
def test_decode_step_region_keeps_semantics(arch):
    """Noise beside the decode step leaves its logits bitwise equal to the
    clean step's, on the same (reused) cache: the SSM state is out of
    place, so a rerun does not move it on."""
    from repro_torch.core.injector import step_modes, verify_semantics
    from repro_torch.launch.probe import build_step_region

    region = build_step_region(arch, "decode", ["fp_add32"], seq=16,
                               batch=2, device="cpu")
    clean = region.build("", 0)
    args = region.args_for("", 0)
    first = clean(*args).clone()
    assert torch.equal(clean(*args), first)
    assert verify_semantics(clean, args, step_modes("cpu")["fp_add32"], k=4)
    assert region.payload_check("fp_add32", 4).payload == 4
