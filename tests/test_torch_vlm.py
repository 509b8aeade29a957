"""The port's VLM family (llava-next-34b: precomputed patch embeddings put in
front of the tokens) against the reference on the CPU, at smoke size (8
image tokens), with the reference's weights carried over by
``convert.lm_params_to_torch``:

* ``lm_forward`` with ``img_embeds``: logits over the image and text
  positions, f32 within 1e-4 (the dense models' tolerance);
* ``loss`` scores the text tail only, as the reference's;
* bf16 image embeds are cast to the hidden dtype; a non-VLM config ignores
  them, as the reference does;
* ``lm_prefill`` over image + text, then decode steps that continue after
  the image positions;
* ``input_specs`` / ``dummy_batch`` give the image embeds;
* the "train" step probe of llava classifies and replays with 0 measured
  under the synthetic clock.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as rtf
from repro.models.model import build as ref_build
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_to_torch
from repro_torch.models import transformer as tf
from repro_torch.models.model import build

ARCH = "llava_next_34b"
TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def pair():
    rcfg = _f32(ref_configs.get_smoke_config(ARCH))
    cfg = _f32(configs.get_smoke_config(ARCH))
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    params = lm_params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    return rcfg, rparams, cfg, params


def _batch(cfg, B=2, S=10, seed=0, img_dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, size=(B, S))
            .astype(np.int32),
            "labels": rng.integers(1, cfg.vocab_size, size=(B, S))
            .astype(np.int32),
            "img_embeds": rng.standard_normal(
                (B, cfg.n_img_tokens, cfg.d_model)).astype(img_dtype)}


def _ref(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def test_forward_puts_the_image_in_front(pair):
    rcfg, rparams, cfg, params = pair
    assert cfg.n_img_tokens == 8
    b = _batch(cfg)
    want, _ = rtf.lm_forward(rparams, rcfg, _ref(b))
    got, aux = tf.lm_forward(params, cfg, _port(b))
    assert aux == {} and got.shape == (2, 8 + 10, cfg.vocab_size)
    _close(got, want)
    text_only, _ = tf.lm_forward(params, cfg, {"tokens": _port(b)["tokens"]})
    assert not torch.allclose(text_only, got[:, 8:], atol=1e-3)


def test_loss_scores_the_text_tail(pair):
    rcfg, rparams, cfg, params = pair
    b = _batch(cfg, seed=1)
    want, raux = ref_build(rcfg).loss(rparams, _ref(b))
    got, aux = build(cfg).loss(params, _port(b))
    _close(got, want)
    assert float(aux["nll"]) == float(got)
    assert set(aux) == set(raux) == {"nll"}


def test_bf16_image_embeds_take_the_hidden_dtype(pair):
    import ml_dtypes

    rcfg, rparams, cfg, params = pair
    b = _batch(cfg, seed=2)
    b16 = np.asarray(b["img_embeds"]).astype(ml_dtypes.bfloat16)
    want, _ = rtf.lm_forward(rparams, rcfg, dict(_ref(b),
                                                 img_embeds=jnp.asarray(b16)))
    got, _ = tf.lm_forward(params, cfg, dict(
        _port(b), img_embeds=torch.from_numpy(b16.astype(np.float32))
        .to(torch.bfloat16)))
    _close(got, want)


def test_a_text_family_ignores_image_embeds():
    rcfg = _f32(ref_configs.get_smoke_config("gemma_2b"))
    cfg = _f32(configs.get_smoke_config("gemma_2b"))
    rparams = ref_build(rcfg).init(jax.random.PRNGKey(0))
    params = lm_params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    b = _batch(dataclasses.replace(cfg, n_img_tokens=4), seed=3)
    want, _ = rtf.lm_forward(rparams, rcfg, _ref(b))
    got, _ = tf.lm_forward(params, cfg, _port(b))
    assert got.shape == (2, 10, cfg.vocab_size)
    _close(got, want)


def test_prefill_with_the_image_then_decode(pair):
    rcfg, rparams, cfg, params = pair
    b = _batch(cfg, S=6, seed=4)
    del b["labels"]
    S, max_seq = 8 + 6, 32
    want, rcache = rtf.lm_prefill(rparams, rcfg, _ref(b), max_seq)
    got, cache = tf.lm_prefill(params, cfg, _port(b), max_seq)
    _close(got, want)
    _close(cache["kv"]["k"], rcache["kv"]["k"])
    cur = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
    for step in range(3):
        pos = np.full((2,), S + step, np.int32)
        want, rcache = rtf.lm_decode_step(rparams, rcfg, rcache,
                                          jnp.asarray(cur), jnp.asarray(pos))
        got, cache = tf.lm_decode_step(params, cfg, cache,
                                       torch.from_numpy(cur),
                                       torch.from_numpy(pos))
        _close(got, want)
        cur = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]


def test_input_specs_and_dummy_batch_hold_the_image():
    cfg = configs.get_smoke_config(ARCH)
    rcfg = ref_configs.get_smoke_config(ARCH)
    api = build(cfg)
    shape = ShapeConfig("t", "train", 16, 3)
    specs = api.input_specs(shape)
    ref_specs = ref_build(rcfg).input_specs(shape)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        k: tuple(v.shape) for k, v in ref_specs.items()}
    assert specs["img_embeds"].dtype == torch.bfloat16
    assert set(api.input_specs(shape, for_decode=True)) == {"tokens"}
    b = api.dummy_batch(shape, torch.Generator().manual_seed(1))
    assert b["img_embeds"].shape == (3, 8, cfg.d_model)
    loss, aux = api.loss(api.init(0, "cpu"), b)
    assert torch.isfinite(loss) and set(aux) == {"nll"}


def test_llava_train_probe_classifies_and_replays(tmp_path, monkeypatch):
    from repro.launch.probe import build_step_region as ref_step_region
    from repro_torch.launch.probe import main

    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    argv = ["--arch", "llava-next-34b", "--seq", "16", "--batch", "2",
            "--modes", "fp_add32,vmem_ld", "--reps", "1", "--device", "cpu",
            "--store", str(tmp_path / "v.jsonl")]
    reports, stats = main(argv)
    assert list(reports) == [ref_step_region(
        ARCH, "train", ["fp_add32"], seq=16, batch=2).name]
    assert stats.measured > 0
    _, again = main(argv + ["--expect-no-measure"])
    assert again.measured == 0
