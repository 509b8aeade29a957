"""The port's Mamba2 / SSD mixer (``repro_torch.models.ssm``) and the ssm
family's model API against the reference's (``repro.models.ssm``,
``repro.models.model``) on the CPU, at smoke size, with the reference's own
initialised weights carried over by ``convert.params_to_torch``:

* ``ssd_chunked`` against the reference's at (S, chunk) in {(32, 8),
  (64, 16), (24, 24)} — y and the final state — and against the port's
  sequential recurrence (``ssd_sequential``); the initial-state carry;
* ``ssm_block``; ``ssm_decode_step`` in f32 and in bf16;
* mamba2 smoke ``forward`` logits and loss, 8 ``decode_step``s, and a
  decode step run twice on one cache (the step is out of place).

Tolerance: f32, atol = rtol = 1e-4, but the chunked form against a
sequential recurrence (the reference's own oracle bound, 2e-4: the
chunked sum is a different order of the same f32 products) and bf16:
atol = rtol = 2^-5, four bf16 ulps at magnitude 1. The reference's silu on
the CPU rounds each of its ops to bf16 (XLA expands it as x·(1/(1+e^-x))),
the port's ``F.silu`` rounds once; the one-ulp differences there move the
outputs by up to 0.031 at magnitudes up to ~3 over twelve steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import ssm as rssm
from repro.models.model import build as ref_build
from repro_torch import configs
from repro_torch.convert import params_to_torch, ssm_params_to_torch
from repro_torch.models import ssm
from repro_torch.models.model import build

ARCH = "mamba2_780m"
TOL = dict(atol=1e-4, rtol=1e-4)
ORACLE_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=2 ** -5, rtol=2 ** -5)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, api, params) and (port cfg, api, params), f32, the
    same weights."""
    rcfg = _f32(ref_configs.get_smoke_config(ARCH))
    cfg = _f32(configs.get_smoke_config(ARCH))
    rapi, api = ref_build(rcfg), build(cfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    params = params_to_torch(cfg, jax.tree.map(np.asarray, rparams))
    return rapi, rparams, api, params


def _ssd_inputs(cfg, B, S, seed=0):
    """x, B, C, dt, A of the reference test's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    nh, hp = cfg.ssm_nheads, cfg.ssm_headdim
    ng, N = cfg.ssm_ngroups, cfg.ssm_state
    x = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, ng, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, ng, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.exp(np.linspace(-1.0, 1.0, nh))).astype(np.float32)
    return x, Bm, Cm, dt, A


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (24, 24)])
def test_ssd_chunked_matches_the_reference(S, chunk):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), ssm_chunk=chunk)
    rcfg = ref_configs.get_smoke_config(ARCH).scaled(ssm_chunk=chunk)
    ref_in, in_ = _both(_ssd_inputs(cfg, 2, S))
    want_y, want_s = rssm.ssd_chunked(rcfg, *ref_in)
    y, s = ssm.ssd_chunked(cfg, *in_)
    _close(y, want_y)
    _close(s, want_s)


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (24, 24)])
def test_ssd_chunked_matches_the_sequential_recurrence(S, chunk):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), ssm_chunk=chunk)
    _, in_ = _both(_ssd_inputs(cfg, 2, S, seed=1))
    y, s = ssm.ssd_chunked(cfg, *in_)
    y_seq, s_seq = ssm.ssd_sequential(*in_)
    _close(y, y_seq, **ORACLE_TOL)
    _close(s, s_seq, **ORACLE_TOL)


def test_ssd_chunked_rejects_a_ragged_sequence():
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), ssm_chunk=8)
    _, in_ = _both(_ssd_inputs(cfg, 1, 20))
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(cfg, *in_)


def test_initial_state_carry():
    """[first half] then [second half from the carried state] equals the
    whole sequence, and the port's carry equals the reference's."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), ssm_chunk=8)
    rcfg = ref_configs.get_smoke_config(ARCH).scaled(ssm_chunk=8)
    arrays = _ssd_inputs(cfg, 2, 32, seed=2)
    ref_in, in_ = _both(arrays)
    y_full, st_full = ssm.ssd_chunked(cfg, *in_)
    halves = [[a[:, :16] for a in in_[:4]] + [in_[4]],
              [a[:, 16:] for a in in_[:4]] + [in_[4]]]
    y1, st1 = ssm.ssd_chunked(cfg, *halves[0])
    y2, st2 = ssm.ssd_chunked(cfg, *halves[1], init_state=st1)
    _close(torch.cat([y1, y2], 1), y_full, **ORACLE_TOL)
    _close(st2, st_full, **ORACLE_TOL)
    ref_half = [[a[:, 16:] for a in ref_in[:4]] + [ref_in[4]]]
    want_y2, want_st2 = rssm.ssd_chunked(rcfg, *ref_half[0],
                                         init_state=jnp.asarray(_np(st1)))
    _close(y2, want_y2)
    _close(st2, want_st2)


# ---------------------------------------------------------------------------
# the block and its decode step
# ---------------------------------------------------------------------------

def _block_pair(dtype: str):
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    if dtype == "float32":
        rcfg, cfg = _f32(rcfg), _f32(cfg)
    rp = rssm.init_ssm(jax.random.PRNGKey(3), rcfg)
    tree = {"blocks": {"ln": {"scale": np.ones((1, cfg.d_model),
                                               np.float32)},
                       "ssm": {k: np.asarray(v)[None]
                               for k, v in rp.items()}},
            "embed": {"table": np.zeros((cfg.vocab_size, cfg.d_model),
                                        np.float32)},
            "final_norm": {"scale": np.ones(cfg.d_model, np.float32)}}
    port = ssm_params_to_torch(dataclasses.replace(cfg, n_layers=1), tree)
    return rcfg, rp, cfg, port.blocks[0].ssm


def test_ssm_leaves_and_dtypes():
    """Twelve leaves; A_log, dt_bias and D_skip f32 in a bf16 model, the
    rest bf16."""
    cfg = configs.get_smoke_config(ARCH)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    names = dict(p.named_parameters())
    assert set(names) == set(rssm.init_ssm(jax.random.PRNGKey(0), cfg))
    for name, t in names.items():
        want = (torch.float32 if name in ("A_log", "dt_bias", "D_skip")
                else torch.bfloat16)
        assert t.dtype == want, name
    torch.testing.assert_close(p.A_log.exp(), torch.linspace(
        1.0, 16.0, cfg.ssm_nheads))


def test_ssm_block_matches_the_reference():
    rcfg, rp, cfg, p = _block_pair("float32")
    h = np.random.default_rng(4).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    want, want_st = rssm.ssm_block(rp, rcfg, jnp.asarray(h),
                                   return_state=True)
    got, st = ssm.ssm_block(p, cfg, torch.from_numpy(h), return_state=True)
    _close(got, want)
    _close(st, want_st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_matches_the_reference(dtype):
    """Twelve steps from a zero cache: the outputs and the cache in f32
    within 1e-4, in bf16 within ``BF16_TOL``."""
    rcfg, rp, cfg, p = _block_pair(dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    h = np.random.default_rng(5).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    rh = jnp.asarray(h).astype(rcfg.compute_dtype)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    rc = rssm.init_ssm_cache(rcfg, 2)
    c = ssm.init_ssm_cache(cfg, 2, "cpu")
    for t in range(12):
        want, rc = rssm.ssm_decode_step(rp, rcfg, rh[:, t:t + 1], rc)
        got, c = ssm.ssm_decode_step(p, cfg, th[:, t:t + 1], c)
        _close(_np(got), want, **tol)
    _close(c["state"], rc["state"], **tol)
    _close(_np(c["conv"]), np.asarray(rc["conv"], np.float32), **tol)


# ---------------------------------------------------------------------------
# the mamba2 model API
# ---------------------------------------------------------------------------

def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=shape).astype(np.int32)


def test_forward_logits_and_loss_match_the_reference(pair):
    rapi, rparams, api, params = pair
    toks = _tokens(api.cfg, (2, 64))
    labels = _tokens(api.cfg, (2, 64), seed=1)
    want, _ = rapi.forward(rparams, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(params, {"tokens": torch.from_numpy(toks)})
    assert aux == {}
    _close(got, want)
    want_l, _ = rapi.loss(rparams, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
    got_l, _ = api.loss(params, {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels)})
    _close(got_l, want_l)


def test_eight_decode_steps_match_the_reference_and_the_forward(pair):
    rapi, rparams, api, params = pair
    toks = _tokens(api.cfg, (2, 8), seed=2)
    rc = rapi.decode_init(rparams, {"tokens": jnp.zeros((2, 1), jnp.int32)})
    c = api.decode_init(params, {"tokens": torch.zeros((2, 1))})
    assert c["ssm"]["state"].shape == (api.cfg.n_layers, 2,
                                       api.cfg.ssm_nheads,
                                       api.cfg.ssm_headdim,
                                       api.cfg.ssm_state)
    assert c["ssm"]["state"].dtype == torch.float32
    steps = []
    for i in range(8):
        want, rc = rapi.decode_step(rparams, rc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.int32(i))
        got, c = api.decode_step(params, c, torch.from_numpy(toks[:, i:i + 1]),
                                 torch.tensor(i, dtype=torch.int32))
        _close(got, want)
        steps.append(got[:, 0])
    _close(c["ssm"]["state"], rc["ssm"]["state"])
    full, _ = api.forward(params, {"tokens": torch.from_numpy(toks)})
    _close(torch.stack(steps, 1), full, **ORACLE_TOL)


def test_decode_step_twice_on_one_cache_is_equal(pair):
    """The step is out of place: the cache it is given stays as it was, so
    a replay on the same arguments gives the same logits and state."""
    _, _, api, params = pair
    c = api.decode_init(params, 2)
    tok = torch.from_numpy(_tokens(api.cfg, (2, 1), seed=3))
    pos = torch.tensor(0, dtype=torch.int32)
    _, c = api.decode_step(params, c, tok, pos)
    before = {k: t.clone() for k, t in c["ssm"].items()}
    a, ca = api.decode_step(params, c, tok, pos)
    b, cb = api.decode_step(params, c, tok, pos)
    assert torch.equal(a, b)
    for name in ("state", "conv"):
        assert torch.equal(ca["ssm"][name], cb["ssm"][name])
        assert torch.equal(c["ssm"][name], before[name])
        assert ca["ssm"][name] is not c["ssm"][name]


def test_init_draws_from_the_seed_on_the_device():
    cfg = configs.get_smoke_config(ARCH)
    api = build(cfg)
    p = api.init(0, "cpu")
    assert isinstance(p, ssm.SSMLM) and len(p.blocks) == cfg.n_layers
    assert torch.equal(api.init(0, "cpu").embed.table, p.embed.table)
    assert not torch.equal(api.init(1, "cpu").embed.table, p.embed.table)
    rparams = ref_build(ref_configs.get_smoke_config(ARCH)).init(
        jax.random.PRNGKey(0))
    assert (sum(t.numel() for t in p.parameters())
            == sum(a.size for a in jax.tree.leaves(rparams)))
