"""The port's training path (``repro_torch.train``, ``data``, ``ckpt``,
``launch/train.py``, the models' remat) against the reference's on the
CPU, at smoke size, in f32 unless a test says bf16, with the reference's
own initialised state carried over by ``convert.train_state_to_torch``:

* ``TrainConfig`` and ``MeshConfig`` field for field and default for
  default, ``SHAPES`` and ``shape_applicable`` for every architecture;
* ``SyntheticPipeline`` batches bitwise equal (lcg, uniform, the encdec
  frames and the vlm image embeds);
* ``adamw_update`` over a carried state within 1e-6 (params, mu, nu), the
  stacked per-layer norm scales decayed and the final norm not;
  ``lr_schedule``, ``global_norm`` and the clip; the bf16 master path
  within one bf16 ulp;
* gradients against ``jax.grad`` of the reference's loss, within 1e-4 of
  each leaf's largest |g| (measured: 1.8e-6 dense, 1.3e-5 ssm), for the
  dense (blocked and flash), moe, vlm, ssm, hybrid and encdec families;
* three ``make_train_step`` steps from the reference's state at M = 1 and
  M = 4, parameters within 1e-5 (dense, moe, vlm). Adam divides each
  gradient element by its own magnitude, so an element whose gradient
  sums to ~eps moves by a share of lr that the f32 order of its terms
  sets: at lr 1e-3 the two packages part by up to 1.1e-5 (gemma) and
  3.4e-5 (mamba2) after three steps, at the reference's default lr 3e-4
  by 3.4e-6 (gemma), 3.9e-6 (qwen3-moe) and 8.1e-6 (llava), measured on
  the CPU; the ssm, hybrid and encdec families part past 1e-5 at 3e-4
  (up to 2.4e-5, whisper at M = 4) and are held on three AdamW steps fed
  the reference's gradients, within 1e-6 (measured 3e-8);
* the remat policies give equal gradients, and the backward recomputes
  the more the less they keep; an unknown policy raises in every family;
* the reference's trainer tests: microbatch equivalence, restart replays
  (the replayed loss equal to the uninterrupted run's), the straggler
  flag, a bf16 checkpoint round trip (bitwise), checkpoint GC, the int8
  round trip, error feedback and the compressed psum (``gloo``, world
  size 1);
* the CLI on ``--device cpu``: a rerun resumes, a rerun after the last
  step exits non-zero with its message, ``--mesh single`` in one process
  exits with the reference's message (the mesh path itself:
  ``tests/test_torch_mesh_train.py``).
"""
import dataclasses
import os
import shutil
import subprocess
import sys

try:
    import hypothesis
    import hypothesis.strategies as st
except ModuleNotFoundError:   # property tests skip; the rest still runs
    from conftest import hypothesis_stub as hypothesis
    from conftest import strategies_stub as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro import compat
from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import TrainConfig as RefTrain
from repro.data.pipeline import SyntheticPipeline as RefPipe
from repro.models.model import build as ref_build
from repro.train import grad_compression as rgc
from repro.train import optimizer as ropt
from repro.train.trainer import TrainState as RefState
from repro.train.trainer import make_train_step as ref_make_step
from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ShapeConfig, TrainConfig
from repro_torch.convert import (named_to_torch, params_to_torch,
                                 reference_ndim, train_state_to_torch)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build
from repro_torch.train import grad_compression as gc
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import (Trainer, TrainState, _requires_grad,
                                       loss_and_grads, make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_SHARE = 1e-4


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


def _pair(arch, f32=True, **kw):
    """(reference cfg, api, params) and (port cfg, api) of ``arch``'s smoke
    config, the reference's params from PRNGKey(0)."""
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    if f32:
        rcfg, cfg = _f32(rcfg, **kw), _f32(cfg, **kw)
    else:
        rcfg = dataclasses.replace(rcfg, **kw)
        cfg = dataclasses.replace(cfg, **kw)
    rapi = ref_build(rcfg)
    return rcfg, rapi, rapi.init(jax.random.PRNGKey(0)), cfg, build(cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    """Any array or tensor -> numpy integers of its bits (floats) or
    itself (ints)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def _shape(seq=24, batch=4):
    return RefShape("t", "train", seq, batch), ShapeConfig("t", "train", seq,
                                                          batch)


def _port_batch(rb) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_train_and_mesh_configs_equal_the_reference():
    from repro.configs import base as rbase

    from repro_torch.configs import base
    for name in ("TrainConfig", "MeshConfig"):
        want = [(f.name, f.default) for f in
                dataclasses.fields(getattr(rbase, name))]
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(base, name))]
        assert got == want, name
    mesh = base.MeshConfig((2, 16, 16), ("pod", "data", "model"))
    assert mesh.n_devices == 512 and mesh.batch_axes == ("pod", "data")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_shapes_and_their_applicability_equal_the_reference(arch):
    from repro.configs import base as rbase

    from repro_torch.configs import base
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in rbase.SHAPES.items()}
    for name in base.SHAPES:
        assert base.shape_applicable(configs.get_config(arch),
                                     base.SHAPES[name]) == \
            rbase.shape_applicable(ref_configs.get_config(arch),
                                   rbase.SHAPES[name])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

PIPES = (("gemma_2b", "lcg"), ("gemma_2b", "uniform"),
         ("whisper_large_v3", "lcg"), ("llava_next_34b", "uniform"))


@pytest.mark.parametrize("arch,task", PIPES,
                         ids=[f"{a}-{t}" for a, t in PIPES])
def test_pipeline_batches_equal_the_reference_bitwise(arch, task):
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    rshape, shape = _shape()
    for step in (0, 7, 1_000_003):
        rb = RefPipe(rcfg, rshape, task=task, seed=3).batch(step)
        b = SyntheticPipeline(cfg, shape, task=task, seed=3,
                              device="cpu").batch(step)
        assert set(b) == set(rb)
        for name in rb:
            assert str(b[name].dtype).removeprefix("torch.") == \
                str(rb[name].dtype), name
            np.testing.assert_array_equal(_bits(b[name]), _bits(rb[name]))


def test_pipeline_is_a_pure_function_of_the_step():
    cfg = configs.get_smoke_config("minitron_4b")
    _, shape = _shape(32, 8)
    p1 = SyntheticPipeline(cfg, shape, task="lcg", seed=3, device="cpu")
    p2 = SyntheticPipeline(cfg, shape, task="lcg", seed=3, device="cpu",
                           batch_override=2)
    b1, b2 = p1.batch(17), p2.batch(17)
    assert b2["tokens"].shape == (2, 32)
    torch.testing.assert_close(b1["tokens"][:2], b2["tokens"], rtol=0,
                               atol=0)
    V = cfg.vocab_size
    a = (1103515245 % V) or 1
    t, lab = b1["tokens"].numpy(), b1["labels"].numpy()
    np.testing.assert_array_equal((a * t[:, 0] + 12345) % V, lab[:, 0])
    it = iter(p1)
    for step in range(3):
        torch.testing.assert_close(next(it)["tokens"], p1(step)["tokens"],
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _random_grads(rparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), rparams)


def _named_close(cfg, got: dict, want_tree, what, **tol):
    want = named_to_torch(cfg, _np(want_tree))
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.float().numpy(), want[name].float()
                                   .numpy(), err_msg=f"{what} {name}", **tol)


def test_adamw_update_equals_the_reference_over_a_carried_state():
    rcfg, _, rp, cfg, _ = _pair("gemma_2b")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1,
              grad_clip=1.0)
    rstate = ropt.adamw_init(rp)
    state = train_state_to_torch(cfg, _np(RefState(params=rp, opt=rstate)))
    for i in range(3):
        rg = _random_grads(rp, i)
        rp, rstate, rstats = ropt.adamw_update(RefTrain(**kw), rp, rg,
                                               rstate)
        _, _, stats = opt.adamw_update(TrainConfig(**kw), state.params,
                                       named_to_torch(cfg, rg), state.opt)
        for key in ("grad_norm", "lr"):
            assert float(stats[key]) == pytest.approx(float(rstats[key]),
                                                      rel=1e-6)
    assert int(state.opt.step) == int(rstate.step) == 3
    tol = dict(atol=1e-6, rtol=0)
    _named_close(cfg, dict(state.params.named_parameters()), rp, "param",
                 **tol)
    _named_close(cfg, state.opt.mu, rstate.mu, "mu", **tol)
    _named_close(cfg, state.opt.nu, rstate.nu, "nu", **tol)


def test_stacked_norm_scales_decay_and_the_final_norm_does_not():
    """Zero gradients: only the decay moves a parameter. The reference
    decays its (L, d) per-layer norm scales and not its (d,) final norm;
    so does the port, whose per-layer scales are (d,) tensors."""
    rcfg, _, rp, cfg, _ = _pair("gemma_2b")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.5)
    rg = jax.tree.map(jnp.zeros_like, rp)
    rp2, _, _ = ropt.adamw_update(RefTrain(**kw), rp, rg, ropt.adamw_init(rp))
    state = train_state_to_torch(cfg, _np(RefState(params=rp,
                                                   opt=ropt.adamw_init(rp))))
    opt.adamw_update(TrainConfig(**kw), state.params,
                     named_to_torch(cfg, _np(rg)), state.opt)
    named = dict(state.params.named_parameters())
    lr = float(opt.lr_schedule(TrainConfig(**kw), torch.tensor(1)))
    for i in range(cfg.n_layers):
        for ln in ("ln1", "ln2"):
            torch.testing.assert_close(
                named[f"layers.{i}.{ln}.scale"],
                torch.full((cfg.d_model,), 1 - lr * 0.5))
    torch.testing.assert_close(named["final_norm.scale"],
                               torch.ones(cfg.d_model), rtol=0, atol=0)
    _named_close(cfg, named, rp2, "param", atol=1e-7, rtol=0)


@pytest.mark.parametrize("name,shape,want", [
    ("layers.0.ln1.scale", (64,), 2), ("final_norm.scale", (64,), 1),
    ("layers.1.attn.wq", (64, 4, 16), 4), ("blocks.3.ssm.A_log", (8,), 2),
    ("mamba.0.ln.scale", (64,), 2), ("shared.ln1.scale", (64,), 1),
    ("enc_layers.1.mlp.w_up", (64, 128), 3), ("enc_norm.scale", (64,), 1),
    ("dec_layers.0.lnx.scale", (64,), 2), ("embed.table", (256, 64), 2)])
def test_reference_ndim_reads_the_stacked_trees(name, shape, want):
    assert reference_ndim(name, torch.zeros(shape)) == want


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 100, 150])
def test_lr_schedule_equals_the_reference(step):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    want = float(ropt.lr_schedule(RefTrain(**kw), jnp.int32(step)))
    got = float(opt.lr_schedule(TrainConfig(**kw),
                                torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_lr_schedule_shape():
    tcfg = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)

    def lr(s):
        return float(opt.lr_schedule(tcfg, torch.tensor(s)))
    assert lr(0) == 0.0
    assert lr(5) == pytest.approx(5e-4)
    assert lr(10) == pytest.approx(1e-3, rel=1e-3)
    assert lr(100) == pytest.approx(1e-4, rel=1e-2)  # 10% floor


def test_global_norm_and_clip_equal_the_reference():
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(s).astype(np.float32) * 30
            for s in ((3, 4), (7,), (2, 5, 6))]
    want = float(ropt.global_norm([jnp.asarray(a) for a in arrs]))
    got = float(opt.global_norm([torch.from_numpy(a) for a in arrs]))
    assert got == pytest.approx(want, rel=1e-6)
    kw = dict(grad_clip=1.0, lr=1.0, warmup_steps=0, total_steps=1,
              weight_decay=0.0)
    p = {"w": jnp.zeros((4,), jnp.float32)}
    g = {"w": jnp.full((4,), 100.0)}
    rp, _, rstats = ropt.adamw_update(RefTrain(**kw), p, g,
                                      ropt.adamw_init(p, use_master=False))
    tp = torch.nn.Module()
    tp.w = torch.nn.Parameter(torch.zeros(4), requires_grad=False)
    _, _, stats = opt.adamw_update(TrainConfig(**kw), tp,
                                   {"w": torch.full((4,), 100.0)},
                                   opt.adamw_init(tp, use_master=False))
    assert float(stats["grad_norm"]) == pytest.approx(200.0)
    np.testing.assert_allclose(tp.w.numpy(), np.asarray(rp["w"]), atol=1e-7)


def test_adamw_single_param_matches_the_closed_form():
    tcfg = TrainConfig(lr=1e-2, warmup_steps=0, weight_decay=0.0,
                       grad_clip=0.0, b1=0.9, b2=0.999, eps=1e-8,
                       total_steps=10)
    p = torch.nn.Module()
    p.w = torch.nn.Parameter(torch.tensor([[1.0, 2.0]]), requires_grad=False)
    state = opt.adamw_init(p, use_master=False)
    assert state.master is None
    opt.adamw_update(tcfg, p, {"w": torch.tensor([[0.1, -0.2]])}, state)
    m = 0.1 * np.asarray([[0.1, -0.2]])
    v = 0.001 * np.asarray([[0.01, 0.04]])
    lr = float(opt.lr_schedule(tcfg, torch.tensor(1)))
    want = np.asarray([[1.0, 2.0]]) - lr * (m / 0.1) / (np.sqrt(v / 0.001)
                                                        + 1e-8)
    np.testing.assert_allclose(p.w.numpy(), want, rtol=1e-5)
    assert int(state.step) == 1


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


def test_master_path_in_bf16_within_one_ulp():
    """bf16 params with f32 masters (gemma smoke's own dtypes), five
    updates with random f32 grads: the masters within 1e-6, the bf16
    params within one bf16 ulp of the reference's."""
    rcfg, _, rp, cfg, _ = _pair("gemma_2b", f32=False)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rstate = ropt.adamw_init(rp)
    assert rstate.master is not None
    state = train_state_to_torch(cfg, _np(RefState(params=rp, opt=rstate)))
    assert state.opt.master is not None
    for i in range(5):
        rg = _random_grads(rp, 10 + i)
        rp, rstate, _ = ropt.adamw_update(RefTrain(**kw), rp, rg, rstate)
        opt.adamw_update(TrainConfig(**kw), state.params,
                         named_to_torch(cfg, rg), state.opt)
    _named_close(cfg, state.opt.master, rstate.master, "master", atol=1e-6,
                 rtol=0)
    want = named_to_torch(cfg, _np(rp))
    for name, t in state.params.named_parameters():
        assert t.dtype == torch.bfloat16
        w = want[name].float().numpy()
        diff = np.abs(t.float().numpy() - w)
        assert (diff <= _bf16_ulp(w)).all(), name


def test_master_weights_bf16_accumulate_below_bf16_resolution():
    tcfg = TrainConfig(lr=1e-4, warmup_steps=0, total_steps=100,
                       weight_decay=0.0, grad_clip=0.0)
    p = torch.nn.Module()
    p.w = torch.nn.Parameter(torch.full((8,), 1.0, dtype=torch.bfloat16),
                             requires_grad=False)
    state = opt.adamw_init(p)
    assert state.master is not None
    for _ in range(50):
        opt.adamw_update(tcfg, p, {"w": torch.full((8,), 1e-3)}, state)
    assert 1.0 - float(state.master["w"][0]) > 1e-3


# ---------------------------------------------------------------------------
# gradients and train steps against the reference
# ---------------------------------------------------------------------------

def _port_grads(api, params, batch, **kw):
    loss, _, grads = loss_and_grads(api, params, batch, **kw)
    return float(loss), grads


GRAD_CASES = (("gemma_2b", "blocked"), ("gemma_2b", "flash"),
              ("qwen3_moe_30b_a3b", "blocked"), ("llava_next_34b", "blocked"),
              ("mamba2_780m", "blocked"), ("zamba2_1p2b", "blocked"),
              ("whisper_large_v3", "flash"))


@pytest.mark.parametrize("arch,impl", GRAD_CASES,
                         ids=[f"{a}-{i}" for a, i in GRAD_CASES])
def test_gradients_equal_jax_grad_of_the_reference_loss(arch, impl):
    rcfg, rapi, rp, cfg, api = _pair(arch, attn_impl=impl)
    rshape, shape = _shape(32, 4)
    rb = RefPipe(rcfg, rshape, task="uniform").batch(0)
    rloss, rg = jax.value_and_grad(lambda p: rapi.loss(p, rb)[0])(rp)
    params = params_to_torch(cfg, _np(rp))
    loss, grads = _port_grads(api, params, _port_batch(rb))
    assert loss == pytest.approx(float(rloss), rel=1e-5)
    want = named_to_torch(cfg, _np(rg))
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= GRAD_SHARE * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("arch", ["gemma_2b", "qwen3_moe_30b_a3b",
                                  "llava_next_34b"])
@pytest.mark.parametrize("M", [1, 4])
def test_three_train_steps_equal_the_reference(arch, M):
    rcfg, rapi, rp, cfg, api = _pair(arch)
    kw = dict(warmup_steps=1, total_steps=10, microbatches=M)
    rstate = RefState(params=rp, opt=ropt.adamw_init(rp))
    state = train_state_to_torch(cfg, _np(rstate))
    rstep = jax.jit(ref_make_step(rapi, RefTrain(**kw)))
    step = make_train_step(api, TrainConfig(**kw))
    rshape, shape = _shape(32, 8)
    rpipe = RefPipe(rcfg, rshape)
    pipe = SyntheticPipeline(cfg, shape, device="cpu")
    for i in range(3):
        rstate, rm = rstep(rstate, rpipe.batch(i))
        state, m = step(state, pipe.batch(i))
        assert set(m) == set(rm)
        for key in m:
            assert float(m[key]) == pytest.approx(float(rm[key]), rel=1e-5)
    assert int(state.opt.step) == 3
    _named_close(cfg, dict(state.params.named_parameters()), rstate.params,
                 "param", atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1p2b",
                                  "whisper_large_v3"])
def test_three_adamw_steps_on_the_same_gradients_equal_the_reference(arch):
    """The ssm, hybrid and encdec families part from the reference past
    1e-5 after three ``make_train_step`` steps at the default lr (measured
    on the CPU, M = 1 / 4: mamba2 1.03e-5 / 9.3e-6, zamba2 1.65e-5 /
    1.70e-5, whisper 1.54e-5 / 2.41e-5; llava 8.1e-6 / 6.1e-6 holds the
    three-step test). Fed the reference's own gradients, both packages'
    AdamW stay within 3e-8 of each other over the same three steps: the
    parting is Adam amplifying the gradients' last-ulp differences (each
    element divided by its own magnitude), not the port's update."""
    rcfg, rapi, rp, cfg, api = _pair(arch)
    kw = dict(warmup_steps=1, total_steps=10)
    rstate = ropt.adamw_init(rp)
    state = train_state_to_torch(cfg, _np(RefState(params=rp, opt=rstate)))
    rpipe = RefPipe(rcfg, _shape(32, 8)[0])
    for i in range(3):
        rb = rpipe.batch(i)
        rg = jax.grad(lambda p: rapi.loss(p, rb)[0])(rp)
        rp, rstate, _ = ropt.adamw_update(RefTrain(**kw), rp, rg, rstate)
        opt.adamw_update(TrainConfig(**kw), state.params,
                         named_to_torch(cfg, _np(rg)), state.opt)
    assert int(state.opt.step) == int(rstate.step) == 3
    tol = dict(atol=1e-6, rtol=0)
    _named_close(cfg, dict(state.params.named_parameters()), rp, "param",
                 **tol)
    _named_close(cfg, state.opt.mu, rstate.mu, "mu", **tol)
    _named_close(cfg, state.opt.nu, rstate.nu, "nu", **tol)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMAT_ARCHS = ("gemma_2b", "qwen3_moe_30b_a3b", "mamba2_780m",
               "zamba2_1p2b", "whisper_large_v3")


class _OpCount(TorchDispatchMode):
    """Counts the aten ops that run (products apart) while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.products += func in (torch.ops.aten.mm.default,
                                  torch.ops.aten.bmm.default,
                                  torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def _backward_ops(api, params, batch, **kw) -> _OpCount:
    """The ops the backward of one loss runs: its own, and the forward ops
    it recomputes."""
    with _requires_grad(params):
        loss, _ = api.loss(params, batch, **kw)
        with _OpCount() as count:
            torch.autograd.grad(loss, list(params.parameters()))
    return count


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_give_equal_gradients_and_recompute(arch):
    _, rapi, rp, cfg, api = _pair(arch, attn_impl="flash")
    rshape, _ = _shape(32, 2)
    rcfg = rapi.cfg
    batch = _port_batch(RefPipe(rcfg, rshape, task="uniform").batch(1))
    params = params_to_torch(cfg, _np(rp))
    _, want = _port_grads(api, params, batch, remat="full")
    variants = [{"remat": "nothing"}, {"remat": "dots"}]
    if cfg.family in ("dense", "moe", "vlm"):
        variants += [{"remat": "nothing", "scan_group": 2},
                     {"remat": "dots", "scan_group": 2}]
    for kw in variants:
        _, got = _port_grads(api, params, batch, **kw)
        for name, g in got.items():
            scale = float(want[name].abs().max())
            err = float((g - want[name]).abs().max())
            assert err <= 1e-6 * max(scale, 1e-30), (kw, name, err)
    # "nothing" recomputes the layers, products included; "dots" all but
    # the products, whose outputs it saved; "full" recomputes nothing
    ran = {r: _backward_ops(api, params, batch, remat=r)
           for r in ("nothing", "dots", "full")}
    assert ran["nothing"].ops > ran["dots"].ops > ran["full"].ops
    assert ran["nothing"].products > ran["dots"].products \
        == ran["full"].products


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_an_unknown_remat_policy_raises(arch):
    cfg = configs.get_smoke_config(arch)
    api = build(cfg)
    params = api.init(0, "cpu")
    _, shape = _shape(16, 1)
    batch = api.dummy_batch(shape)
    with pytest.raises(ValueError, match="unknown remat policy"):
        api.forward(params, batch, remat="everything")


def test_lm_forward_refuses_an_unknown_keyword_and_a_bad_group():
    cfg = configs.get_smoke_config("gemma_2b")
    api = build(cfg)
    params = api.init(0, "cpu")
    batch = api.dummy_batch(_shape(16, 1)[1])
    with pytest.raises(TypeError):
        api.forward(params, batch, remat="nothing", bogus=1)
    with pytest.raises(ValueError, match="groups of 3"):
        api.forward(params, batch, scan_group=3)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config("minitron_4b")
    api = build(cfg)
    _, shape = _shape(32, 8)
    return api, shape, SyntheticPipeline(cfg, shape, task="lcg",
                                         device="cpu")


def test_microbatch_equivalence(setup):
    api, _, pipe = setup
    batch = pipe.batch(0)
    tr = Trainer(api, TrainConfig(lr=1e-3), device="cpu")
    _, m1 = make_train_step(api, TrainConfig(microbatches=1, lr=1e-3))(
        tr.init_state(), batch)
    _, m2 = make_train_step(api, TrainConfig(microbatches=4, lr=1e-3))(
        tr.init_state(), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=2e-2)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=5e-2)


def test_restart_replays_batches(tmp_path, setup):
    """A failure at step 12 restores the step-10 checkpoint and replays
    steps 10-12; step 12's loss equals the uninterrupted run's."""
    api, _, pipe = setup
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20, ckpt_every=5,
              ckpt_dir=str(tmp_path))
    ckpt = CheckpointManager(str(tmp_path / "a"), keep=2)
    tr = Trainer(api, TrainConfig(**kw), ckpt_manager=ckpt, device="cpu")
    boom = {"armed": True}

    def fail(step):
        if step == 12 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected failure")

    _, hist = tr.run(tr.init_state(), pipe, steps=15, fail_injector=fail)
    steps_seen = [h["step"] for h in hist]
    assert steps_seen.count(12) == 1          # replayed exactly once
    assert steps_seen.count(10) == 2          # from the step-10 checkpoint
    assert steps_seen[-1] == 14
    assert ckpt.steps() == [10, 15]
    plain = Trainer(api, TrainConfig(**kw), device="cpu")
    _, clean = plain.run(plain.init_state(), pipe, steps=15)
    assert [h["step"] for h in clean] == list(range(15))
    assert hist[-1]["loss"] == pytest.approx(clean[-1]["loss"], abs=1e-6)
    at12 = [h["loss"] for h in hist if h["step"] == 12]
    assert at12[0] == pytest.approx(clean[12]["loss"], abs=1e-6)


def test_a_failure_without_a_checkpoint_manager_raises(setup):
    api, _, pipe = setup
    tr = Trainer(api, TrainConfig(lr=1e-3), device="cpu")

    def fail(step):
        raise RuntimeError("injected failure")

    with pytest.raises(RuntimeError, match="injected"):
        tr.run(tr.init_state(), pipe, steps=2, fail_injector=fail)


def test_straggler_flag(setup):
    api, _, pipe = setup
    tr = Trainer(api, TrainConfig(lr=1e-3, total_steps=3, ckpt_every=0,
                                  step_deadline_s=1e-9), device="cpu")
    _, hist = tr.run(tr.init_state(), pipe, steps=2)
    assert all(h.get("straggler") for h in hist)


def _bf16_state(api, seed):
    params = api.init(seed, "cpu")
    return TrainState(params=params, opt=opt.adamw_init(params))


def test_checkpoint_roundtrip_bf16(tmp_path, setup):
    """Save a bf16 state (with its f32 masters and int32 step), restore
    into a state drawn from another seed: every tensor bitwise equal, its
    dtype kept."""
    api, _, _ = setup
    state = _bf16_state(api, 0)
    state.opt.step.fill_(7)
    assert next(state.params.parameters()).dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, blocking=True)
    other = _bf16_state(api, 1)
    restored, step = mgr.restore_latest(like=other)
    assert step == 7 and restored is other
    want, got = state.tensors(), restored.tensors()
    assert list(want) == list(got)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))


def test_checkpoint_gc(tmp_path, setup):
    api, _, _ = setup
    state = _bf16_state(api, 0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=s % 2 == 0)
    mgr.wait()
    assert mgr.steps() == [3, 4]


def test_async_save_snapshots_before_an_in_place_update(tmp_path, setup):
    api, _, _ = setup
    state = _bf16_state(api, 0)
    before = {n: t.clone() for n, t in state.tensors().items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=False)
    with torch.no_grad():
        for t in state.tensors().values():
            t.add_(1)
    mgr.wait()
    restored, _ = mgr.restore_latest(like=_bf16_state(api, 2))
    for name, t in restored.tensors().items():
        np.testing.assert_array_equal(_bits(t), _bits(before[name]))


def test_checkpoint_refuses_another_structure_and_reraises(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d)
    mgr.save(1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(1, like={"a": torch.zeros(4)})
    shutil.rmtree(d)
    open(d, "w").close()            # the async write cannot make its dir
    mgr.save(2, {"a": torch.zeros(3)}, blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                      # the error is raised once


def test_trainer_refuses_a_mesh_and_carries_residuals_without_one(setup):
    """The mesh step runs on a DeviceMesh (``tests/test_torch_mesh_train.py``);
    a mesh without a process group is refused, and the trainer keeps the
    mesh it was given. Without a mesh the residuals ride along unchanged."""
    from repro_torch.parallel.sharding import AbstractMesh

    api, _, pipe = setup
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(api, TrainConfig(),
                        mesh=AbstractMesh((2, 1), ("data", "model")))
    assert Trainer(api, TrainConfig(), device="cpu").mesh is None
    tr = Trainer(api, TrainConfig(lr=1e-3), compress="int8", device="cpu")
    state = tr.init_state()
    assert state.residuals is not None
    state, hist = tr.run(state, pipe, steps=2)
    assert all(float(r.abs().max()) == 0 for r in state.residuals.values())
    plain = Trainer(api, TrainConfig(lr=1e-3), device="cpu")
    _, want = plain.run(plain.init_state(), pipe, steps=2)
    assert [h["loss"] for h in hist] == [h["loss"] for h in want]


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

@hypothesis.given(st.lists(st.floats(-100, 100, allow_nan=False, width=32),
                           min_size=4, max_size=64))
@hypothesis.settings(max_examples=50, deadline=None)
def test_int8_roundtrip_error_bound(vals):
    g = torch.tensor(vals, dtype=torch.float32)
    q, scale, resid = gc.compress_int8(g)
    rec = gc.decompress_int8(q, scale)
    assert float((g - rec).abs().max()) <= float(scale) * 0.5 + 1e-6
    np.testing.assert_allclose((g - rec).numpy(), resid.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_compression_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(300) * 10).astype(np.float32)
    r = (rng.standard_normal(300) * 0.01).astype(np.float32)
    want = rgc.compress_int8(jnp.asarray(g), jnp.asarray(r))
    got = gc.compress_int8(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert float(got[1]) == float(want[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-6, rtol=0)


def test_error_feedback_accumulates():
    """A constant gradient below one quantization step still gets through
    over multiple rounds thanks to the residual."""
    big = torch.tensor([1.0] + [0.003] * 7)
    resid = None
    recovered = torch.zeros(8)
    for _ in range(20):
        q, scale, resid = gc.compress_int8(big, resid)
        recovered += gc.decompress_int8(q, scale)
    np.testing.assert_allclose(recovered[1:].numpy(), 0.06, rtol=0.25)


def test_compressed_psum_single_process_group(tmp_path):
    """World size 1 over ``gloo``: the mean is the quantized gradient,
    equal to the reference's ``make_compressed_psum`` on one device."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        g = np.linspace(-1, 1, 32, dtype=np.float32).reshape(4, 8)
        r = np.zeros((4, 8), np.float32)
        out, new_r = gc.make_compressed_psum()(
            {"a": torch.from_numpy(g)}, {"a": torch.from_numpy(r)})
    finally:
        dist.destroy_process_group()
    scale = float(np.abs(g).max()) / 127.0
    assert float((out["a"] - torch.from_numpy(g)).abs().max()) <= \
        scale * 0.5 + 1e-7
    mesh = compat.make_mesh((1,), ("data",))
    spec = jax.sharding.PartitionSpec()
    want, want_r = compat.shard_map(
        rgc.make_compressed_psum(("data",)), mesh=mesh,
        in_specs=(spec, spec), out_specs=(spec, spec))(
            {"a": jnp.asarray(g)}, {"a": jnp.asarray(r)})
    np.testing.assert_allclose(out["a"].numpy(), np.asarray(want["a"]),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(new_r["a"].numpy(), np.asarray(want_r["a"]),
                               atol=1e-7, rtol=0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*argv):
    return train_cli.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                           "--seq", "32", "--batch", "4", *argv])


def test_cli_resumes_and_refuses_a_rerun_past_the_last_step(tmp_path,
                                                             capsys):
    ck = ["--ckpt-every", "5", "--ckpt-dir", str(tmp_path)]
    first = _cli("--steps", "10", *ck)
    assert [h["step"] for h in first] == list(range(10))
    capsys.readouterr()
    second = _cli("--steps", "20", *ck)
    assert "resumed from checkpoint step 10" in capsys.readouterr().out
    assert [h["step"] for h in second] == list(range(10, 20))
    assert second[-1]["loss"] < first[0]["loss"]
    with pytest.raises(SystemExit) as e:
        _cli("--steps", "10", *ck)
    assert "nothing to train" in str(e.value.code)
    assert "IndexError" in str(e.value.code)


def test_cli_refuses_a_mesh():
    """``--mesh single`` needs 256 ranks; one process exits with the
    reference launcher's ValueError message."""
    from repro.launch.mesh import make_production_mesh

    with pytest.raises(SystemExit) as e:
        _cli("--steps", "2", "--mesh", "single")
    with pytest.raises(ValueError) as want:
        make_production_mesh()
    n = jax.device_count()
    assert str(e.value.code) == str(want.value).replace(
        f"devices {n} ", "devices 1 ")
    assert str(e.value.code) == ("Number of devices 1 must be >= the "
                                 "product of mesh_shape (16, 16)")


def test_cli_runs_on_the_cpu_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma-2b", "--smoke", "--device", "cpu", "--steps", "3", "--seq",
         "16", "--batch", "2", "--compress", "int8"],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "final loss:" in out.stdout and "device=cpu" in out.stdout


def test_cli_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"])
    assert "no CUDA device" in str(e.value.code)
