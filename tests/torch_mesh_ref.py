"""The reference's side of the port's mesh tests, run as a script in a JAX
process of its own with four forced host devices (the device count is
fixed at JAX's first use):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_mesh_ref.py IN.pkl OUT.pkl train|ici|serve

IN.pkl holds the inputs, made by the test (``train_inputs``,
``ici_inputs``), so both packages start from the same arrays.

``train``: for gemma-2b and qwen3-moe-30b-a3b at their f32 smoke configs,
plain and with int8 compression, the state and metrics after ONE pjit'd
``make_train_step`` from the given params (fresh AdamW state) on the given
global batch, on a real (2, 1), (4, 1), (2, 2) and (1, 4) (data, model)
CPU mesh
with the trainer's ``state_shardings`` / ``batch_shardings``; and
``make_compressed_psum`` inside ``shard_map`` with a different gradient on
every device, over ("data",) on 2 and 4 devices and ("pod", "data") on a
2 x 2 mesh.

``ici``: the three ICI modes, static and run-time k, over the "model" axis
of a (2,) and a (4,) mesh, and on a ("data",) mesh that lacks the axis.

``serve``: for gemma-2b, qwen3-moe-30b-a3b (capacity factor 0.5) and
mamba2-780m at their f32 smoke configs, the reference's own ``launch.steps.prefill_cell`` and
``decode_cell`` programs, jitted with their shardings on a real (2, 1),
(1, 2), (2, 2) and (1, 4) (data, model) CPU mesh, from the given params,
prompt tokens, cache, decode tokens and position: the prefill's last-position
logits, the decode step's logits and its updated cache.

The results are pickled as numpy trees.
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro import compat
from repro import configs
from repro.configs.base import ShapeConfig, TrainConfig
from repro.core import noise
from repro.data.pipeline import SyntheticPipeline
from repro.models.model import build
from repro.train import grad_compression as gc
from repro.train.optimizer import adamw_init
from repro.train.trainer import (TrainState, batch_shardings,
                                 make_train_step, state_shardings)

ARCHS = ("gemma-2b", "qwen3-moe-30b-a3b")
MESHES = ((2, 1), (4, 1), (2, 2), (1, 4))
TCFG = dict(lr=1e-3, warmup_steps=1)
SHAPE = ShapeConfig("mesh_test", "train", 16, 8)
ICI_SCALE = noise.NoiseScale(ici_kib=1)
ICI_K = 3
SERVE_ARCHS = ("gemma-2b", "qwen3-moe-30b-a3b", "mamba2-780m")
SERVE_MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))
# 64 sequences, and a MoE capacity factor of 0.5, so that the decode's
# dispatch drops (token, choice) pairs: the global batch's one group and a
# rank's own rows then drop different pairs
SERVE_B, SERVE_S, SERVE_POS = 64, 32, 9
SERVE_CAPACITY = 0.5


def serve_config(arch: str):
    cfg = f32_smoke(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=SERVE_CAPACITY)
    return cfg
CPSUM_CASES = (((2,), ("data",)), ((4,), ("data",)),
               ((2, 2), ("pod", "data")))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(shape, axes):
    n = int(np.prod(shape))
    return compat.make_mesh(shape, axes, devices=jax.devices()[:n])


def _state_np(s: TrainState) -> dict:
    return {"params": _np(s.params), "step": np.asarray(s.opt.step),
            "mu": _np(s.opt.mu), "nu": _np(s.opt.nu),
            "master": None if s.opt.master is None else _np(s.opt.master),
            "residuals": None if s.residuals is None else _np(s.residuals)}


def f32_smoke(arch: str):
    return dataclasses.replace(configs.get_smoke_config(arch),
                               param_dtype="float32", compute_dtype="float32")


def train_inputs() -> dict:
    """{arch: {"params", "batch"}} (PRNGKey(0), the pipeline's step 0) and
    the compressed psum's per-device gradients and residuals."""
    out = {}
    for arch in ARCHS:
        cfg = f32_smoke(arch)
        out[arch] = {"params": _np(build(cfg).init(jax.random.PRNGKey(0))),
                     "batch": _np(SyntheticPipeline(cfg, SHAPE)(0))}
    rng = np.random.RandomState(7)
    for shape, axes in CPSUM_CASES:
        n = int(np.prod(shape))
        g = {"a": rng.randn(n * 4, 8).astype(np.float32),
             "b": (rng.randn(n * 2, 3) * 10).astype(np.float32)}
        r = {k: (rng.randn(*v.shape) * 1e-2).astype(np.float32)
             for k, v in g.items()}
        out[(shape, axes)] = {"g": g, "r": r}
    return out


def ici_inputs() -> dict:
    return {"v": np.asarray(jax.random.normal(
        jax.random.PRNGKey(3), (ICI_SCALE.ici_kib * 256,), jnp.float32))}


def train_cases(inputs: dict) -> dict:
    out = {}
    for arch in ARCHS:
        api = build(f32_smoke(arch))
        params = jax.tree.map(jnp.asarray, inputs[arch]["params"])
        batch = jax.tree.map(jnp.asarray, inputs[arch]["batch"])
        tcfg = TrainConfig(**TCFG)
        for compress in (None, "int8"):
            state0 = TrainState(params=params, opt=adamw_init(params),
                                residuals=(gc.init_residuals(params)
                                           if compress else None))
            for shape in MESHES:
                mesh = _mesh(shape, ("data", "model"))
                step = make_train_step(api, tcfg, mesh=mesh,
                                       compress=compress)
                fn = jax.jit(step, in_shardings=(
                    state_shardings(api, mesh, state0),
                    batch_shardings(mesh, batch)))
                s1, metrics = fn(state0, batch)
                out[(arch, compress, shape)] = dict(
                    _state_np(s1), metrics=_np(metrics))
    return out


def cpsum_cases(inputs: dict) -> dict:
    out = {}
    for shape, axes in CPSUM_CASES:
        g, r = inputs[(shape, axes)]["g"], inputs[(shape, axes)]["r"]
        mesh = _mesh(shape, axes)
        spec = P(axes if len(axes) > 1 else axes[0])
        mean, new_r = compat.shard_map(
            gc.make_compressed_psum(axes), mesh=mesh,
            in_specs=(spec, spec), out_specs=(spec, spec))(
                jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
        out[(shape, axes)] = {"mean": _np(mean), "new_r": _np(new_r)}
    return out


def ici_cases(inputs: dict) -> dict:
    out = {}
    v = inputs["v"]
    meshes = {2: _mesh((2,), ("model",)), 4: _mesh((4,), ("model",)),
              "no_axis": _mesh((2,), ("data",))}
    for key, mesh in meshes.items():
        modes = noise.make_modes(ICI_SCALE, mesh=mesh, ici_axis="model")
        for name in ("ici_allreduce", "ici_allgather", "ici_a2a"):
            m = modes[name]
            for form, apply in (("static", m.apply), ("rt", m.apply_rt)):
                aux, new = apply({"v": jnp.asarray(v)}, ICI_K)
                out[(key, name, form)] = {"aux": np.asarray(aux),
                                          "v": np.asarray(new["v"])}
    return out


def serve_inputs() -> dict:
    """{arch: {"params", "prompt" (B, S), "cache" (decode_init's tree, of
    random values), "tokens" (B, 1), "pos"}}, from PRNGKey(0) and a numpy
    seed."""
    out = {}
    rng = np.random.RandomState(11)
    for arch in SERVE_ARCHS:
        cfg = serve_config(arch)
        api = build(cfg)
        params = api.init(jax.random.PRNGKey(0))
        cache = api.decode_init(params, {"tokens": jnp.zeros(
            (SERVE_B, 1), jnp.int32), "max_seq": SERVE_S})
        cache = jax.tree.map(
            lambda x: (rng.randn(*x.shape) * 0.5).astype(np.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x),
            cache)
        out[arch] = {
            "params": _np(params),
            "prompt": rng.randint(0, cfg.vocab_size,
                                  (SERVE_B, SERVE_S)).astype(np.int32),
            "cache": cache,
            "tokens": rng.randint(0, cfg.vocab_size,
                                  (SERVE_B, 1)).astype(np.int32),
            "pos": SERVE_POS}
    return out


def serve_cases(inputs: dict) -> dict:
    from repro.launch.steps import decode_cell, prefill_cell

    out = {}
    for arch in SERVE_ARCHS:
        api = build(serve_config(arch))
        x = inputs[arch]
        params = jax.tree.map(jnp.asarray, x["params"])
        for shape in SERVE_MESHES:
            mesh = _mesh(shape, ("data", "model"))
            with compat.set_mesh(mesh):
                pc = prefill_cell(api, ShapeConfig(
                    "p", "prefill", SERVE_S, SERVE_B), mesh)
                logits = jax.jit(pc.fn, in_shardings=pc.in_shardings)(
                    params, {"tokens": jnp.asarray(x["prompt"])})
                dc = decode_cell(api, ShapeConfig(
                    "d", "decode", SERVE_S, SERVE_B), mesh)
                dl, cache = jax.jit(
                    dc.fn, in_shardings=dc.in_shardings,
                    out_shardings=dc.out_shardings)(
                        params, jax.tree.map(jnp.asarray, x["cache"]),
                        jnp.asarray(x["tokens"]), jnp.int32(x["pos"]))
            out[(arch, shape)] = {"prefill": np.asarray(logits),
                                  "decode": np.asarray(dl),
                                  "cache": _np(cache)}
    return out


def main() -> None:
    src, path, what = sys.argv[1:4]
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    if what == "train":
        res = {"train": train_cases(inputs), "cpsum": cpsum_cases(inputs)}
    elif what == "serve":
        res = {"serve": serve_cases(inputs)}
    else:
        res = {"ici": ici_cases(inputs)}
    with open(path, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
