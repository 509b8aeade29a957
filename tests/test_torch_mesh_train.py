"""The trainer's mesh path (``train/trainer.py``: ``shard_state``, the mesh
step, ``state_shardings``/``batch_shardings``), the compressed all-reduce
across ranks and the sharded checkpoints, against the reference on the
CPU.

The port runs on ``gloo`` ranks (``tests/torch_mesh_ranks.py``), the
reference in one JAX subprocess with four forced host devices
(``tests/torch_mesh_ref.py``), both at the same time, from the same
inputs (the reference's f32 smoke params from PRNGKey(0), its pipeline's
step-0 batch of 8 x 16 tokens):

* one mesh step of gemma-2b and qwen3-moe-30b-a3b, plain and with int8
  compression, on a (2, 1), (4, 1), (2, 2) and (1, 4) (data, model) mesh
  (on (2, 2) and (1, 4) the attention, the dense MLP and the vocabulary
  split over ``model``, tensor parallelism), against the reference's
  pjit step on the same mesh, the metrics within
  ``METRIC_RTOL``. Plain: the AdamW moments (the averaged gradients) within
  ``MOMENT_RTOL`` of each leaf's largest (measured 2.5e-6: the replica
  mean is summed in another order), the parameters within ``PARAM_TOL``
  (Adam's first step divides each gradient by its own magnitude, so an
  element whose gradient is near 0 moves by a share of lr 1e-3 that the
  f32 order sets: measured 1.6e-5). int8: a rounding of (g + r) / scale
  that lands on the other side of .5 moves that element's quantized
  gradient by one quantum (its moment by 1/127 of the leaf's largest), and
  a 0 <-> ±1 flip would move its first Adam update by the whole lr; the
  reference parts from ITSELF so between two XLA optimization levels
  (measured: 1.0e-3 on the CPU). Held: the moments within one quantum,
  all but 1 + ``FLIP_SHARE`` of each leaf's elements within
  ``MOMENT_RTOL``; the parameters within lr + ``PARAM_TOL``, all but as
  many within ``PARAM_TOL`` (measured: 6e-8, no flip past it); the
  residuals likewise within one quantum;
* the MoE's balance loss is the reference's global one, not the mean of
  the ranks' own (which differs from it);
* ``make_compressed_psum`` with a different gradient and residual on each
  rank, against the reference's ``shard_map`` ``cpsum`` over ("data",) at
  2 and 4 ranks and over ("pod", "data") on a 2 x 2 mesh: the mean within
  one f32 ulp of the quantum, each rank's residual likewise;
* each rank's state is its shard (bytes at (4, 1) about a quarter);
* a checkpoint saved at world 4 (the (2, 2) step) restores bitwise at
  world 1 (a one-device state) and world 2 (sharded on (2, 1));
* the trainer's restart path under a mesh replays the uninterrupted run's
  losses, and ``Trainer`` keeps its mesh.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import torch_mesh_ranks as ranks
import torch_mesh_ref as ref
from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import reference_leaf
from repro_torch.models.model import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_TOL = 2e-5
MOMENT_RTOL = 1e-5
FLIP_SHARE = 1e-3
METRIC_RTOL = 1e-5
REF_TIMEOUT_S = 300
CASES = [(arch, compress, shape) for arch in ref.ARCHS
         for compress in (None, "int8") for shape in ref.MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    inputs = ref.train_inputs()
    src, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "ref.pkl")
    with open(src, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_ref.py"),
         src, out, "train"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        archs = {a: inputs[a] for a in ref.ARCHS}
        ckpt = os.path.join(tmp, "ckpt")
        cpsum = {k: v for k, v in inputs.items() if isinstance(k, tuple)}
        w4 = ranks.spawn(4, "train_steps", {
            "archs": archs, "meshes": [(4, 1), (2, 2), (1, 4)], "ckpt": ckpt,
            "cpsum": {k: v for k, v in cpsum.items()
                      if int(np.prod(k[0])) == 4}}, os.path.join(tmp, "w4"))
        w2 = ranks.spawn(2, "train_steps", {
            "archs": archs, "meshes": [(2, 1)],
            "cpsum": {k: v for k, v in cpsum.items()
                      if int(np.prod(k[0])) == 2}}, os.path.join(tmp, "w2"))
        resumed = ranks.spawn(2, "resume", {
            "params": inputs["gemma-2b"]["params"], "ckpt": ckpt,
            "tmp": tmp}, os.path.join(tmp, "r2"))
        _, err = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        want = pickle.load(f)
    return {"w4": w4, "w2": w2, "resumed": resumed[0], "ref": want,
            "inputs": inputs, "ckpt": ckpt}


def _port_result(runs, arch, compress, shape):
    world = int(np.prod(shape))
    return runs[f"w{world}"][0][(arch, compress, tuple(shape))]


def _ref_named(arch, tree) -> dict:
    """A reference param-shaped tree -> {port parameter name: array}."""
    from repro_torch.convert import named_to_torch

    return {n: t.numpy() for n, t in named_to_torch(
        ref.f32_smoke(arch), tree).items()}


@pytest.mark.parametrize("arch,compress,shape", CASES,
                         ids=[f"{a}-{c}-{s[0]}x{s[1]}" for a, c, s in CASES])
def test_mesh_step_equals_the_reference_pjit_step(runs, arch, compress,
                                                  shape):
    got = _port_result(runs, arch, compress, shape)
    want = runs["ref"]["train"][(arch, compress, shape)]
    lr = ref.TCFG["lr"]
    groups = [("params", want["params"]), ("opt/mu", want["mu"]),
              ("opt/nu", want["nu"])]
    if compress:
        groups.append(("residuals", want["residuals"]))
    assert got["state"]["opt/step"] == want["step"] == 1
    for prefix, tree in groups:
        named = _ref_named(arch, tree)
        # the largest |value| of each of the reference's (stacked) leaves,
        # whose one scale the port's per-layer tensors share
        tops: dict = {}
        for name, w in named.items():
            leaf = reference_leaf(name)
            tops[leaf] = max(tops.get(leaf, 0.0), float(np.abs(w).max()))
        for name, w in named.items():
            g = got["state"][f"{prefix}/{name}"]
            err = np.abs(g.astype(np.float64) - w)
            top = tops[reference_leaf(name)]
            if prefix == "params":
                tol, bound = PARAM_TOL, lr + PARAM_TOL
            elif prefix == "residuals":     # |r| <= scale / 2
                scale = 2 * top
                tol = MOMENT_RTOL * 127 * scale
                bound = scale * (1 + MOMENT_RTOL) + tol
            else:                           # one quantum: 1/127 of the top
                tol, bound = MOMENT_RTOL * top, top * (1 / 127 + MOMENT_RTOL)
            if compress is None:
                assert err.max() <= tol, (prefix, name, err.max(), tol)
            else:
                assert err.max() <= bound, (prefix, name, err.max(), bound)
                flips = int((err > tol).sum())
                assert flips <= 1 + FLIP_SHARE * err.size, \
                    (prefix, name, flips)
    for key, value in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], float(value),
                                   rtol=METRIC_RTOL, err_msg=key)


@pytest.mark.parametrize("shape", ref.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in ref.MESHES])
def test_moe_balance_loss_is_the_global_one(runs, shape):
    got = _port_result(runs, "qwen3-moe-30b-a3b", None, shape)
    want = float(runs["ref"]["train"][("qwen3-moe-30b-a3b", None, shape)]
                 ["metrics"]["moe_lb_loss"])
    assert got["metrics"]["moe_lb_loss"] == pytest.approx(want, rel=1e-6)
    # the mean of the ranks' own balance losses is another number where
    # the batch is split (on (1, 4) every rank's own batch is the global)
    if shape[0] > 1:
        assert abs(got["per_rank_lb"] - want) > 1e-4 * want


@pytest.mark.parametrize("case", ref.CPSUM_CASES,
                         ids=["data-2", "data-4", "pod-data-2x2"])
def test_compressed_psum_with_distinct_rank_inputs_equals_the_reference(
        runs, case):
    shape, axes = case
    world = int(np.prod(shape))
    want = runs["ref"]["cpsum"][case]
    got = sorted((r[("cpsum", shape, axes)] for r in runs[f"w{world}"]),
                 key=lambda r: r["index"])
    assert [r["index"] for r in got] == list(range(world))
    for name in ("a", "b"):
        rows = want["mean"][name].shape[0] // world
        quantum = np.abs(np.concatenate(
            [runs["inputs"][case]["g"][name]
             + runs["inputs"][case]["r"][name]])).max() / 127
        for i, r in enumerate(got):
            blk = slice(i * rows, (i + 1) * rows)
            np.testing.assert_allclose(r["mean"][name],
                                       want["mean"][name][blk], rtol=0,
                                       atol=quantum * 2 ** -22)
            np.testing.assert_allclose(r["new_r"][name],
                                       want["new_r"][name][blk], rtol=0,
                                       atol=quantum * 2 ** -22)
        # every rank holds the same mean, and its own residual
        assert all(np.array_equal(r["mean"][name], got[0]["mean"][name])
                   for r in got)
        assert not np.array_equal(got[0]["new_r"][name],
                                  got[1]["new_r"][name])


def test_each_rank_holds_its_shard_of_the_state(runs):
    one = _port_result(runs, "gemma-2b", None, (4, 1))
    full = sum(a.nbytes for a in one["state"].values())
    assert 0.2 * full < one["local_bytes"] < 0.4 * full
    two = _port_result(runs, "gemma-2b", None, (2, 1))
    assert 0.45 * full < two["local_bytes"] < 0.6 * full


def test_checkpoint_saved_at_world_4_resumes_at_world_1_and_2(runs):
    saved = _port_result(runs, "gemma-2b", None, (2, 2))["state"]
    at2 = runs["resumed"]["restored"]
    assert at2.keys() == saved.keys()
    assert all(np.array_equal(at2[n], saved[n]) for n in saved)
    # world 1: a one-device state from the same params
    cfg = ref.f32_smoke("gemma-2b")
    like = ranks._fresh_state(cfg, runs["inputs"]["gemma-2b"]["params"],
                              None)
    CheckpointManager(runs["ckpt"]).restore(1, like=like)
    at1 = {n: t.numpy() for n, t in like.tensors().items()}
    assert at1.keys() == saved.keys()
    assert all(np.array_equal(at1[n], saved[n]) for n in saved)
    assert build(cfg).param_spec().keys() == {
        n.split("/", 1)[1] for n in saved if n.startswith("params/")}


def test_the_restart_path_replays_under_a_mesh(runs):
    res = runs["resumed"]
    clean, failed = res["runs"]["clean"], res["runs"]["failed"]
    assert [s for s, _ in clean] == list(range(5))
    # the failed run replays steps 2.. from the step-2 checkpoint
    assert [s for s, _ in failed] == [0, 1, 2, 2, 3, 4]
    assert dict(failed) == pytest.approx(dict(clean), rel=0, abs=0)
    assert res["mesh_kept"]


def test_a_mesh_step_refuses_an_abstract_mesh():
    """An AbstractMesh resolves specs but has no process group."""
    from repro_torch.configs import TrainConfig
    from repro_torch.parallel.sharding import AbstractMesh
    from repro_torch.train.trainer import make_train_step

    api = build(ref.f32_smoke("gemma-2b"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(api, TrainConfig(), mesh=AbstractMesh((2, 1), (
            "data", "model")))
