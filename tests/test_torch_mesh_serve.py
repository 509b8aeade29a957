"""The per-rank prefill and decode on a mesh (``serve/mesh.py``) against
the reference's ``launch.steps.prefill_cell`` and ``decode_cell``
programs on the CPU.

The port runs on 2 and 4 ``gloo`` ranks (``tests/torch_mesh_ranks.py``),
the reference in one JAX subprocess with four forced host devices
(``tests/torch_mesh_ref.py``), both at the same time, from the same
inputs (the reference's f32 smoke params from PRNGKey(0), a prompt of
64 x 32 tokens, a cache of 32 positions filled with N(0, 0.25) values,
decode tokens and position 9), on a (2, 1), (1, 2), (2, 2) and (1, 4)
(data, model) mesh (the attention, dense MLP and vocabulary computed
split over ``model`` where it is 2 or 4, the logits gathered at the end),
for gemma-2b (its one KV head: the cache's sequence split over
``model``), qwen3-moe-30b-a3b (the MoE's dispatch groups:
dp in the prefill, the global batch in the decode; at a capacity factor
of 0.5, so that pairs are dropped and a rank routing only its own rows
would drop others) and mamba2-780m (the ``ssm_heads`` cache over
``model``, a new state each step):

* each rank's prefill logits are the reference's rows of that rank;
* each rank's decode logits likewise, and each of its shards of the
  updated cache is the same shard of the reference's updated cache.

Tolerance: ``RTOL`` / ``ATOL`` (f32 sums in another order; measured: at
most 6.0e-6 absolute, 3.8e-6 of the largest value, over every case).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import torch_mesh_ranks as ranks
import torch_mesh_ref as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
REF_TIMEOUT_S = 300
CASES = [(arch, shape) for arch in ref.SERVE_ARCHS
         for shape in ref.SERVE_MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_serve"))
    inputs = ref.serve_inputs()
    src, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "ref.pkl")
    with open(src, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_ref.py"),
         src, out, "serve"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        common = {"archs": inputs, "capacity": ref.SERVE_CAPACITY}
        w2 = ranks.spawn(2, "serve_steps", dict(
            common, meshes=[(2, 1), (1, 2)]), os.path.join(tmp, "w2"))
        w4 = ranks.spawn(4, "serve_steps", dict(
            common, meshes=[(2, 2), (1, 4)]), os.path.join(tmp, "w4"))
        _, err = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        want = pickle.load(f)["serve"]
    return {2: w2, 4: w4, "ref": want}


def _ranks(runs, arch, shape):
    world = int(np.prod(shape))
    return [r[(arch, tuple(shape))] for r in runs[world]]


def _ref_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_ref_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
def test_mesh_prefill_equals_the_reference_rows(runs, arch, shape):
    want = runs["ref"][(arch, shape)]["prefill"]
    got = _ranks(runs, arch, shape)
    for r in got:
        assert r["prefill"].shape == (len(r["rows"]), want.shape[-1])
        np.testing.assert_allclose(r["prefill"], want[r["rows"]],
                                   rtol=RTOL, atol=ATOL)
    # every row is some rank's
    assert sorted({int(i) for r in got for i in r["rows"]}) == \
        list(range(want.shape[0]))


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
def test_mesh_decode_equals_the_reference_shards(runs, arch, shape):
    want = runs["ref"][(arch, shape)]
    cache = _ref_leaves(want["cache"])
    for r in _ranks(runs, arch, shape):
        np.testing.assert_allclose(r["decode"], want["decode"][r["rows"]],
                                   rtol=RTOL, atol=ATOL)
        assert r["cache"].keys() == cache.keys()
        for name, local in r["cache"].items():
            mine = cache[name].reshape(-1)[r["where"][name]]
            assert local.shape == mine.shape, name
            np.testing.assert_allclose(local, mine, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_the_decode_cache_is_held_sharded(runs):
    """On (2, 2) each rank holds a quarter of gemma-2b's KV cache: half
    its rows (data) and half its positions (model)."""
    full = _ref_leaves(runs["ref"][("gemma-2b", (2, 2))]["cache"])
    for r in _ranks(runs, "gemma-2b", (2, 2)):
        for name, local in r["cache"].items():
            assert local.size * 4 == full[name].size, name
