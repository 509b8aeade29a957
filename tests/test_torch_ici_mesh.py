"""The ICI noise modes' mesh branch (``core/noise.py``) against the
reference's ``shard_map`` result on the CPU.

The port runs on 2 and 4 ``gloo`` ranks (``tests/torch_mesh_ranks.py``),
the reference in one JAX subprocess with four forced host devices
(``tests/torch_mesh_ref.py``), both from the same global v (256 floats,
``NoiseScale(ici_kib=1)``), k = 3, over the "model" axis of a (2,) and a
(4,) mesh:

* ``ici_allreduce``: every rank's output equal to the reference's
  replicated output, its aux equal to the global sum;
* ``ici_allgather`` and ``ici_a2a``: rank i's output equal to block i of
  the reference's ``P("model")`` output, the aux to its global sum; their
  states are each rank's shard of v;

each in static and run-time k, within ``RTOL`` (the all-reduce sums in
gloo's order, the reference in XLA's), the aux within ``RTOL`` of the sum
of |v| (a sum of the same values in another order). On a ("data",) mesh, which lacks the axis, every mode
takes the no-mesh branch, equal to the reference's fallback; the active
mesh (``use_mesh``) stands in for an explicit one.
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
RTOL = 1e-6
MODES = ("ici_allreduce", "ici_allgather", "ici_a2a")
FORMS = ("static", "rt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ici_mesh"))
    inputs = ref.ici_inputs()
    src, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "ref.pkl")
    with open(src, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_ref.py"),
         src, out, "ici"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        args = {"v": inputs["v"], "ici_kib": ref.ICI_SCALE.ici_kib}
        port = {w: ranks.spawn(w, "ici", args, os.path.join(tmp, f"w{w}"))
                for w in (2, 4)}
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(out, "rb") as f:
        want = pickle.load(f)["ici"]
    return port, want, inputs["v"]


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", MODES)
def test_ici_mode_on_a_mesh_equals_the_reference(runs, name, form, world):
    port, want, v = runs
    w = want[(world, name, form)]
    n = v.size
    for rank, res in enumerate(port[world]):
        got = res[(world, name, form)]
        if name == "ici_allreduce":
            assert got["state_numel"] == n
            np.testing.assert_allclose(got["v"], w["v"], rtol=RTOL)
        else:
            assert got["state_numel"] == n // world
            blk = slice(rank * n // world, (rank + 1) * n // world)
            np.testing.assert_allclose(got["v"], w["v"][blk], rtol=RTOL)
        np.testing.assert_allclose(got["aux"], w["aux"], rtol=RTOL,
                                   atol=RTOL * np.abs(w["v"]).sum())
    # the mean of replicated copies is v again; the sharded modes move it
    assert np.allclose(w["v"], v) == (name == "ici_allreduce")
    assert port[world][0][(world, name, "static")]["v"].tobytes() == \
        port[world][0][(world, name, "rt")]["v"].tobytes()


@pytest.mark.parametrize("name", MODES)
def test_a_mesh_without_the_axis_takes_the_fallback(runs, name):
    port, want, v = runs
    for world in (2, 4):
        for res in port[world]:
            for form in FORMS:
                got = res[("no_axis", name, form)]
                w = want[("no_axis", name, form)]
                np.testing.assert_array_equal(got["v"], v)   # unchanged
                np.testing.assert_allclose(got["aux"], w["aux"], rtol=RTOL,
                                           atol=RTOL * np.abs(v).sum())
                assert got["state_numel"] == v.size


def test_the_active_mesh_stands_in_for_an_explicit_one(runs):
    port, want, v = runs
    for world in (2, 4):
        for res in port[world]:
            # one all-reduce of a replicated v, times 1/size: v again
            assert res[(world, "active")] == pytest.approx(float(v.sum()),
                                                           rel=RTOL)
        # without the axis: the fallback's aux, the same on every rank
        assert len({r[("no_axis", "active")] for r in port[world]}) == 1
