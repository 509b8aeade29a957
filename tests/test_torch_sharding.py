"""The port's parallel layer (``repro_torch.parallel.sharding``,
``launch/mesh.py``, the models' ``param_spec``/``cache_spec``) against the
reference's on the CPU:

* every case of the reference's own resolve tests, on the port's
  ``AbstractMesh`` (no process group);
* ``resolve_tree`` over every architecture's ``param_spec()`` at its full
  config's shapes on ``SINGLE_POD`` and ``MULTI_POD`` equal to the
  reference's, less the stacked layer axis: the reference stacks each
  per-layer leaf on a leading (L, ...) axis named None, the port holds one
  module a layer, so the port's ``layers.i.<leaf>`` takes the reference's
  spec of that leaf without its first entry (shapes from the reference's
  ``eval_shape``, a layer's slice for a stacked leaf; the port's weights
  are laid out as the reference's); the key set is the port's
  ``named_parameters`` (at the smoke config);
* ``cache_spec()`` equal to the reference's tree, resolved equal on the
  reference's full-size cache shapes, and the port's caches shaped as the
  reference's (smoke);
* ``make_mesh_from_config`` and ``make_production_mesh`` with too few
  ranks raise the reference's ``ValueError`` messages;
* the serving engine scatters a sequential prefill along the
  ``cache_batch`` axis of ``cache_spec`` and leaves a leaf without one
  alone (its tokens against the reference's engine:
  ``tests/test_torch_serve.py``);
* on four ``gloo`` ranks: ``local_shard`` equal to DTensor's
  ``distribute_tensor`` under ``placements``, ``gather_shard`` its
  inverse, and the flattened (pod, data) group.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

import torch_mesh_ranks as ranks
from repro import compat
from repro import configs as ref_configs
from repro.configs.base import MULTI_POD as REF_MULTI
from repro.configs.base import SINGLE_POD as REF_SINGLE
from repro.launch.mesh import make_production_mesh as ref_production_mesh
from repro.models.model import build as ref_build
from repro.parallel.sharding import make_mesh_from_config as ref_make_mesh
from repro.parallel.sharding import resolve as ref_resolve
from repro.parallel.sharding import resolve_tree as ref_resolve_tree
from repro_torch import configs
from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.convert import STACKED_TREES
from repro_torch.launch.mesh import make_production_mesh, mesh_config
from repro_torch.models.model import build
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (LOGICAL_RULES, AbstractMesh, P,
                                           resolve, resolve_tree)
from repro_torch.serve.engine import ServeEngine

ARCHS = tuple(a.replace("_", "-") for a in ref_configs.ARCHS)


@pytest.fixture(scope="module")
def mesh():
    return AbstractMesh((16, 16), ("data", "model"))


def _tuple(spec):
    return tuple(spec)


def test_rules_and_meshes_equal_the_reference():
    from repro.parallel.sharding import LOGICAL_RULES as REF_RULES

    assert LOGICAL_RULES == REF_RULES
    assert (SINGLE_POD.shape, SINGLE_POD.axes) == (REF_SINGLE.shape,
                                                   REF_SINGLE.axes)
    assert (MULTI_POD.shape, MULTI_POD.axes) == (REF_MULTI.shape,
                                                 REF_MULTI.axes)
    assert mesh_config() is SINGLE_POD
    assert mesh_config(multi_pod=True) is MULTI_POD


def test_resolve_basic(mesh):
    assert resolve(("batch", None, None), (256, 4096, 2048), mesh) == \
        P("data")
    assert resolve(("fsdp", "ff"), (2048, 16384), mesh) == P("data", "model")
    assert resolve((None, "vocab"), (2048, 32768), mesh) == P(None, "model")
    ref = compat.abstract_mesh((16, 16), ("data", "model"))
    assert _tuple(resolve((None, "vocab"), (2048, 32768), mesh)) == \
        _tuple(ref_resolve((None, "vocab"), (2048, 32768), ref))


def test_resolve_divisibility_fallback(mesh):
    assert resolve(("fsdp", "kv_heads", None), (2048, 1, 256), mesh) == \
        P("data")
    assert resolve(("experts", "fsdp", "expert_ff"), (8, 6144, 16384),
                   mesh) == P(None, "data", "model")
    assert resolve(("experts", "fsdp", "expert_ff"), (128, 2048, 768),
                   mesh) == P("model", "data")


def test_resolve_batch_prefix():
    mesh3 = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert resolve(("batch", None), (256, 4096), mesh3) == P(("pod", "data"))
    assert resolve(("batch", None), (1, 4096), mesh3) == P()
    # a truncated multi-axis rule: a one-axis tuple, which P (as the
    # installed JAX's PartitionSpec) normalizes to the axis name
    assert resolve(("batch", None), (2, 4096), mesh3) == P(("pod",))
    assert resolve(("batch", None), (2, 4096), mesh3) == P("pod")
    ref3 = compat.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    for dims in ((256, 4096), (1, 4096), (2, 4096)):
        assert _tuple(resolve(("batch", None), dims, mesh3)) == \
            _tuple(ref_resolve(("batch", None), dims, ref3))


def test_resolve_no_double_use(mesh):
    spec = resolve(("heads", "ff"), (48, 16384), mesh)
    assert spec == P("model", None) or spec == P("model")


def test_resolve_without_a_mesh_replicates_and_constrain_is_a_no_op():
    assert resolve(("batch", "heads")) == P()
    x = torch.zeros(4, 8)
    assert sh.constrain(x, "batch", "heads") is x
    with sh.use_mesh(AbstractMesh((2, 2), ("data", "model"))):
        assert resolve(("batch", "heads"), (4, 8)) == P("data", "model")
        assert sh.constrain(x, "batch", "heads") is x
    assert sh.active_mesh() is None


def _ref_names(tree, prefix=""):
    """{port parameter name: reference leaf path} of a reference param
    tree (stacked subtrees expand to one name a layer)."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_ref_names(value, path + "."))
        else:
            out[path] = path
    return out


def _leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _port_key(path: str, i):
    head, _, rest = path.partition(".")
    return f"{head}.{i}.{rest}" if i is not None else path


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_resolves_as_the_reference_less_the_stacked_axis(arch):
    rapi = ref_build(ref_configs.get_config(arch))
    api = build(configs.get_config(arch))
    shapes = jax.eval_shape(rapi.init, jax.random.PRNGKey(0))
    ref_spec = rapi.param_spec()
    port_spec = api.param_spec()
    # the key set is the port module's (a smoke instance, the same tree)
    smoke = build(configs.get_smoke_config(arch))
    assert list(smoke.param_spec()) == [
        n for n, _ in smoke.init(0, "cpu").named_parameters()]
    cfg = api.cfg
    want_names = set()
    for path in _ref_names(ref_spec):
        head = path.split(".")[0]
        if head in STACKED_TREES:
            n = cfg.enc_layers if head == "enc_layers" else cfg.n_layers
            want_names.update(_port_key(path, i) for i in range(n))
        else:
            want_names.add(path)
    assert set(port_spec) == want_names
    for rmesh, mesh in (
            (compat.abstract_mesh((16, 16), ("data", "model")),
             AbstractMesh(SINGLE_POD.shape, SINGLE_POD.axes)),
            (compat.abstract_mesh((2, 16, 16), ("pod", "data", "model")),
             AbstractMesh(MULTI_POD.shape, MULTI_POD.axes))):
        ref = ref_resolve_tree(ref_spec, shapes, rmesh)
        for path in _ref_names(ref_spec):
            stacked = path.split(".")[0] in STACKED_TREES
            want = _tuple(_leaf(ref, path))
            shape = _leaf(shapes, path).shape
            if stacked:
                want, shape = want[1:], shape[1:]
            name = _port_key(path, 0 if stacked else None)
            got = resolve(port_spec[name], shape, mesh)
            assert _tuple(got) == want, (arch, name, got, want)
        # resolve_tree over the port's flat tree, on a layer's shapes
        port_shapes = {}
        for path in _ref_names(ref_spec):
            stacked = path.split(".")[0] in STACKED_TREES
            shape = _leaf(shapes, path).shape
            if stacked:
                n = cfg.enc_layers if path.startswith("enc_") \
                    else cfg.n_layers
                for i in range(n):
                    port_shapes[_port_key(path, i)] = shape[1:]
            else:
                port_shapes[path] = shape
        tree = resolve_tree(port_spec, port_shapes, mesh)
        assert set(tree) == set(port_spec)
        assert all(tree[n] == resolve(port_spec[n], port_shapes[n], mesh)
                   for n in tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_equals_the_reference(arch):
    rapi = ref_build(ref_configs.get_config(arch))
    api = build(configs.get_config(arch))
    assert api.cache_spec() == rapi.cache_spec()
    cfg = api.cfg
    batch = {"tokens": jax.ShapeDtypeStruct((128, 1), np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = jax.ShapeDtypeStruct(
            (128, cfg.enc_frames, cfg.d_model), np.float32)
    shapes = jax.eval_shape(
        lambda p, b: rapi.decode_init(p, dict(b, max_seq=4096)),
        jax.eval_shape(rapi.init, jax.random.PRNGKey(0)), batch)
    for rmesh, mesh in (
            (compat.abstract_mesh((16, 16), ("data", "model")),
             AbstractMesh(SINGLE_POD.shape, SINGLE_POD.axes)),
            (compat.abstract_mesh((2, 16, 16), ("pod", "data", "model")),
             AbstractMesh(MULTI_POD.shape, MULTI_POD.axes))):
        want = ref_resolve_tree(rapi.cache_spec(), shapes, rmesh)
        got = resolve_tree(api.cache_spec(), shapes, mesh)
        assert jax.tree.map(_tuple, got, is_leaf=lambda x: isinstance(
            x, P)) == jax.tree.map(_tuple, want, is_leaf=lambda x: isinstance(
                x, RefP))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_caches_are_shaped_as_the_reference(arch):
    rcfg = ref_configs.get_smoke_config(arch)
    rapi, api = ref_build(rcfg), build(configs.get_smoke_config(arch))
    params = api.init(0, "cpu")
    batch = {"tokens": torch.zeros((4, 1), dtype=torch.int32),
             "max_seq": 32}
    rbatch = {"tokens": jax.ShapeDtypeStruct((4, 1), np.int32)}
    if rcfg.family == "encdec":
        batch["frames"] = torch.zeros((4, rcfg.enc_frames, rcfg.d_model))
        rbatch["frames"] = jax.ShapeDtypeStruct(
            (4, rcfg.enc_frames, rcfg.d_model), np.float32)
    cache = api.decode_init(params, batch)
    want = jax.eval_shape(
        lambda p, b: rapi.decode_init(p, dict(b, max_seq=32)),
        jax.eval_shape(rapi.init, jax.random.PRNGKey(0)), rbatch)
    got = jax.tree.map(lambda t: tuple(t.shape), cache)
    assert got == jax.tree.map(lambda s: tuple(s.shape), want)
    # every leaf's rank is its spec's
    spec = api.cache_spec()
    for group, leaves in cache.items():
        for name, t in leaves.items():
            assert t.ndim == len(spec[group][name])


def test_too_few_devices_raise_the_reference_errors():
    cfg = MeshConfig((16, 16), ("data", "model"))
    with pytest.raises(ValueError) as port:
        sh.make_mesh_from_config(cfg)
    with pytest.raises(ValueError) as ref:
        ref_make_mesh(REF_SINGLE, devices=jax.devices()[:1])
    # the same message up to the hint after it (the reference's names its
    # dry run's XLA flag, the port's the launcher)
    assert str(port.value).split(" (start")[0] == \
        str(ref.value).split(" (dryrun")[0] == \
        "mesh (16, 16) needs 256 devices, have 1"
    with pytest.raises(ValueError) as port:
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError) as ref:
        ref_production_mesh(multi_pod=True)
    n = jax.device_count()
    assert str(port.value) == str(ref.value).replace(
        f"devices {n} ", "devices 1 ")


def test_the_engine_scatters_along_the_declared_batch_axis():
    """A sequential prefill writes each leaf's slot along its
    "cache_batch" axis from ``cache_spec``; a leaf without one (a ring's
    shared ``kpos``) is left alone."""
    api = build(configs.get_smoke_config("mamba2_780m"))
    eng = ServeEngine(api, api.init(0, "cpu"), n_slots=3, max_seq=16)
    big = {"kv": {"k": torch.zeros(2, 3, 4), "kpos": torch.zeros(5)}}
    small = {"kv": {"k": torch.ones(2, 1, 4), "kpos": torch.ones(5)}}
    spec = {"kv": {"k": (None, "cache_batch", None),
                   "kpos": (None, "cache_seq")}}
    eng._scatter_slot(big, small, spec, 2)
    assert big["kv"]["k"][:, 2].eq(1).all() and \
        big["kv"]["k"][:, :2].eq(0).all()
    assert big["kv"]["kpos"].eq(0).all()
    for arch in ("mamba2_780m", "zamba2_1p2b"):
        spec = build(configs.get_smoke_config(arch)).cache_spec()
        assert all(lg.index("cache_batch") == 1
                   for leaves in spec.values() for lg in leaves.values())


def test_layouts_on_four_gloo_ranks(tmp_path):
    out = ranks.spawn(4, "layouts", None, str(tmp_path))
    for r, res in enumerate(out):
        assert res["dtensor_equal"], (r, res)
        assert res["gathered_equal"], (r, res)
        assert res["pod_data_group"] == res["want_pod_data_group"]
    assert sorted(o["coordinate"] for o in out) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
