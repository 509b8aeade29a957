"""The port's graph-level noise modes (``repro_torch.core.noise``) on the
CPU, through their kernels' plain versions, against the reference's
(``repro.core.noise``):

* each mode's ``pattern_cost`` equals the reference's at equal
  ``NoiseScale`` and ``HardwareConfig`` (the reference's own TPU and CXL
  configs handed to both);
* ``apply`` and ``apply_rt`` at k in {0, 1, 5, 8} on the reference's state
  (converted with ``convert.noise_state_to_torch``): new states bitwise
  equal; the aux, an f32 sum of the state taken in another order than
  ``jnp.sum``'s, to 1e-6 of the sum of the terms' magnitudes (the bound of
  a reordered sum whose terms cancel: against the sum itself, rtol 1e-6
  fails for vmem_ld's 4,096 signed terms); the chase's int32 aux exactly;
  static k equal to run-time k for k >= 1;
* the ICI modes' no-mesh branch equals the reference's, and a mesh is
  refused;
* the registry has the reference's eight modes and targets.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CXL_MEM, TPU_V5E, TPU_V5P
from repro.core import noise as ref_noise
from repro_torch.configs.base import H100_CXL_DDR, H100_SXM, HardwareConfig
from repro_torch.convert import noise_state_to_torch
from repro_torch.core import noise as port_noise

SCALE = dict(hbm_mib=1, chase_len=1 << 12, ici_kib=4)
MODES = ("fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream", "hbm_latency",
         "ici_allreduce", "ici_allgather", "ici_a2a")
KS = (0, 1, 5, 8)


def _np_state(state):
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in state.items()}


@pytest.fixture(scope="module")
def modes():
    """name -> (reference mode, port mode, reference state, port state)."""
    ref_modes = ref_noise.make_modes(ref_noise.NoiseScale(**SCALE))
    port_modes = port_noise.make_modes(port_noise.NoiseScale(**SCALE),
                                       device="cpu")
    out = {}
    for i, name in enumerate(MODES):
        rs = ref_modes[name].make_state(jax.random.PRNGKey(i))
        out[name] = (ref_modes[name], port_modes[name], rs,
                     noise_state_to_torch(name, _np_state(rs)))
    return out


def _assert_state(got: dict, want: dict, what: str):
    assert tuple(got) == tuple(want), what
    for key in want:
        w = want[key] if isinstance(want[key], tuple) else (want[key],)
        g = got[key] if isinstance(got[key], tuple) else (got[key],)
        assert len(g) == len(w), (what, key)
        for gi, wi in zip(g, w):
            wn = np.asarray(wi)
            if wn.dtype.name == "bfloat16":
                wn = wn.astype(np.float32)
                gi = gi.to(torch.float32)
            np.testing.assert_array_equal(gi.numpy(), wn,
                                          err_msg=f"{what} state[{key}]")


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("static", (True, False), ids=("apply", "apply_rt"))
@pytest.mark.parametrize("name", MODES)
def test_apply_matches_the_reference(modes, name, static, k):
    ref, port, rs, ps = modes[name]
    rfn = ref.apply if static else ref.apply_rt
    pfn = port.apply if static else port.apply_rt
    raux, rstate = rfn(rs, k)
    paux, pstate = pfn(ps, k)
    _assert_state(pstate, _np_state(rstate), f"{name} k={k}")
    if name == "hbm_latency":
        assert paux.dtype == torch.int32 and int(paux) == int(raux)
        return
    if (name in ("fp_add32", "vmem_ld", "ici_allreduce") and static
            and k == 0):
        assert float(paux) == float(raux) == 0.0
        return
    assert abs(float(paux) - float(raux)) <= 1e-6 * _magnitude(name, rstate)


def _magnitude(name: str, rstate: dict) -> float:
    """The sum of |term| over the f32 sum the mode's aux takes."""
    if name in ("ici_allgather", "ici_a2a", "ici_allreduce"):
        return float(np.abs(np.asarray(rstate["v"], np.float32)).sum())
    terms = {"fp_add32": "accs", "vmem_ld": "accs", "hbm_stream": "acc",
             "mxu_fma128": "m"}[name]
    vals = rstate[terms] if isinstance(rstate[terms], tuple) \
        else (rstate[terms],)
    return float(sum(np.abs(np.asarray(v).astype(np.float32)).sum()
                     for v in vals))


@pytest.mark.parametrize("name", MODES)
def test_static_k_is_runtime_k(modes, name):
    """For k >= 1 the static and run-time paths emit the same patterns:
    states and aux bitwise equal (k=0 differs by contract for fp_add32 and
    vmem_ld: the static aux is a literal 0)."""
    _, port, _, ps = modes[name]
    for k in (1, 5, 8):
        sa, ss = port.apply(ps, k)
        ra, rs = port.apply_rt(ps, k)
        assert torch.equal(sa, ra), (name, k)
        for key in ss:
            a = ss[key] if isinstance(ss[key], tuple) else (ss[key],)
            b = rs[key] if isinstance(rs[key], tuple) else (rs[key],)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (name, k)
    zero, _ = port.apply(ps, 0)
    if name in ("fp_add32", "vmem_ld"):
        assert float(zero) == 0.0


@pytest.mark.parametrize("name", MODES)
def test_inputs_are_left_as_they_were(modes, name):
    _, port, _, ps = modes[name]
    before = {k: (tuple(t.clone() for t in v) if isinstance(v, tuple)
                  else v.clone()) for k, v in ps.items()}
    port.apply_rt(ps, 5)
    port.apply(ps, 5)
    for key, v in before.items():
        a = v if isinstance(v, tuple) else (v,)
        b = ps[key] if isinstance(ps[key], tuple) else (ps[key],)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (name, key)


@pytest.mark.parametrize("name", MODES)
def test_plain_route_is_the_cpu_route(modes, name):
    """``plain=True`` (what chip_smoke.py holds the kernels against) is, on
    the CPU, the route a CPU state takes anyway."""
    _, port, _, ps = modes[name]
    for apply in (port.apply, port.apply_rt):
        for k in (0, 5):
            aux, state = apply(ps, k)
            paux, pstate = apply(ps, k, plain=True)
            assert torch.equal(aux, paux), (name, k)
            for key in state:
                a = state[key] if isinstance(state[key], tuple) \
                    else (state[key],)
                b = pstate[key] if isinstance(pstate[key], tuple) \
                    else (pstate[key],)
                assert all(torch.equal(x, y) for x, y in zip(a, b)), key


def test_fresh_calls_leave_the_last_calls_lines(modes):
    """The timing calls of the device-memory modes: the chase goes on where
    the last call stopped (two calls of 3 hops are one of 6); hbm_stream's
    second call reads from a base STREAM_BASE_STEP tiles on (mod half the
    tiles), its first from the buffer's start; the others are apply_rt."""
    from repro_torch.bench.studies import STREAM_BASE_STEP, fresh_calls

    _, port, _, ps = modes["hbm_latency"]
    call = fresh_calls("hbm_latency", port, ps)
    call(3)
    assert int(call(3)) == int(port.apply_rt(ps, 6)[0])
    _, port, _, ps = modes["hbm_stream"]
    call = fresh_calls("hbm_stream", port, ps)
    first, second = call(2), call(2)
    tile = ps["acc"].shape[0]
    base = STREAM_BASE_STEP % (ps["buf"].shape[0] // tile // 2)
    assert base > 0
    assert torch.equal(first, port.apply_rt(ps, 2)[0])
    assert torch.equal(second, port.apply_rt(
        dict(ps, buf=ps["buf"][base * tile:]), 2)[0])
    assert not torch.equal(first, second)
    _, port, _, ps = modes["fp_add32"]
    assert torch.equal(fresh_calls("fp_add32", port, ps)(5),
                       port.apply_rt(ps, 5)[0])


HWS = {"tpu_v5e": TPU_V5E, "tpu_v5p": TPU_V5P, "cxl": CXL_MEM}


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("scale", ({}, SCALE,
                                   dict(vpu_rows=16, mxu_dim=64,
                                        hbm_tile_rows=128, ici_kib=64)),
                         ids=("default", "test", "other"))
def test_pattern_costs_equal_the_references(hw, scale):
    ref_modes = ref_noise.make_modes(ref_noise.NoiseScale(**scale))
    port_modes = port_noise.make_modes(port_noise.NoiseScale(**scale),
                                       device="cpu")
    ref_hw = HWS[hw]
    port_hw = HardwareConfig(**dataclasses.asdict(ref_hw))
    for name in MODES:
        want = ref_modes[name].pattern_cost(ref_hw)
        got = port_modes[name].pattern_cost(port_hw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.time_on(port_hw) == want.time_on(ref_hw), name


def test_registry_is_the_references():
    ref_modes = ref_noise.make_modes()
    port_modes = port_noise.make_modes(device="cpu")
    assert list(port_modes) == list(ref_modes) == list(MODES)
    for name in MODES:
        assert port_modes[name].target == ref_modes[name].target
        assert port_modes[name].apply_rt is not None
    assert port_noise.PAPER_ALIASES == ref_noise.PAPER_ALIASES
    assert port_noise.N_CHAINS == ref_noise.N_CHAINS
    assert port_noise.NOISE_SCOPE == ref_noise.NOISE_SCOPE
    assert port_noise.NoiseScale() == port_noise.NoiseScale(
        **dataclasses.asdict(ref_noise.NoiseScale()))


def test_card_scale_takes_buffers_beyond_the_l2():
    """On the card hbm_stream's buffer and the chase table are 256 MiB
    each; on the CPU the reference's sizes."""
    card = port_noise.default_scale("cuda")
    assert card.hbm_mib == 256 and card.chase_len * 4 == 256 << 20
    assert port_noise.default_scale("cpu") == port_noise.NoiseScale()
    assert dataclasses.replace(card, hbm_mib=64, chase_len=1 << 22) \
        == port_noise.NoiseScale()


@pytest.mark.parametrize("name", ("ici_allreduce", "ici_allgather",
                                  "ici_a2a"))
def test_ici_modes_refuse_a_mesh(name):
    """The collectives run over a DeviceMesh's process group
    (``tests/test_torch_ici_mesh.py``); a mesh with the axis but no process
    group (an ``AbstractMesh``) is refused, not degraded silently, while a
    mesh without the axis takes the no-mesh branch, as the reference's."""
    from repro_torch.parallel.sharding import AbstractMesh

    scale = port_noise.NoiseScale(**SCALE)
    with pytest.raises(ValueError, match="DeviceMesh"):
        port_noise.make_modes(scale, device="cpu",
                              mesh=AbstractMesh((2,), ("model",)))
    port = port_noise.make_modes(scale, device="cpu",
                                 mesh=AbstractMesh((2,), ("data",)))[name]
    plain = port_noise.make_modes(scale, device="cpu")[name]
    state = port.make_state(torch.Generator().manual_seed(0))
    for apply, want in ((port.apply, plain.apply),
                        (port.apply_rt, plain.apply_rt)):
        assert torch.equal(apply(state, 2)[0], want(state, 2)[0])


def test_states_are_made_on_the_cpu_from_a_generator():
    port_modes = port_noise.make_modes(port_noise.NoiseScale(**SCALE),
                                       device="cpu")
    a = port_modes["hbm_latency"].make_state(torch.Generator().manual_seed(3))
    b = port_modes["hbm_latency"].make_state(torch.Generator().manual_seed(3))
    assert torch.equal(a["table"], b["table"]) and int(a["idx"]) == int(b["idx"])
    table = a["table"].long()
    idx, seen = int(a["idx"]), set()
    for _ in range(table.shape[0]):      # a single cycle through every entry
        seen.add(idx)
        idx = int(table[idx])
    assert len(seen) == table.shape[0] and idx == int(a["idx"])
    m = port_modes["mxu_fma128"].make_state(None)
    assert m["m"].dtype == torch.bfloat16
    assert torch.equal(m["c"], torch.eye(128, dtype=torch.bfloat16))


def test_noise_state_conversion_checks_keys():
    with pytest.raises(ValueError, match="keys"):
        noise_state_to_torch("fp_add32", {"c": np.zeros((8, 128))})


def test_h100_configs():
    """The port's HardwareConfig has the reference's fields in order, so
    pred records match field for field; its defaults are the H100 SXM."""
    from repro.configs.base import HardwareConfig as RefHW

    assert [f.name for f in dataclasses.fields(HardwareConfig)] \
        == [f.name for f in dataclasses.fields(RefHW)]
    assert H100_SXM == HardwareConfig()
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw) == (67e12, 3.35e12)
    assert H100_SXM.hbm_latency_s == 340.75e-9
    assert (H100_CXL_DDR.hbm_bw, H100_CXL_DDR.hbm_latency_s) \
        == (CXL_MEM.hbm_bw, CXL_MEM.hbm_latency_s)
    assert H100_CXL_DDR.peak_flops == H100_SXM.peak_flops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these kernels there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", MODES)
def test_cuda_graph_kernels_against_reference(card, modes, name):
    """On the card: each mode's static and run-time kernels at k=5 on the
    reference's state, the state bitwise the reference's."""
    ref, port, rs, _ = modes[name]
    ps = noise_state_to_torch(name, _np_state(rs), device=card)
    for static in (True, False):
        aux, state = (port.apply if static else port.apply_rt)(ps, 5)
        torch.cuda.synchronize()
        want = (ref.apply if static else ref.apply_rt)(rs, 5)
        _assert_state({k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                           else v.cpu()) for k, v in state.items()},
                      _np_state(want[1]), f"{name} cuda")
