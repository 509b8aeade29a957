"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline.terms`` on the CPU:

* ``model_flops`` equals the reference's for every arch x shape;
* the ring factors equal the reference's ``_WIRE_FACTOR`` at group sizes
  2, 4, 16 and 256;
* the dot FLOPs traced from the smoke configs' train, prefill and decode
  programs on one rank (``launch/steps.py`` on meta, a one-rank fake
  group) equal the reference's ``parsed_dot_flops`` of the same programs
  compiled on one CPU device (its own ``hlo.parse`` on
  ``jax.jit(...).lower(...).compile().as_text()``), within ``DOT_RTOL``:
  both count 2·prod(out)·prod(contract) of every product the program
  runs, and the only difference measured is one router-sized product
  (2·T·D·E) of qwen3-moe's train step that the reference's optimized
  HLO does not hold as a dot (5.5e-4 of the step);
* the traffic model on hand-made op sequences: a view costs 0, an
  in-place write into a cache costs its slice, an AdamW ``*_`` update its
  leaf, a gather the rows it fetches, any other op its operands and
  result once; a collective no HBM bytes and its ring factor on the wire;
* the compute term charges each product at its unit's peak.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as rc
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import TrainConfig as RefTrain
from repro.hlo.parse import find_entry, nesting_multipliers, parse_module
from repro.models.model import build as ref_build
from repro.roofline import terms as ref_terms
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.trainer import TrainState as RefState
from repro.train.trainer import make_train_step as ref_train_step
from repro_torch import configs
from repro_torch.configs import MeshConfig, ShapeConfig
from repro_torch.configs.base import H100_SXM
from repro_torch.launch import steps
from repro_torch.launch.dryrun import trace_program
from repro_torch.models.model import build
from repro_torch.parallel.fake import fake_world
from repro_torch.parallel.sharding import make_mesh_from_config
from repro_torch.roofline import terms
from repro_torch.roofline.trace import OpTrace

DOT_RTOL = 2e-3
B, S = 4, 64
CELLS = [(a, s) for a in configs.ARCHS for s in configs.SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equal_the_references(arch, shape):
    assert terms.model_flops(configs.get_config(arch),
                             configs.SHAPES[shape]) == \
        ref_terms.model_flops(rc.get_config(arch), rc.SHAPES[shape])


@pytest.mark.parametrize("g", (2, 4, 16, 256))
def test_ring_factors_equal_the_references(g):
    assert terms.WIRE_FACTOR.keys() == ref_terms._WIRE_FACTOR.keys()
    for kind, f in terms.WIRE_FACTOR.items():
        assert f(g) == ref_terms._WIRE_FACTOR[kind](g), kind


def _ref_dot_flops(fn, *args) -> float:
    text = jax.jit(fn).lower(*args).compile().as_text()
    comps = parse_module(text)
    mults = nesting_multipliers(comps, find_entry(comps, text))
    return ref_terms.parsed_dot_flops(comps, mults)


def _ref_programs(arch):
    api = ref_build(rc.get_smoke_config(arch))
    params = api.init(jax.random.PRNGKey(0))
    batch = api.dummy_batch(RefShape("t", "train", S, B))
    state = RefState(params=params, opt=ref_adamw_init(params),
                     residuals=None)
    cache = api.decode_init(params, {"tokens": jnp.zeros((B, 1), jnp.int32),
                                     "max_seq": S})
    return {
        "train": (ref_train_step(api, RefTrain()), state, batch),
        "prefill": (lambda p, b: api.forward(p, b)[0][:, -1, :], params,
                    {"tokens": batch["tokens"]}),
        "decode": (api.decode_step, params, cache,
                   jnp.zeros((B, 1), jnp.int32), jnp.int32(5)),
    }


def _port_programs(api, mesh):
    return {
        "train": steps.train_cell(api, ShapeConfig("t", "train", S, B), mesh,
                                  microbatches=1, scan_group=1),
        "prefill": steps.prefill_cell(api, ShapeConfig("p", "prefill", S, B),
                                      mesh),
        "decode": steps.decode_cell(api, ShapeConfig("d", "decode", S, B),
                                    mesh),
    }


@pytest.mark.parametrize("arch", ("gemma-2b", "qwen3-moe-30b-a3b",
                                  "mamba2-780m"))
def test_traced_dot_flops_equal_the_references_hlo(arch):
    want = {k: _ref_dot_flops(*v) for k, v in _ref_programs(arch).items()}
    api = build(configs.get_smoke_config(arch))
    with fake_world(1):
        mesh = make_mesh_from_config(MeshConfig((1, 1), ("data", "model")),
                                     "cpu")
        got = {k: terms.dot_flops(trace_program(p)[0].ops)
               for k, p in _port_programs(api, mesh).items()}
    for kind in want:
        assert want[kind] > 0
        assert got[kind] == pytest.approx(want[kind], rel=DOT_RTOL), kind


def _ops(fn, *args):
    with OpTrace() as tr:
        fn(*args)
    return tr.ops


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_a_view_costs_nothing():
    x = _meta(8, 16)
    ops = _ops(lambda: (x.view(16, 8), x.t(), x[2:4], x[:, None].expand(
        8, 3, 16), x.detach(), x.reshape(128)))
    assert ops and all(terms.op_traffic(r) == 0 for r in ops)


def test_an_in_place_cache_write_costs_its_slice():
    cache = _meta(4, 2, 1024, 64)                    # (L, B, S, hd)
    new = _meta(2, 1, 64)
    idx = torch.empty((1,), dtype=torch.long, device="meta")
    ops = _ops(lambda: cache[1].index_copy_(1, idx, new))
    wrote = [r for r in ops if r.inplace]
    assert [r.name for r in wrote] == ["aten.index_copy_.default"]
    # the source read, its slice of the cache written, the index read
    assert terms.op_traffic(wrote[0]) == 2 * new.numel() * 4 + 8
    # copy_ into a slice: the source read, the slice written
    ops = _ops(lambda: cache[:, :, 5:6].copy_(_meta(4, 2, 1, 64)))
    copy = [r for r in ops if r.name == "aten.copy_.default"]
    assert terms.op_traffic(copy[0]) == 2 * 4 * 2 * 64 * 4


def test_an_adamw_update_costs_its_leaf():
    flat = _meta(1000)
    leaf, g = flat[100:200], _meta(100)
    ops = _ops(lambda: (leaf.mul_(0.9), leaf.add_(g, alpha=0.1)))
    assert [terms.op_traffic(r) for r in ops] == [2 * 400, 3 * 400]


def test_a_gather_reads_the_rows_it_fetches():
    table = _meta(50_000, 64, dtype=torch.bfloat16)
    tokens = torch.empty((2, 8), dtype=torch.long, device="meta")
    ops = _ops(lambda: table[tokens])
    rows = 2 * 8 * 64 * 2
    assert sum(terms.op_traffic(r) for r in ops) == 2 * rows + 2 * 8 * 8


def test_other_ops_read_operands_and_write_results_once():
    a, b = _meta(32, 64), _meta(64)
    ops = _ops(lambda: a + b)
    assert [terms.op_traffic(r) for r in ops] == [(2 * 32 * 64 + 64) * 4]
    # an expanded operand reads its storage once
    ops = _ops(lambda: a * b.expand(32, 64).contiguous())
    assert sum(terms.op_traffic(r) for r in ops) == \
        (64 + 32 * 64) * 4 + 3 * 32 * 64 * 4


def test_a_collective_moves_wire_bytes_not_hbm_bytes():
    import torch.distributed as dist

    with fake_world(16):
        x = _meta(1024)
        pieces = [torch.empty_like(x) for _ in range(16)]
        ops = _ops(lambda: (dist.all_gather(pieces, x), dist.all_reduce(x)))
    coll = [r for r in ops if r.name.startswith("c10d.")]
    assert [r.group_size for r in coll] == [16, 16]
    assert all(terms.op_traffic(r) == 0 for r in coll)
    wire, by = terms.collective_wire_bytes(coll, default_group=1)
    assert by == {"all-gather": 16 * 4096 * 15 / 16,
                  "all-reduce": 4096 * 2 * 15 / 16}
    assert wire == sum(by.values())


def test_the_compute_term_charges_each_product_at_its_units_peak():
    a16, b16 = _meta(256, 512, dtype=torch.bfloat16), _meta(
        512, 128, dtype=torch.bfloat16)
    a32, b32 = a16.float(), b16.float()
    ops = [r for r in _ops(lambda: (a16 @ b16, a32 @ b32))
           if r.name == "aten.mm.default"]
    f = 2 * 256 * 512 * 128
    assert [terms.product_flops(r) for r in ops] == [f, f]
    flops, secs = terms.compute_seconds(ops, H100_SXM)
    assert flops == 2 * f
    assert secs == pytest.approx(f / 989.4e12 + f / H100_SXM.peak_flops)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tf = [r for r in _ops(lambda: a32 @ b32)
              if r.name == "aten.mm.default"]
    finally:
        torch.set_float32_matmul_precision(prev)
    assert terms.product_unit(tf[0]) == "tf32"
    assert terms.compute_seconds(tf, H100_SXM)[1] == \
        pytest.approx(f / 494.7e12)


def test_the_report_keeps_the_references_fields():
    ref_fields = [f.name for f in dataclasses.fields(ref_terms.RooflineReport)]
    port_fields = [f.name for f in dataclasses.fields(terms.RooflineReport)]
    assert port_fields[:len(ref_fields)] == ref_fields
