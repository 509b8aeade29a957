"""The port's kernel regions on its Controller/Campaign spine, on the CPU:
at most 2 builds per (kernel, mode) sweep, one per k on the fallback path,
oracle payload checks, byte-identical campaign stores from both packages
under the deterministic clock, cross-package replay with 0 measured, and the
torn-tail resume."""
import json

import numpy as np
import pytest
import torch

from repro.core import Campaign as RefCampaign
from repro.core import Controller as RefController
from repro.kernels.region import pallas_region as ref_pallas_region
from repro_torch.convert import to_torch
from repro_torch.core import absorption as port_abs
from repro_torch.core.campaign import Campaign, CampaignStore
from repro_torch.core.controller import Controller
from repro_torch.kernels.region import (KERNEL_MODES, pallas_region,
                                        validate_size)

SIZES = {"matmul": {"n": 128}, "spmxv": {"n": 256}, "probe": {"n_steps": 8}}


@pytest.fixture(autouse=True)
def _fresh_port_measure_state():
    port_abs.reset_floor_warnings()
    port_abs.reset_synth_state()
    yield
    port_abs.release_synth_hang()


def _counting_region(kernel, **sizes):
    builds = {"n": 0}
    region = pallas_region(
        kernel, device="cpu",
        trace_hook=lambda: builds.__setitem__("n", builds["n"] + 1), **sizes)
    return region, builds


@pytest.mark.parametrize("kernel", sorted(SIZES))
def test_sweep_builds_at_most_two_per_mode(kernel):
    region, builds = _counting_region(kernel, **SIZES[kernel])
    ctl = Controller(reps=2, compile_once=True)
    before = 0
    for mode in KERNEL_MODES[kernel]:
        res = ctl.run_mode(region, mode, ks=(0, 1, 2, 4, 8, 16))
        assert builds["n"] - before <= 2, f"{kernel}/{mode}"
        before = builds["n"]
        assert len(res.curve.ks) >= 3
        assert res.injection.payload == res.injection.expected > 0


def test_fallback_builds_one_per_k():
    region, builds = _counting_region("probe", n_steps=8)
    ctl = Controller(reps=2, compile_once=False, verify_payload=False,
                     stop_ratio=100.0)
    ctl.run_mode(region, "fp", ks=(0, 2, 4, 8))
    assert builds["n"] >= 4


@pytest.mark.parametrize("kernel", sorted(SIZES))
def test_payload_check_passes_every_mode(kernel):
    region, _ = _counting_region(kernel, **SIZES[kernel])
    for mode in KERNEL_MODES[kernel]:
        rep = region.payload_check(mode, 6)
        assert rep.expected == rep.payload == 6 and rep.ok()


def test_region_names_modes_and_errors_match_the_reference():
    for kernel, sizes in SIZES.items():
        assert pallas_region(kernel, device="cpu", **sizes).name == \
            ref_pallas_region(kernel, backend="interpret", **sizes).name
    assert pallas_region("spmxv", device="cpu", n=256, q=0.5).name == \
        "pallas_spmxv_n256_L16_q0p5"
    region, _ = _counting_region("spmxv", n=256)
    with pytest.raises(ValueError, match="supports noise modes"):
        region.build("mxu", 2)
    with pytest.raises(ValueError, match="unknown pallas kernel"):
        pallas_region("nope", device="cpu")
    with pytest.raises(NotImplementedError, match="queue 2 item 4"):
        pallas_region("attention", device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        validate_size("matmul", 200)


def test_region_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pallas_region("probe", n_steps=8)


def test_region_inputs_are_the_references():
    port = pallas_region("spmxv", device="cpu", n=256, q=0.5)
    ref = ref_pallas_region("spmxv", backend="interpret", n=256, q=0.5)
    for got, want in zip(port.args_for_rt("fp"), ref.args_for_rt("fp")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel,mode", [("matmul", "vmem"), ("matmul", "fp"),
                                         ("probe", "mxu"), ("spmxv", "vmem")])
def test_reference_state_converted_runs_through_the_port(kernel, mode):
    """The reference region's own inputs (for matmul: its PRNGKey operands,
    which the port cannot draw itself), converted with ``to_torch`` and fed
    to the port's ``build_rt`` / ``build`` callables, give the reference's
    outputs."""
    ref = ref_pallas_region(kernel, backend="interpret", **SIZES[kernel])
    port = pallas_region(kernel, device="cpu", **SIZES[kernel])
    args = to_torch([np.asarray(a) for a in ref.args_for_rt(mode)])
    want = ref.build_rt(mode)(np.int32(5), *ref.args_for_rt(mode))
    got = port.build_rt(mode)(5, *args)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)
    static = port.build(mode, 5)(*args)
    for g, st in zip(got, static if isinstance(static, tuple) else (static,)):
        assert torch.equal(g, st)


def test_to_torch_keeps_dtypes_and_makes_contiguous_copies():
    cols = np.arange(24, dtype=np.int32).reshape(4, 6)[:, ::2]
    vals = np.ones((2, 3), np.float32)
    t_cols, t_vals = to_torch((cols, vals))
    assert t_cols.dtype == torch.int32 and t_vals.dtype == torch.float32
    assert t_cols.is_contiguous()
    np.testing.assert_array_equal(t_cols.numpy(), cols)


def _ref_store(path):
    camp = RefCampaign(path, RefController(reps=2))
    camp.characterize(ref_pallas_region("spmxv", backend="interpret", n=256),
                      ["fp", "vmem"])
    camp.store.close()
    return camp.stats


def _port_store(path):
    camp = Campaign(path, Controller(reps=2))
    rep = camp.characterize(pallas_region("spmxv", device="cpu", n=256),
                            ["fp", "vmem"])
    camp.store.close()
    return camp.stats, rep


def test_both_packages_write_byte_identical_stores(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    ref_path, port_path = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    ref_stats = _ref_store(ref_path)
    port_stats, rep = _port_store(port_path)
    assert ref_stats.measured == port_stats.measured > 0
    with open(ref_path, "rb") as f_ref, open(port_path, "rb") as f_port:
        assert f_ref.read() == f_port.read()
    assert all(r.injection.payload == r.injection.expected > 0
               for r in rep.results.values())


def test_each_package_replays_the_others_store(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    ref_path, port_path = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    _ref_store(ref_path)
    _, rep = _port_store(port_path)
    monkeypatch.delenv("REPRO_SYNTH_MEASURE")      # a measurement would show
    port_stats, port_rep = _port_store(ref_path)
    assert port_stats.measured == 0 and port_stats.cached > 0
    assert _ref_store(port_path).measured == 0
    assert port_rep.bottleneck.label == rep.bottleneck.label
    for m in rep.results:
        assert port_rep.results[m].curve.ts == rep.results[m].curve.ts


def test_torn_final_line_resumes_with_one_point_lost(tmp_path, monkeypatch):
    """The reference's torn-tail scenario, deterministic under the synthetic
    clock: a cut "done" line costs nothing, a cut point costs one point."""
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    full = str(tmp_path / "full.jsonl")
    region = pallas_region("probe", device="cpu", n_steps=8)
    ctl = Controller(reps=2, verify_payload=False)
    camp = Campaign(full, ctl)
    n_points = len(camp.sweep_mode(region, "fp").curve.ks)
    camp.store.close()
    lines = open(full, "rb").read().split(b"\n")[:-1]
    assert json.loads(lines[-1])["kind"] == "done"

    cut_done = str(tmp_path / "cut_done.jsonl")
    with open(cut_done, "wb") as f:
        f.write(b"\n".join(lines[:-1]) + b"\n" + lines[-1][:10])
    c2 = Campaign(cut_done, ctl)
    assert not c2.store.is_done(region.name, "fp")
    c2.sweep_mode(region, "fp")
    c2.store.close()
    assert c2.stats.measured == 0 and c2.stats.cached == n_points

    cut_point = str(tmp_path / "cut_point.jsonl")
    with open(cut_point, "wb") as f:
        f.write(b"\n".join(lines[:-2]) + b"\n" + lines[-2][:10])
    c3 = Campaign(cut_point, ctl)
    c3.sweep_mode(region, "fp")
    c3.store.close()
    assert c3.stats.measured == 1 and c3.stats.cached == n_points - 1
    c4 = Campaign(cut_point, ctl)
    c4.sweep_mode(region, "fp")
    c4.store.close()
    assert c4.stats.measured == 0


def test_store_refuses_corruption_and_segmented_layouts(tmp_path):
    from repro_torch.core.campaign import CampaignStoreError

    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "sens", "region": "r", "mode": "m", "value": 1}\n'
                   "garbage\n"
                   '{"kind": "sens", "region": "r", "mode": "m", "value": 2}\n')
    with pytest.raises(CampaignStoreError, match="corrupt"):
        CampaignStore(str(bad))
    (tmp_path / "seg.segments").mkdir()
    with pytest.raises(CampaignStoreError, match="segmented"):
        CampaignStore(str(tmp_path / "seg.jsonl"))
    with pytest.raises(FileNotFoundError):
        CampaignStore(str(tmp_path / "missing.jsonl"), readonly=True)


def test_run_and_shards_cover_the_grid(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")
    regions = [pallas_region("probe", device="cpu", n_steps=n) for n in (4, 8)]
    shards = []
    for i in range(2):
        camp = Campaign(str(tmp_path / f"w{i}.jsonl"), Controller(reps=2))
        shards.append(camp.measure_shard(regions, ["fp", "vmem"], index=i,
                                         count=2))
        camp.store.close()
    assert sorted(k for s in shards for k in s) == sorted(
        (r.name, m) for r in regions for m in ("fp", "vmem"))
    camp = Campaign(str(tmp_path / "all.jsonl"), Controller(reps=2))
    reports = camp.run(regions, ["fp", "vmem"])
    camp.store.close()
    assert set(reports) == {r.name for r in regions}
    for name, rep in reports.items():
        for (r, m), res in ((k, v) for s in shards for k, v in s.items()):
            if r == name:
                assert rep.results[m].curve.ts == res.curve.ts
