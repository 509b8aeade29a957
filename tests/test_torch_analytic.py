"""The port's analytic saturation model (``repro_torch.core.analytic``), its
``AnalyticCampaign`` and the ``table1``/``table4`` studies on the CPU,
against the reference's:

* ``predict_absorption``, ``predict_curve``, ``predict_time``,
  ``pattern_deltas`` and ``compare_memory_systems`` equal the reference's
  for the same ``StepTerms`` and ``HardwareConfig`` values (the reference's
  ``TPU_V5E``, ``TPU_V5P`` and ``CXL_MEM`` handed to both, and the port's
  H100 points) — exactly: both are the same float arithmetic;
* ``pred`` records are byte-identical between the two packages' stores and
  replay with 0 computed;
* ``python -m repro_torch.bench table1|table4 --device cpu --store-dir D``
  exits 0 and replays with 0 measured (``pred`` records included).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs.base import CXL_MEM, TPU_V5E, TPU_V5P
from repro.core import analytic as ref_an
from repro.core import noise as ref_noise
from repro.core.campaign import AnalyticCampaign as RefAnalytic
from repro_torch.bench import studies
from repro_torch.configs.base import H100_CXL_DDR, H100_SXM, HardwareConfig
from repro_torch.core import analytic as port_an
from repro_torch.core.absorption import DEFAULT_KS
from repro_torch.core import noise as port_noise
from repro_torch.core.campaign import AnalyticCampaign, CampaignStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("fp_add32", "mxu_fma128", "vmem_ld", "hbm_stream", "hbm_latency",
         "ici_allreduce", "ici_allgather", "ici_a2a")
REF_HWS = {"tpu_v5e": TPU_V5E, "tpu_v5p": TPU_V5P, "cxl": CXL_MEM}
PORT_HWS = {"h100_sxm": H100_SXM, "h100_cxl_ddr": H100_CXL_DDR}
TERMS = {
    "compute": dict(compute=2e-3, memory=1e-4),
    "memory": dict(compute=1e-5, memory=3e-3, latency=1e-5),
    "latency": dict(compute=1e-6, memory=1e-6, latency=4e-3),
    "ici": dict(compute=1e-4, memory=1e-4, ici=2e-3),
    "balanced": dict(compute=1e-3, memory=1e-3, ici=1e-3, latency=1e-3),
}


def _hw_pair(name):
    """(reference HardwareConfig, port HardwareConfig) with equal values."""
    if name in REF_HWS:
        ref = REF_HWS[name]
        return ref, HardwareConfig(**dataclasses.asdict(ref))
    port = PORT_HWS[name]
    from repro.configs.base import HardwareConfig as RefHW

    return RefHW(**dataclasses.asdict(port)), port


@pytest.fixture(scope="module")
def mode_pairs():
    ref = ref_noise.make_modes()
    port = port_noise.make_modes(device="cpu")
    return {m: (ref[m], port[m]) for m in MODES}


@pytest.mark.parametrize("alpha", (1.0, 0.5, 0.0))
@pytest.mark.parametrize("terms", sorted(TERMS))
@pytest.mark.parametrize("hw", sorted(REF_HWS) + sorted(PORT_HWS))
def test_predict_absorption_is_the_references(mode_pairs, hw, terms, alpha):
    ref_hw, port_hw = _hw_pair(hw)
    rt, pt = ref_an.StepTerms(**TERMS[terms]), port_an.StepTerms(**TERMS[terms])
    for name, (rmode, pmode) in mode_pairs.items():
        assert port_an.pattern_deltas(pmode, port_hw) \
            == ref_an.pattern_deltas(rmode, ref_hw)
        want = ref_an.predict_absorption(rt, rmode, ref_hw, alpha=alpha)
        got = port_an.predict_absorption(pt, pmode, port_hw, alpha=alpha)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        ks = (0, 1, 7, 100, 10_000)
        np.testing.assert_array_equal(
            port_an.predict_curve(pt, pmode, port_hw, ks, alpha=alpha),
            ref_an.predict_curve(rt, rmode, ref_hw, ks, alpha=alpha))


@pytest.mark.parametrize("terms", sorted(TERMS))
def test_step_terms_are_the_references(terms):
    rt, pt = ref_an.StepTerms(**TERMS[terms]), port_an.StepTerms(**TERMS[terms])
    assert pt.as_dict() == rt.as_dict()
    assert (pt.dominant, pt.bound(), pt.bound(0.3)) \
        == (rt.dominant, rt.bound(), rt.bound(0.3))
    assert port_an.StepTerms.from_dict(pt.as_dict()) == pt
    assert port_an.RESOURCES == ref_an.RESOURCES


def test_compare_memory_systems_is_the_references(mode_pairs):
    names = ("tpu_v5e", "cxl", "h100_sxm", "h100_cxl_ddr")
    ref_hws, port_hws = zip(*(_hw_pair(n) for n in names))
    terms = {n: TERMS[t] for n, t in zip(names, ("memory", "latency",
                                                 "balanced", "compute"))}
    want = ref_an.compare_memory_systems(
        {n: ref_an.StepTerms(**t) for n, t in terms.items()},
        {m: r for m, (r, _) in mode_pairs.items()},
        dict(zip(names, ref_hws)))
    got = port_an.compare_memory_systems(
        {n: port_an.StepTerms(**t) for n, t in terms.items()},
        {m: p for m, (_, p) in mode_pairs.items()},
        dict(zip(names, port_hws)))
    assert got == want


@pytest.mark.parametrize("hw", ("tpu_v5e", "cxl", "h100_sxm"))
def test_pred_records_are_the_references_and_replay(tmp_path, mode_pairs, hw):
    ref_hw, port_hw = _hw_pair(hw)
    modes = ("fp_add32", "hbm_stream", "hbm_latency")
    ref_path, port_path = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    ref = RefAnalytic(str(ref_path), hw=ref_hw)
    port = AnalyticCampaign(str(port_path), hw=port_hw)
    for region, terms in (("r_mem", "memory"), ("r_lat", "latency")):
        ref.characterize(region, ref_an.StepTerms(**TERMS[terms]),
                         {m: mode_pairs[m][0] for m in modes})
        rep = port.characterize(region, port_an.StepTerms(**TERMS[terms]),
                                {m: mode_pairs[m][1] for m in modes})
        assert rep.body_size == 0 and rep.bottleneck.label
    ref.store.close()
    port.store.close()
    assert port_path.read_bytes() == ref_path.read_bytes()
    again = AnalyticCampaign(str(port_path), hw=port_hw)
    rep = again.characterize("r_mem", port_an.StepTerms(**TERMS["memory"]),
                             {m: mode_pairs[m][1] for m in modes})
    assert again.stats.measured == 0 and again.stats.cached > 0
    assert {m: r.fit.k1 for m, r in rep.results.items()} == {
        m: ref_an.predict_absorption(ref_an.StepTerms(**TERMS["memory"]),
                                     mode_pairs[m][0], ref_hw).k1
        for m in modes}
    # another HardwareConfig supersedes: computed again
    other = AnalyticCampaign(str(port_path), hw=H100_CXL_DDR)
    other.predict_mode("r_mem", port_an.StepTerms(**TERMS["memory"]),
                       mode_pairs["fp_add32"][1])
    assert other.stats.measured > 0
    assert ("r_mem", "fp_add32") in CampaignStore(str(port_path),
                                                  readonly=True).preds


def test_table4_terms_and_collapse():
    """Table 4's model at the H100's and the DDR class's figures: compute
    at the H100 SXM's FP32 peak; the q=0 stream is memory-bound; random
    gathers make latency dominant."""
    hbm = studies.T4_MEMS["hbm_like"]
    t0 = studies.spmxv_terms(0.0, *hbm)
    assert t0.compute == 2 * studies.T4_N * studies.T4_NNZ / 67e12
    assert t0.dominant == "memory" and t0.latency == 0.0
    t5 = studies.spmxv_terms(0.5, *hbm)
    assert t5.dominant == "latency" and t5.memory > t0.memory
    assert studies.T4_MEMS["ddr_like"] == (256e9, 64, 90e-9)


def test_table1_kernel_terms_model_fig5s_shapes():
    sz = studies.FIG5_SIZES["cuda"]
    terms = studies.kernel_terms(H100_SXM, sz)
    n = sz["stream_n"]
    assert terms["stream"].memory == 12 * n / 3.35e12
    assert terms["stream"].dominant == "memory"
    hops = sz["lat_iter"] * 8
    assert terms["lat_mem_rd"].latency == hops * 340.75e-9
    assert terms["lat_mem_rd"].dominant == "latency"
    assert terms["haccmk"].dominant == "compute"
    assert terms["haccmk"].compute == (sz["hacc_width"] * sz["hacc_iter"]
                                       * 48 / 67e12)


def _bench(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.bench", *args],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 REPRO_SYNTH_MEASURE="1e-3"),
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("study", ("table1", "table4"))
def test_study_cli_replays_with_zero_measured(tmp_path, study):
    """Under the deterministic clock: a first run measures (sweeps, pred
    records), a second replays everything (--expect-no-measure)."""
    store, out = str(tmp_path / "st"), str(tmp_path / "out")
    first = _bench(study, "--device", "cpu", "--store-dir", store, "--out",
                   out)
    assert first.returncode == 0, first.stdout + first.stderr
    name = studies.STUDIES[study][0]
    res = json.load(open(os.path.join(out, f"{name}.json")))
    assert res["points"]["measured"] > 0
    again = _bench(study, "--device", "cpu", "--store-dir", store, "--out",
                   out, "--expect-no-measure")
    assert again.returncode == 0, again.stdout + again.stderr
    res2 = json.load(open(os.path.join(out, f"{name}.json")))
    assert res2["points"]["measured"] == 0
    assert res2["points"]["replayed"] > 0
    if study == "table4":
        assert isinstance(res["hbm_collapse"], bool)
        assert set(res["rows"]) == {"0.0", "0.25", "0.5"}
        assert res2["rows"] == res["rows"]
        preds = CampaignStore(os.path.join(store, "table4_spmxv.jsonl"),
                              readonly=True).preds
        assert len(preds) == 6
    else:
        rows = res["rows"]
        assert set(rows) == {"cpu(measured)", "h100_sxm(analytic)",
                             "h100_cxl_ddr(analytic)"}
        assert res2["rows"] == rows
        assert set(res["pattern_cost"]) == set(MODES)
        for row in res["pattern_cost"].values():
            assert row["model_s"] == max(row["model"].values())


def test_table1_replays_fig5s_sweeps(tmp_path):
    """Table 1's measured row is fig5's regions at fig5's sizes: after
    fig5 it measures only its predictions."""
    store, out = str(tmp_path / "st"), str(tmp_path / "out")
    assert _bench("fig5", "--device", "cpu", "--store-dir", store, "--out",
                  out).returncode == 0
    res = _bench("table1", "--device", "cpu", "--store-dir", store, "--out",
                 out)
    assert res.returncode == 0, res.stdout + res.stderr
    got = json.load(open(os.path.join(out, "table1_systems.json")))
    fig5 = json.load(open(os.path.join(out, "fig5_hwchar.json")))
    n_preds = 2 * 3 * 3 * len(DEFAULT_KS)   # 2 HardwareConfigs, 3 loops, 3 modes
    assert got["points"]["measured"] == n_preds
    assert got["rows"]["cpu(measured)"]["stream"]["fp"] \
        == fig5["rows"]["stream"]["abs"]["fp_add"]
