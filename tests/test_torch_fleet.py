"""The port's fleet spine (plan -> run_worker -> merge) on the CPU, beside
the reference's: kernel families and their errors, the attention region
on the reference's own inputs, plan round-trips and grids, the refused
backends / audit policies / target kinds, a 2-shard fleet against the
single-process campaign and against the reference's fleet store byte for
byte, mock-launcher crash and resume, one subprocess end-to-end run of
``python -m repro_torch.fleet``, and the probe CLI's ``--plan --shard``.

Measurement determinism: REPRO_SYNTH_MEASURE (the deterministic stand-in
clock of both packages), so independently run processes, shards and the two
packages write byte-comparable stores."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fleet.executor import in_process_launcher as ref_in_process
from repro.fleet.executor import run_fleet as ref_run_fleet
from repro.fleet.plan import SweepPlan as RefSweepPlan
from repro.fleet.plan import TargetSpec as RefTargetSpec
from repro.kernels import region as ref_region
from repro_torch.convert import to_torch
from repro_torch.core import absorption as port_abs
from repro_torch.core.campaign import (CampaignStore, compact_store,
                                       merge_stores)
from repro_torch.fleet.executor import (FleetError, FleetState, report_json,
                                        run_fleet, run_worker)
from repro_torch.fleet.launchers import LocalLauncher, MockClusterLauncher
from repro_torch.fleet.plan import PlanError, SweepPlan, TargetSpec
from repro_torch.kernels import region as port_region

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_PROCESS = LocalLauncher(in_process=True)


@pytest.fixture(autouse=True)
def _fresh_port_measure_state():
    port_abs.reset_floor_warnings()
    port_abs.reset_synth_state()
    yield
    port_abs.release_synth_hang()


@pytest.fixture
def synth_measure(monkeypatch):
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")


def _targets(cls, modes, sizes):
    return [cls("pallas", tuple(modes), {"kernel": "probe",
                                         "sizes": list(sizes)})]


def _plan(tmp_path, *, shards=2, modes=("fp", "mxu"), sizes=(8,),
          stem="fleet", launcher=None):
    plan = SweepPlan(name="fleet_probe",
                     store=str(tmp_path / stem / "store.jsonl"),
                     targets=_targets(TargetSpec, modes, sizes), reps=2,
                     shards=shards, backend="cpu", launcher=launcher)
    path = str(tmp_path / f"{stem}_plan.json")
    plan.save(path)
    return plan, path


# ---------------------------------------------------------------------------
# kernel families: names, members and errors equal the reference's
# ---------------------------------------------------------------------------

# tests/test_pallas_region.py's family cases (:142) and region sizes (:26)
FAMILIES = [
    ("matmul", [128, 256], None, {}),
    ("spmxv", [256], [0.0, 0.25, 1.0], {"nnz_per_row": 8}),
    ("attention", [64, 128], None, {"heads": 4}),
    ("attention", [128], None, {"heads": 2, "kv_heads": 2, "bq": 64,
                                "bk": 64}),
    ("probe", [8, 64], None, {}),
]


@pytest.mark.parametrize("kernel,sizes,qs,extra", FAMILIES)
def test_family_names_and_members_match_the_reference(kernel, sizes, qs,
                                                      extra):
    names = port_region.family_names(kernel, sizes, qs=qs, **extra)
    assert names == ref_region.family_names(kernel, sizes, qs=qs, **extra)
    built = port_region.pallas_family(kernel, sizes, qs=qs, device="cpu",
                                      **extra)
    assert [r.name for r in built] == names
    assert port_region.family_params(kernel) == \
        ref_region.family_params(kernel)


@pytest.mark.parametrize("kernel,sizes,qs,common", [
    ("matmul", [128], [0.0], {}),                    # qs outside spmxv
    ("matmul", [129], None, {}),                     # size does not tile
    ("attention", [100], None, {}),                  # seq past one block
    ("nope", [8], None, {}),                         # unknown kernel
    ("matmul", [128], None, {"nnz_per_row": 8}),     # foreign spec param
    ("probe", [8], None, {"causal": True}),
], ids=["qs-scope", "matmul-align", "attention-align", "unknown", "param",
        "probe-param"])
def test_family_errors_match_the_reference(kernel, sizes, qs, common):
    with pytest.raises(ValueError) as want:
        ref_region.check_family_args(kernel, sizes, qs, common)
    with pytest.raises(ValueError) as got:
        port_region.check_family_args(kernel, sizes, qs, common)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got_names:
        port_region.family_names(kernel, sizes, qs=qs, **common)
    assert str(got_names.value) == str(want.value)


def test_family_members_must_not_collide():
    with pytest.raises(ValueError) as want:
        ref_region.pallas_family("probe", [8, 8], backend="interpret")
    with pytest.raises(ValueError) as got:
        port_region.pallas_family("probe", [8, 8], device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the attention region on the reference's own inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fp", "mxu", "vmem"])
def test_attention_region_on_reference_inputs(mode):
    """The reference's ``_attention_spec`` arguments (its PRNGKey q/k/v,
    which the port cannot draw itself), converted with ``to_torch`` and fed
    to the port region's runtime-k and static-k callables, give the
    reference region's ``out`` and ``nacc`` (rtol 2e-4 / atol 2e-5: both
    in IEEE f32, summed in another order); the payload check passes."""
    sizes = {"seq": 128, "heads": 4, "kv_heads": 2}
    ref = ref_region.pallas_region("attention", backend="interpret", **sizes)
    port = port_region.pallas_region("attention", device="cpu", **sizes)
    assert port.name == ref.name
    args = to_torch([np.asarray(a) for a in ref.args_for_rt(mode)])
    want = ref.build_rt(mode)(np.int32(5), *ref.args_for_rt(mode))
    got = port.build_rt(mode)(5, *args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)
    static = port.build(mode, 5)(*args)
    assert torch.equal(got[0], static[0]) and torch.equal(got[1], static[1])
    rep = port.payload_check(mode, 6)
    assert rep.payload == rep.expected == 6


def test_attention_region_counts_live_blocks():
    """grid_steps and the fp oracle count live (causal) blocks only; one
    partial holds at most nk of them."""
    region = port_region.pallas_region("attention", device="cpu", seq=256,
                                       heads=2, kv_heads=1)
    spec = port_region._attention_spec("cpu", seq=256, heads=2, kv_heads=1)
    assert spec.n_steps == 2 * 10 and spec.steps_per_cta == 4
    assert spec.n_cta == 2 * 4
    # the audit's loop: the most live blocks one CTA walks, not the grid
    assert region.audit_hint["steps"] == spec.steps_per_cta == 4
    assert region.payload_check("fp", 3).ok()


# ---------------------------------------------------------------------------
# SweepPlan: round trip, grid, refusals
# ---------------------------------------------------------------------------

def test_plan_round_trips_and_grids_like_the_reference(tmp_path):
    plan, path = _plan(tmp_path, sizes=(8, 16))
    loaded = SweepPlan.load(path)
    assert loaded.to_dict() == plan.to_dict()
    assert loaded.digest() == plan.digest()
    loaded.reps = 3
    assert loaded.digest() != plan.digest()
    ref = RefSweepPlan(name=plan.name, store=plan.store,
                       targets=_targets(RefTargetSpec, ("fp", "mxu"),
                                        (8, 16)),
                       reps=2, shards=2, backend="cpu")
    assert ref.grid() == plan.grid() == [
        ("pallas_probe_s8", "fp"), ("pallas_probe_s8", "mxu"),
        ("pallas_probe_s16", "fp"), ("pallas_probe_s16", "mxu")]
    # same schema and digest as the reference's for the same plan
    assert ref.to_dict() == plan.to_dict() and ref.digest() == plan.digest()
    assert plan.worker_stores() == ref.worker_stores()
    assert [r.name for r, _ in plan.pairs()] == [n for n, _ in plan.grid()]


@pytest.mark.parametrize("change,match", [
    ({"backend": "auto"}, r"backend 'auto' is not supported; one of "
                          r"\['cuda', 'cpu'\]"),
    ({"backend": "interpret"}, r"\['cuda', 'cpu'\]"),
    ({"backend": "pallas"}, r"\['cuda', 'cpu'\]"),
    ({"backend": "ref"}, r"\['cuda', 'cpu'\]"),
    ({"store_format": "segments"}, "segmented layout is not ported"),
    ({"launcher": {"kind": "ssh", "hosts": []}}, "launcher kind 'ssh'"),
    ({"targets": [TargetSpec("serve", ("fp_add32",),
                             {"arch": "gemma_2b", "slots": 0})]}, "slots"),
    ({"targets": [TargetSpec("serve", ("fp_add32",), {})]}, "arch"),
    ({"targets": [TargetSpec("calibrate", ("fp_add32",), {})]},
     "calibrate targets sweep the loop modes"),
    ({"targets": [TargetSpec("pallas", ("mxu",),
                             {"kernel": "spmxv", "sizes": [256]})]},
     "supports modes"),
], ids=["auto", "interpret", "pallas", "ref", "segments", "ssh",
        "serve-slots", "serve-arch", "calibrate", "mode"])
def test_plan_refusals(tmp_path, change, match):
    plan, _ = _plan(tmp_path)
    for key, value in change.items():
        setattr(plan, key, value)
    with pytest.raises(PlanError, match=match):
        plan.validate()


@pytest.mark.parametrize("audit", ["gate", "warn"])
def test_audit_policies_other_than_off_are_refused(tmp_path, audit,
                                                   synth_measure, capsys,
                                                   monkeypatch):
    """On the cpu backend gate and warn refuse to audit each pair: the plain
    versions carry no compiled noise, so every pair is reported
    unauditable, no build is attempted and no record is written, and the
    fleet measures on (its store stays what an unaudited run writes). An
    unknown policy is refused before anything runs."""
    from repro_torch.kernels import _build

    def no_build(*a, **kw):
        raise AssertionError("the cpu backend must not build")

    monkeypatch.setattr(_build, "static_build", no_build)
    plan, path = _plan(tmp_path)
    res = run_fleet(path, audit=audit, launcher=IN_PROCESS)
    out = capsys.readouterr().out
    assert out.count("UNAUDITABLE") == len(plan.grid())
    assert "cpu backend" in out and res.stats.measured == 0
    assert not CampaignStore(plan.store, readonly=True).audits
    for policy in ("sometimes", ""):
        with pytest.raises(FleetError, match="audit policy"):
            run_worker(plan, audit=policy)
        with pytest.raises(FleetError, match="audit policy"):
            run_fleet(path, resume=True, audit=policy, launcher=IN_PROCESS)


# ---------------------------------------------------------------------------
# the fleet pipeline: spawn -> merge -> classify, resume, crash-heal
# ---------------------------------------------------------------------------

def test_fleet_matches_single_process_and_the_reference_store(
        tmp_path, synth_measure):
    """Two in-process shards merge into a store byte-identical to the
    reference's ``run_fleet`` store of the same plan (the reference under
    backend "interpret"; no record names the framework or the backend, so
    every byte is compared), and classify like one process; a resume
    measures nothing."""
    plan, path = _plan(tmp_path, stem="fan")
    res = run_fleet(path, launcher=IN_PROCESS)
    assert res.launched == [0, 1] and res.stats.measured == 0
    assert {s.status for s in res.state.shards.values()} == {"done"}
    fleet_report = open(plan.report_path(), "rb").read()

    single, single_path = _plan(tmp_path, stem="single", shards=1)
    reports, stats = run_worker(SweepPlan.load(single_path))
    assert stats.measured > 0
    assert open(single.report_path(), "rb").read() == fleet_report
    merged_single = str(tmp_path / "single_merged.jsonl")
    merge_stores(merged_single, [single.store])
    assert open(merged_single, "rb").read() == open(plan.store, "rb").read()

    ref = RefSweepPlan(name=plan.name, store=str(tmp_path / "ref" / "s.jsonl"),
                       targets=_targets(RefTargetSpec, ("fp", "mxu"), (8,)),
                       reps=2, shards=2, backend="interpret")
    ref_path = str(tmp_path / "ref_plan.json")
    ref.save(ref_path)
    ref_run_fleet(ref_path, audit="off", launcher=ref_in_process)
    assert open(ref.store, "rb").read() == open(plan.store, "rb").read()

    res2 = run_fleet(path, resume=True, expect_no_measure=True)
    assert res2.launched == [] and res2.stats.measured == 0
    assert report_json(res2.reports) == report_json(res.reports)
    with pytest.raises(FleetError, match="--resume"):
        run_fleet(path, launcher=IN_PROCESS)


@pytest.mark.parametrize("action,lost", [("crash", 1), ("drop-point", 1)])
def test_mock_crash_and_resume_heal(tmp_path, synth_measure, action, lost):
    """A shard whose store is torn (crash) or lost a promised point is
    relaunched alone on resume, re-measures only what is missing, and the
    fleet then classifies like a clean run."""
    plan, path = _plan(tmp_path, stem=action,
                       launcher={"kind": "mock", "script": {"0": [action]}})
    with pytest.raises(FleetError, match=r"shard\(s\) \[0\]"):
        run_fleet(path)
    state = FleetState.load(plan.fleet_path())
    assert state.shards[0].status == "failed"
    assert state.shards[1].status == "done"
    assert not os.path.exists(plan.store)          # aborted before the merge

    res = run_fleet(path, resume=True)
    assert res.launched == [0]
    wstats = json.load(open(plan.worker_stores()[0] + ".stats.json"))
    assert wstats["measured"] == lost and wstats["cached"] > 0
    assert res.state.shards[0].attempt_log[-1]["host"] == "mock-host-0"

    single, single_path = _plan(tmp_path, stem=action + "_ref", shards=1)
    run_worker(SweepPlan.load(single_path))
    assert open(plan.report_path(), "rb").read() \
        == open(single.report_path(), "rb").read()


def test_mock_launcher_rejects_unknown_actions():
    with pytest.raises(FleetError, match="unknown mock action"):
        MockClusterLauncher({0: ["explode"]})


def test_fleet_cli_subprocess_end_to_end(tmp_path, synth_measure):
    """``python -m repro_torch.fleet plan/run/status --backend cpu``: two
    subprocess shards, merged and classified; the resume measures 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    plan_path, store = str(tmp_path / "p.json"), str(tmp_path / "s.jsonl")

    def fleet(*args):
        return subprocess.run([sys.executable, "-m", "repro_torch.fleet",
                               *args], env=env, capture_output=True,
                              text=True, timeout=300)

    out = fleet("plan", "--out", plan_path, "--pallas", "attention",
                "--sizes", "64", "--modes", "fp,vmem", "--reps", "2",
                "--shards", "2", "--backend", "cpu", "--store", store)
    assert out.returncode == 0, out.stderr
    out = fleet("run", "--plan", plan_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[shard 0/2]" in out.stdout and "[shard 1/2]" in out.stdout
    assert "== merge: merged" in out.stdout
    out = fleet("run", "--plan", plan_path, "--resume", "--expect-no-measure")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[0 points measured," in out.stdout
    out = fleet("status", "--plan", plan_path)
    assert out.returncode == 0 and "2/2 pair(s) complete" in out.stdout
    state = FleetState.load(os.path.splitext(store)[0] + ".fleet.json")
    assert [s.host for s in state.shards.values()] == ["localhost"] * 2


# ---------------------------------------------------------------------------
# probe CLI integration (the worker entry) and the campaign CLI
# ---------------------------------------------------------------------------

def test_probe_plan_shard_and_expect_no_measure(tmp_path, synth_measure,
                                                capsys):
    from repro_torch.launch import probe

    plan, path = _plan(tmp_path, stem="cli", modes=("fp",), sizes=(8, 16))
    res, stats = probe.main(["--plan", path, "--shard", "0/2"])
    assert list(res) == [("pallas_probe_s8", "fp")] and stats.measured > 0
    out = capsys.readouterr().out
    assert "worker store" in out and "points measured" in out
    _, stats = probe.main(["--plan", path, "--shard", "0/2",
                           "--expect-no-measure"])
    assert stats.measured == 0
    with pytest.raises(SystemExit, match="conflicting"):
        probe.main(["--plan", path, "--pallas", "probe"])
    with pytest.raises(SystemExit, match="--device"):
        probe.main(["--plan", path, "--device", "cpu"])
    with pytest.raises(SystemExit, match="shards"):
        probe.main(["--plan", path, "--shard", "0/3"])
    capsys.readouterr()
    reports, _ = probe.main(["--plan", path, "--audit", "gate"])
    out = capsys.readouterr().out
    assert sorted(reports) == ["pallas_probe_s16", "pallas_probe_s8"]
    assert out.count("UNAUDITABLE") == 2 and "cpu backend" in out
    assert not CampaignStore(plan.store, readonly=True).audits
    with pytest.raises(SystemExit):
        probe.main(["--plan", path, "--audit", "sometimes"])


def test_probe_adhoc_attention_runs_through_the_worker(tmp_path,
                                                      synth_measure):
    from repro_torch.launch import probe

    store = str(tmp_path / "attn.jsonl")
    args = ["--pallas", "attention", "--pallas-n", "64", "--modes", "fp",
            "--reps", "2", "--store", store, "--device", "cpu"]
    reports, stats = probe.main(args)
    rep = reports["pallas_attn_b1h2s64d64"]
    assert rep.results["fp"].injection.payload == \
        rep.results["fp"].injection.expected > 0
    assert os.path.exists(os.path.splitext(store)[0] + ".report.json")
    _, stats = probe.main(args + ["--expect-no-measure"])
    assert stats.measured == 0


def test_campaign_cli_merge_inspect_and_compact(tmp_path, synth_measure,
                                                capsys):
    from repro_torch.core.campaign import _cli

    plan, path = _plan(tmp_path, stem="inspect", modes=("fp", "mxu"))
    run_worker(SweepPlan.load(path), index=0, count=2)      # half the grid
    ws = plan.worker_stores()
    assert _cli(["inspect", ws[0], "--plan", path]) == 1
    out = capsys.readouterr().out
    assert "plan 'fleet_probe': 1/2 pair(s) complete" in out
    assert "missing pallas_probe_s8/mxu (absent)" in out
    run_worker(SweepPlan.load(path), index=1, count=2)
    assert _cli(["merge", plan.store, *ws]) == 0
    assert _cli(["inspect", plan.store, "--plan", path]) == 0
    assert "2/2 pair(s) complete" in capsys.readouterr().out
    merged = open(plan.store, "rb").read()
    assert merge_stores(plan.store, [plan.store]).records_in == \
        len(merged.splitlines())
    assert open(plan.store, "rb").read() == merged          # idempotent
    with open(plan.store, "ab") as f:                       # a superseded
        f.write(merged.splitlines()[0] + b"\n")             # duplicate
    st = compact_store(plan.store)
    assert st.records_in == st.records_out + 1
    assert open(plan.store, "rb").read() == merged
    CampaignStore(plan.store, readonly=True)
