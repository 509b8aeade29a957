"""The port's launchers, retry budgets and fleet doctor
(``repro_torch.fleet``): the reference's ``tests/test_launchers.py`` cases
run through the port — the MockClusterLauncher fault paths (scripted crash
-> retried shard heals its torn store and re-measures only the missing
points, final report byte-identical to a clean single-process run;
attempts-exhausted exits nonzero and fleet.json says why), the per-shard
lifetime cap, the fleet doctor's diagnosis, the SSH launcher's host specs,
command construction and documented degrade when ssh is missing, and the
launcher->worker plan-digest handshake — plus a whole ssh round trip
through a stand-in ``ssh``/``scp`` (``subprocess`` monkeypatched: the
"remote" is a directory on this machine), and ``doctor --explain`` beside
the reference's on stores from the same synthetic clock.

Measurement determinism: REPRO_SYNTH_MEASURE (the deterministic stand-in
clock of both packages) makes independently-run shards byte-comparable;
the reference's ``backend="interpret"`` is the port's ``backend="cpu"``."""
import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from repro_torch.core import absorption as port_abs
from repro_torch.fleet import launchers
from repro_torch.core.campaign import host_store, read_store_records
from repro_torch.fleet.executor import (FleetError, FleetState, fleet_doctor,
                                        run_fleet, run_worker)
from repro_torch.fleet.launchers import (MANUAL_RECIPE, HostSpec,
                                         LocalLauncher, MockClusterLauncher,
                                         RetryBudget, SSHLauncher,
                                         load_hosts, resolve_launcher,
                                         tear_store_tail)
from repro_torch.fleet.plan import PlanError, SweepPlan, TargetSpec

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True)
def _fresh_port_measure_state():
    port_abs.reset_floor_warnings()
    port_abs.reset_synth_state()
    yield
    port_abs.release_synth_hang()


@pytest.fixture
def synth_measure(monkeypatch):
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")


def _plan(tmp_path, *, shards=2, modes=("fp", "mxu"), sizes=(8,),
          name="fleet_probe", stem="fleet", launcher=None, retry=None):
    plan = SweepPlan(
        name=name, store=str(tmp_path / stem / "store.jsonl"),
        targets=[TargetSpec("pallas", tuple(modes),
                            {"kernel": "probe", "sizes": list(sizes)})],
        reps=2, shards=shards, backend="cpu",
        launcher=launcher, retry=retry)
    path = str(tmp_path / f"{stem}_plan.json")
    plan.save(path)
    return plan, path


# ---------------------------------------------------------------------------
# RetryBudget
# ---------------------------------------------------------------------------

def test_retry_budget_validation_and_backoff():
    b = RetryBudget(max_attempts=3, backoff=0.5, per_shard_cap=5)
    assert b.delay(1) == 0.0                       # first round: no wait
    assert b.delay(2) == 0.5
    assert b.delay(3) == 1.0                       # doubles per round
    assert RetryBudget.from_dict(None) == RetryBudget()
    assert RetryBudget.from_dict({"max_attempts": 2}).max_attempts == 2
    with pytest.raises(FleetError, match="max_attempts"):
        RetryBudget(max_attempts=0)
    with pytest.raises(FleetError, match="unknown retry setting"):
        RetryBudget.from_dict({"attempts": 2})


# ---------------------------------------------------------------------------
# MockClusterLauncher: the scripted-fault multi-host path on one machine
# ---------------------------------------------------------------------------

def test_mock_crash_retries_heal_and_match_single_process(tmp_path,
                                                          synth_measure):
    """Tentpole acceptance: shard 0's first attempt crashes (torn worker
    store); within ONE run the retry budget re-launches only shard 0, the
    store heals, only the missing point is re-measured, and the final
    report is byte-identical to a clean single-process run."""
    plan, path = _plan(tmp_path, stem="mockcrash",
                       launcher={"kind": "mock", "script": {"0": ["crash"]}},
                       retry={"max_attempts": 2})
    res = run_fleet(path)
    assert res.launched == [0, 1]
    s0 = res.state.shards[0]
    assert s0.attempts == 2
    assert [a["rc"] for a in s0.attempt_log] == [-9, 0]
    assert [a["launcher"] for a in s0.attempt_log] == ["mock", "mock"]
    assert s0.attempt_log[0]["host"] == "mock-host-0"
    heal = s0.attempt_log[1]
    assert heal["measured"] == 1 and heal["cached"] > 0   # healed, not redone
    assert res.state.shards[1].attempts == 1

    single, single_path = _plan(tmp_path, stem="mockcrash_ref", shards=1)
    run_worker(SweepPlan.load(single_path))
    assert open(plan.report_path(), "rb").read() \
        == open(single.report_path(), "rb").read()

    # completed fleet replays free, launching nothing
    res2 = run_fleet(path, resume=True, expect_no_measure=True)
    assert res2.launched == []


def test_mock_attempts_exhausted_exits_nonzero_and_ledger_says_why(
        tmp_path, synth_measure):
    """Satellite: a shard that fails every allowed attempt -> nonzero exit
    through the CLI, and fleet.json records each attempt (launcher, host,
    rc) with status 'failed'."""
    from repro_torch.fleet.cli import main

    plan, path = _plan(tmp_path, stem="mockdead",
                       launcher={"kind": "mock",
                                 "script": {"0": ["dead", "timeout"]}},
                       retry={"max_attempts": 2})
    with pytest.raises(SystemExit) as ei:
        main(["run", "--plan", path])
    assert "did not complete after 2 attempt round" in str(ei.value)
    state = FleetState.load(plan.fleet_path())
    s0 = state.shards[0]
    assert s0.status == "failed"
    assert [a["rc"] for a in s0.attempt_log] == [1, 124]
    # attempts whose worker never ran must not inherit stale heal stats
    assert all(a["measured"] is None and a["cached"] is None
               for a in s0.attempt_log)
    assert state.shards[1].status == "done"


def test_per_shard_cap_marks_shard_exhausted(tmp_path, synth_measure):
    """A shard may not burn the budget forever: once its LIFETIME attempts
    hit per_shard_cap, resume refuses to relaunch it and the ledger says
    'exhausted'."""
    plan, path = _plan(tmp_path, stem="capped",
                       launcher={"kind": "mock",
                                 "script": {"1": ["dead", "dead", "dead"]}},
                       retry={"per_shard_cap": 2})
    with pytest.raises(FleetError, match="did not complete"):
        run_fleet(path)
    # attempt 2 also fails; the cap is now reached, mid-run
    with pytest.raises(FleetError, match="per-shard attempt cap"):
        run_fleet(path, resume=True)
    # a further resume refuses to launch the shard at all
    with pytest.raises(FleetError, match="per-shard attempt cap"):
        run_fleet(path, resume=True)
    state = FleetState.load(plan.fleet_path())
    assert state.shards[1].status == "exhausted"
    assert state.shards[1].attempts == 2
    code, report = fleet_doctor(plan)
    assert code == 1
    assert "attempts exhausted" in report


def test_mock_attempt_ordinals_follow_the_ledger_across_resumes(
        tmp_path, synth_measure):
    """The executor passes LIFETIME attempt ordinals to the launcher, so a
    fault script stays deterministic across --resume runs: attempt 2 in a
    fresh process still reads script[1]."""
    plan, path = _plan(tmp_path, stem="ordinal",
                       launcher={"kind": "mock",
                                 "script": {"0": ["crash", "dead"]}})
    with pytest.raises(FleetError):
        run_fleet(path)                                   # attempt 1: crash
    with pytest.raises(FleetError):
        run_fleet(path, resume=True)                      # attempt 2: dead
    state = FleetState.load(plan.fleet_path())
    log = state.shards[0].attempt_log
    assert [a["rc"] for a in log] == [-9, 1]
    # the crash attempt really ran (stats recorded); the dead attempt must
    # NOT inherit the crash attempt's stale stats file
    assert log[0]["measured"] and log[1]["measured"] is None
    res = run_fleet(path, resume=True)                    # attempt 3: ok
    assert res.launched == [0]


# ---------------------------------------------------------------------------
# fleet doctor: explain WHY a shard is incomplete
# ---------------------------------------------------------------------------

def test_doctor_names_missing_pair_and_k_points(tmp_path, synth_measure):
    """Acceptance: on the pre-retry state after a scripted 'drop-point'
    fault, doctor names the incomplete shard and the exact missing
    (pair, k); after the healing retry it reports COMPLETE."""
    plan, path = _plan(tmp_path, stem="doctor",
                       launcher={"kind": "mock",
                                 "script": {"0": ["drop-point"]}})
    with pytest.raises(FleetError, match=r"shard\(s\) \[0\]"):
        run_fleet(path)
    code, report = fleet_doctor(plan)
    assert code == 1
    assert "shard 0: INCOMPLETE" in report
    assert "missing k(s) [" in report        # the exact missing point named
    assert "shard 1: complete" in report
    assert "rc=-9" in report                 # the attempt history
    # the missing k doctor names is exactly what pair_status reports
    ws = plan.worker_stores()[0]
    from repro_torch.core import CampaignStore
    st = CampaignStore(ws, readonly=True)
    missing = [ps.missing for ps in
               st.grid_status(plan.grid()[0::2]).values() if ps.missing]
    assert missing and str(sorted(missing[0])) in report

    res = run_fleet(path, resume=True, retry=RetryBudget(max_attempts=2))
    assert res.launched == [0]
    wstats = json.load(open(ws + ".stats.json"))
    assert wstats["measured"] == 1           # ONLY the dropped point
    code, report = fleet_doctor(plan)
    assert code == 0 and "COMPLETE" in report


def test_doctor_reports_torn_tail_and_absent_stores(tmp_path, synth_measure):
    plan, path = _plan(tmp_path, stem="docttorn")
    # nothing ran yet: everything absent, verdict INCOMPLETE
    code, report = fleet_doctor(plan)
    assert code == 1
    assert "not created yet" in report and "absent" in report
    # run shard 0 then tear its store like a SIGKILL mid-append
    run_worker(SweepPlan.load(path), index=0, count=2)
    tear_store_tail(plan.worker_stores()[0])
    code, report = fleet_doctor(plan)
    assert code == 1
    assert "torn tail" in report
    assert "in progress" in report           # the done-less pair explained
    valid = read_store_records(plan.worker_stores()[0])[1]
    assert valid < os.path.getsize(plan.worker_stores()[0])


# ---------------------------------------------------------------------------
# SSH launcher: geometry, command construction, documented degrade
# ---------------------------------------------------------------------------

def _hosts_file(tmp_path):
    hosts = {"hosts": [
        {"addr": "alice@n0", "python": "/opt/venv/bin/python",
         "workdir": "/scratch/repro",
         "env": {"PYTHONPATH": "src",
                 # hostile: tries to clobber the handshake digest
                 "REPRO_FLEET_EXPECT_DIGEST": "bogus"}},
        {"addr": "n1"}]}
    path = str(tmp_path / "hosts.json")
    with open(path, "w") as f:
        json.dump(hosts, f)
    return path


def test_load_hosts_and_validation(tmp_path):
    hosts = load_hosts(_hosts_file(tmp_path))
    assert [h.addr for h in hosts] == ["alice@n0", "n1"]
    assert hosts[0].python == "/opt/venv/bin/python"
    assert dict(hosts[0].env)["PYTHONPATH"] == "src"
    assert hosts[1].workdir == "."             # defaults fill in
    with pytest.raises(FleetError, match="addr"):
        HostSpec.from_dict({"python": "python3"})
    with pytest.raises(FleetError, match="unknown key"):
        HostSpec.from_dict({"addr": "n0", "port": 22})
    empty = str(tmp_path / "empty.json")
    with open(empty, "w") as f:
        json.dump([], f)
    with pytest.raises(FleetError, match="non-empty"):
        load_hosts(empty)


def test_ssh_remote_command_carries_handshake_and_geometry(tmp_path,
                                                           monkeypatch):
    plan, path = _plan(tmp_path, stem="sshcmd")
    plan.store = "experiments/campaigns/s.jsonl"   # relative, as ssh needs
    hosts = load_hosts(_hosts_file(tmp_path))
    lch = SSHLauncher(hosts)
    assert lch.host_for(0).addr == "alice@n0"
    assert lch.host_for(3).addr == "n1"            # round-robin ring
    cmd = lch._remote_command(hosts[0], plan, "plan.json", 0)
    assert cmd[:2] == ["ssh", "-o"]
    line = cmd[-1]
    assert "cd /scratch/repro" in line
    # the handshake digest wins over a hosts.json env that tries to set it
    assert f"REPRO_FLEET_EXPECT_DIGEST={plan.digest()}" in line
    assert "REPRO_FLEET_EXPECT_DIGEST=bogus" not in line
    assert "REPRO_FLEET_HOST=alice@n0" in line
    assert "PYTHONPATH=src" in line
    assert "/opt/venv/bin/python -m repro_torch.launch.probe" in line
    assert "--shard 0/2" in line
    # stale remote stats are wiped so a dead attempt can't inherit them
    assert "rm -f " in line and ".stats.json" in line


def test_ssh_degrades_to_manual_recipe_without_ssh(tmp_path, monkeypatch):
    """Satellite of the tentpole: no ssh on PATH -> the launcher refuses
    with the documented manual per-host recipe instead of half-running."""
    plan, path = _plan(tmp_path, stem="sshless")
    lch = SSHLauncher([HostSpec(addr="n0")])
    monkeypatch.setattr("shutil.which", lambda name: None)
    assert not SSHLauncher.available()
    with pytest.raises(FleetError) as ei:
        lch.launch(path, plan, [0])
    assert "manual multi-host recipe" in str(ei.value)
    assert str(ei.value) == MANUAL_RECIPE


def test_ssh_requires_relative_store(tmp_path, monkeypatch):
    plan, path = _plan(tmp_path, stem="sshabs")   # tmp store path: absolute
    lch = SSHLauncher([HostSpec(addr="n0")])
    monkeypatch.setattr("shutil.which", lambda name: f"/usr/bin/{name}")
    with pytest.raises(FleetError, match="RELATIVE"):
        lch.launch(path, plan, [0])


def test_host_store_namespacing():
    name = host_store("a/b.jsonl", "alice@n0")
    assert name.startswith("a/b.halice-n0-") and name.endswith(".jsonl")
    assert host_store("a/b", "n0").startswith("a/b.hn0-")
    assert host_store("a/b", "n0").endswith(".jsonl")
    # stable: the same host always stages under the same name
    assert host_store("a/b.jsonl", "alice@n0") == name


def test_host_store_distinct_hosts_never_collide():
    """Regression: sanitization used to map distinct raw host names (every
    non-alnum char -> '-') onto ONE staging file, so two hosts' pulled
    stores could clobber each other. A short hash of the raw name now keeps
    them apart."""
    a = host_store("a/b.jsonl", "node:1")
    b = host_store("a/b.jsonl", "node-1")
    assert a != b
    assert host_store("s.jsonl", "user@h.x") != host_store("s.jsonl",
                                                           "user-h-x")


# ---------------------------------------------------------------------------
# resolution + plan serialization of launcher/retry
# ---------------------------------------------------------------------------

def test_resolve_launcher_precedence(tmp_path):
    plan, _ = _plan(tmp_path, stem="resolve",
                    launcher={"kind": "mock", "script": {"0": ["crash"]}})
    assert isinstance(resolve_launcher(plan=plan), MockClusterLauncher)
    assert resolve_launcher(plan=plan).script == {0: ("crash",)}
    # an explicit kind beats the plan's spec
    assert isinstance(resolve_launcher("local", plan=plan), LocalLauncher)
    lch = resolve_launcher("mock", plan=plan, mock_script={1: ["dead"]})
    assert lch.script == {1: ("dead",)}
    with pytest.raises(FleetError, match="unknown launcher kind"):
        resolve_launcher("k8s")
    with pytest.raises(FleetError, match="--in-process"):
        resolve_launcher("mock", in_process=True)
    with pytest.raises(FleetError, match="hosts"):
        resolve_launcher("ssh")
    # --hosts/--mock-script must never be silently dropped onto a local
    # launcher (the sweep would run on the wrong hosts / without faults)
    with pytest.raises(FleetError, match="ssh/mock"):
        resolve_launcher(hosts_path="hosts.json")
    with pytest.raises(FleetError, match="ssh/mock"):
        resolve_launcher(mock_script={0: ["crash"]})
    # a bad script is a clean FleetError, not a raw ValueError traceback
    with pytest.raises(FleetError, match="shard indices"):
        MockClusterLauncher({"x": ["ok"]})


def test_plan_serializes_launcher_and_retry_into_digest(tmp_path):
    bare, _ = _plan(tmp_path, stem="bare")
    armed, path = _plan(tmp_path, stem="armed",
                        launcher={"kind": "mock", "script": {"0": ["crash"]}},
                        retry={"max_attempts": 2, "backoff": 0.1})
    # distribution settings are plan identity: the digest pins them
    assert bare.digest() != armed.digest()
    loaded = SweepPlan.load(path)
    assert loaded.launcher == armed.launcher
    assert loaded.retry == armed.retry
    assert loaded.digest() == armed.digest()
    # ...but a plan WITHOUT them keeps its pre-launcher digest bytes
    assert "launcher" not in bare.to_dict() and "retry" not in bare.to_dict()
    with pytest.raises(PlanError, match="launcher kind"):
        _plan(tmp_path, stem="badl", launcher={"kind": "k8s"})
    with pytest.raises(PlanError, match="mock action"):
        _plan(tmp_path, stem="bads",
              launcher={"kind": "mock", "script": {"0": ["explode"]}})
    with pytest.raises(PlanError, match="hosts"):
        _plan(tmp_path, stem="badh", launcher={"kind": "ssh"})
    with pytest.raises(PlanError, match="retry"):
        _plan(tmp_path, stem="badr", retry={"retries": 3})


# ---------------------------------------------------------------------------
# launcher -> worker handshake
# ---------------------------------------------------------------------------

def test_worker_refuses_mismatched_plan_digest(tmp_path, synth_measure,
                                               monkeypatch):
    plan, path = _plan(tmp_path, stem="shake")
    monkeypatch.setenv("REPRO_FLEET_EXPECT_DIGEST", "deadbeef0000")
    with pytest.raises(FleetError, match="handshake"):
        run_worker(SweepPlan.load(path), index=0, count=2)
    monkeypatch.setenv("REPRO_FLEET_EXPECT_DIGEST", plan.digest())
    run_worker(SweepPlan.load(path), index=0, count=2)   # matching: runs


# ---------------------------------------------------------------------------
# CLI round trip: plan flags -> embedded spec -> run/doctor
# ---------------------------------------------------------------------------

def test_cli_plan_run_doctor_with_mock_launcher(tmp_path, synth_measure,
                                                capsys):
    from repro_torch.fleet.cli import main

    out_plan = str(tmp_path / "cli_plan.json")
    store = str(tmp_path / "cli" / "store.jsonl")
    assert main(["plan", "--out", out_plan, "--pallas", "probe",
                 "--sizes", "8", "--modes", "fp", "--reps", "2",
                 "--shards", "2", "--backend", "cpu",
                 "--store", store, "--launcher", "mock",
                 "--mock-script", '{"0": ["crash"]}',
                 "--max-attempts", "2"]) == 0
    plan = SweepPlan.load(out_plan)
    assert plan.launcher == {"kind": "mock", "script": {"0": ["crash"]}}
    assert plan.retry == {"max_attempts": 2}
    # run uses the plan's embedded mock launcher + retry budget: the
    # scripted crash is healed by the in-run retry, rc 0
    assert main(["run", "--plan", out_plan]) == 0
    out = capsys.readouterr().out
    assert "scripted action 'crash'" in out
    assert "round 2/2" in out
    assert main(["doctor", "--plan", out_plan]) == 0
    assert "COMPLETE" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--in-process"):
        main(["run", "--plan", out_plan, "--resume", "--in-process",
              "--launcher", "ssh"])


# ---------------------------------------------------------------------------
# the ssh launcher end to end, through a stand-in ssh and scp
# ---------------------------------------------------------------------------

def _fake_ssh(monkeypatch, remote: str, calls: list):
    """Make ``ssh``/``scp`` exist and run them on this machine: ``ssh -o
    BatchMode=yes HOST LINE`` runs LINE under bash, ``scp ... SRC DST``
    copies with ``HOST:`` stripped (the host's workdir is an absolute
    directory here, so remote paths are local ones)."""
    monkeypatch.setattr(shutil, "which",
                        lambda name: f"/usr/bin/{name}"
                        if name in ("ssh", "scp") else None)

    def local(argv):
        calls.append(list(argv))
        if argv[0] == "ssh":
            return ["bash", "-c", argv[-1]]
        assert argv[0] == "scp", argv
        src, dst = (re.sub(r"^[^:/]+:", "", p) for p in argv[-2:])
        return ["cp", src, dst]

    monkeypatch.setattr(launchers, "subprocess", types.SimpleNamespace(
        PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT,
        run=lambda argv, **kw: subprocess.run(local(argv), **kw),
        Popen=lambda argv, **kw: subprocess.Popen(local(argv), **kw)))
    os.makedirs(remote, exist_ok=True)


def test_ssh_launcher_round_trip_through_a_stand_in_ssh(tmp_path,
                                                        monkeypatch,
                                                        synth_measure):
    """``--launcher ssh``: the plan is pushed to the host's workdir, the
    worker runs there (``python -m repro_torch.launch.probe --plan ...
    --shard 0/1`` under the handshake env), its store is pulled back
    through the per-host staging name, merged and classified like a local
    run's — and a partial store is pushed back before a retry."""
    local = tmp_path / "local"
    local.mkdir()
    monkeypatch.chdir(local)
    remote = str(tmp_path / "remote")
    calls: list = []
    _fake_ssh(monkeypatch, remote, calls)
    hosts = [{"addr": "n0", "python": sys.executable, "workdir": remote,
              "env": {"PYTHONPATH": SRC}}]
    plan = SweepPlan(
        name="ssh_probe", store="st/store.jsonl",
        targets=[TargetSpec("pallas", ("fp", "mxu"),
                            {"kernel": "probe", "sizes": [8]})],
        reps=2, shards=1, backend="cpu",
        launcher={"kind": "ssh", "hosts": hosts})
    path = plan.save("ssh_plan.json")
    res = run_fleet(path)
    assert res.launched == [0]
    s0 = res.state.shards[0]
    assert s0.host == "n0" and s0.attempt_log[0]["launcher"] == "ssh"
    assert s0.attempt_log[0]["measured"] > 0           # stats came back too
    ws = plan.worker_stores()[0]
    assert os.path.exists(os.path.join(remote, ws))    # measured remotely
    assert open(ws, "rb").read() == \
        open(os.path.join(remote, ws), "rb").read()    # pulled back intact
    assert not os.path.exists(host_store(ws, "n0"))    # staging renamed
    line = next(c[-1] for c in calls if c[0] == "ssh" and "probe" in c[-1])
    assert "-m repro_torch.launch.probe --plan ssh_plan.json --shard 0/1" \
        in line and f"REPRO_FLEET_EXPECT_DIGEST={plan.digest()}" in line
    assert set(res.reports) == {"pallas_probe_s8"}

    # a torn worker store (and no merged store yet) goes back to the host,
    # which heals it and re-measures only the torn point
    from repro_torch.core.campaign import remove_store

    remove_store(plan.store)
    tear_store_tail(ws)
    calls.clear()
    res2 = run_fleet(path, resume=True)
    assert res2.launched == [0]
    pushed = [c for c in calls if c[0] == "scp" and c[-2] == ws]
    assert pushed, "the partial store was not pushed back"
    assert res2.state.shards[0].attempt_log[-1]["measured"] == 1


def test_ssh_launch_without_a_host_copy_fails_the_attempt(tmp_path,
                                                          monkeypatch,
                                                          synth_measure):
    """A worker whose store never comes back fails its attempt (rc 255):
    the executor sees the shard still owing, and says so."""
    local = tmp_path / "local"
    local.mkdir()
    monkeypatch.chdir(local)
    calls: list = []
    _fake_ssh(monkeypatch, str(tmp_path / "remote"), calls)
    plan = SweepPlan(
        name="ssh_dead", store="st/store.jsonl",
        targets=[TargetSpec("pallas", ("fp",),
                            {"kernel": "probe", "sizes": [8]})],
        reps=2, shards=1, backend="cpu")
    path = plan.save("plan.json")
    # the host runs "true" instead of python: no worker, no store
    lch = SSHLauncher([HostSpec(addr="n0", python="true",
                                workdir=str(tmp_path / "remote"))])
    out = lch.launch(path, plan, [0])
    assert out[0].rc == 255 and out[0].host == "n0"


# ---------------------------------------------------------------------------
# doctor --explain beside the reference's
# ---------------------------------------------------------------------------

def _explain_sections(report: str) -> dict:
    """{region: (label, fired node, thresholds line)} from a doctor
    --explain report."""
    lines = report.split("\n")
    start = lines.index("== explain: decision path per region")
    thresholds = lines[start + 1].strip()
    out, region = {}, None
    for ln in lines[start + 2:]:
        m = re.match(r"  (\S+): (\S+) \(confidence", ln)
        if m:
            region = m.group(1)
            out[region] = [m.group(2), None, thresholds]
        m = re.match(r"    path \[(\S+)\]: (.*) \(\* = fired\)", ln)
        if m:
            fired = [n[:-1] for n in m.group(2).split(" -> ")
                     if n.endswith("*")]
            out[region][1] = (m.group(1), tuple(fired))
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["default", "calibrated"])
def test_doctor_explain_names_the_references_nodes_and_thresholds(
        tmp_path, synth_measure, calibrated):
    """One plan run by each package on the synthetic clock: ``doctor
    --explain`` names, for every region, the same label, the same fired
    strategy node and the same thresholds with their provenance (the paper
    defaults, or a calib record's)."""
    from repro.core import CampaignStore as RefCampaignStore
    from repro.fleet.executor import fleet_doctor as ref_fleet_doctor
    from repro.fleet.executor import in_process_launcher as ref_in_process
    from repro.fleet.executor import run_fleet as ref_run_fleet
    from repro.fleet.plan import SweepPlan as RefSweepPlan
    from repro.fleet.plan import TargetSpec as RefTargetSpec
    from repro_torch.core import CampaignStore

    def build(cls, spec_cls, backend, stem):
        plan = cls(name="explain", store=str(tmp_path / stem / "s.jsonl"),
                   targets=[spec_cls("pallas", ("fp", "mxu", "vmem"),
                                     {"kernel": "probe",
                                      "sizes": [8, 64]})],
                   reps=2, shards=2, backend=backend)
        return plan, plan.save(str(tmp_path / f"{stem}.json"))

    ref_plan, ref_path = build(RefSweepPlan, RefTargetSpec, "interpret",
                               "ref")
    plan, path = build(SweepPlan, TargetSpec, "cpu", "port")
    ref_run_fleet(ref_path, launcher=ref_in_process, audit="off")
    run_fleet(path, launcher=LocalLauncher(in_process=True), audit="off")
    if calibrated:
        rec = {"kind": "calib", "hw": "cpu", "low": 2.0, "high": 5.5,
               "fitted": True, "reps": 2, "samples": []}
        for cls, store in ((RefCampaignStore, ref_plan.store),
                           (CampaignStore, plan.store)):
            st = cls(store)
            st.append(rec)
            st.close()
    ref_code, ref_report = ref_fleet_doctor(ref_plan, explain=True)
    code, report = fleet_doctor(plan, explain=True)
    assert ref_code == code == 0
    want = _explain_sections(ref_report)
    got = _explain_sections(report)
    assert set(got) == {"pallas_probe_s8", "pallas_probe_s64"}
    assert got == want
    prov = "calibrated (low=2, high=5.5)" if calibrated \
        else "default (low=4, high=20)"
    assert all(v[2] == f"thresholds: {prov}" for v in got.values())
    assert all(v[1] is not None and len(v[1][1]) == 1 for v in got.values())


@pytest.mark.parametrize("flags,match", [
    (["--hosts", "HOSTS"], "--hosts/--mock-script need --launcher"),
    (["--launcher", "ssh"], "--launcher ssh needs --hosts"),
    (["--launcher", "mock", "--hosts", "HOSTS"],
     "--hosts needs --launcher ssh"),
    (["--launcher", "ssh", "--hosts", "HOSTS", "--mock-script",
      '{"0": ["crash"]}'], "--mock-script needs --launcher mock"),
    (["--launcher", "ssh", "--hosts", "HOSTS", "--store-format",
      "segments"], "not supported with the ssh launcher"),
], ids=["hosts-alone", "ssh-no-hosts", "hosts-on-mock", "script-on-ssh",
        "ssh-segments"])
def test_cli_plan_launcher_flag_refusals(tmp_path, flags, match):
    from repro_torch.fleet.cli import main

    hosts = _hosts_file(tmp_path)
    argv = ["plan", "--out", str(tmp_path / "p.json"), "--pallas", "probe",
            "--backend", "cpu", "--store", "s.jsonl"]
    with pytest.raises(SystemExit, match=match):
        main(argv + [hosts if f == "HOSTS" else f for f in flags])
    assert not (tmp_path / "p.json").exists()


def test_cli_plan_embeds_the_hosts_file(tmp_path, capsys):
    from repro_torch.fleet.cli import main

    out = str(tmp_path / "p.json")
    assert main(["plan", "--out", out, "--pallas", "probe", "--backend",
                 "cpu", "--store", "s.jsonl", "--launcher", "ssh",
                 "--hosts", _hosts_file(tmp_path)]) == 0
    plan = SweepPlan.load(out)
    assert [h["addr"] for h in plan.launcher["hosts"]] == ["alice@n0", "n1"]
    assert plan.launcher["hosts"][0]["env"]["PYTHONPATH"] == "src"
    assert "env" not in plan.launcher["hosts"][1]
    lch = resolve_launcher(plan=plan)
    assert isinstance(lch, SSHLauncher)
    assert [h.addr for h in lch.hosts] == ["alice@n0", "n1"]


def test_doctor_names_an_unsealed_segment(tmp_path, synth_measure):
    """On segmented stores a crashed shard leaves an unsealed segment: the
    doctor names it (and the pair it left in progress); after the healing
    resume it reports COMPLETE."""
    plan = SweepPlan(
        name="segdoctor", store=str(tmp_path / "sd" / "store.jsonl"),
        targets=[TargetSpec("pallas", ("fp", "mxu"),
                            {"kernel": "probe", "sizes": [8]})],
        reps=2, shards=2, backend="cpu", store_format="segments",
        launcher={"kind": "mock", "script": {"0": ["crash"]}})
    path = plan.save(str(tmp_path / "sd_plan.json"))
    with pytest.raises(FleetError, match=r"shard\(s\) \[0\]"):
        run_fleet(path)
    code, report = fleet_doctor(plan)
    assert code == 1
    assert "shard 0: INCOMPLETE" in report and "shard 1: complete" in report
    assert "1 unsealed segment(s)" in report and "in progress" in report
    run_fleet(path, resume=True, launcher=LocalLauncher(in_process=True))
    code, report = fleet_doctor(plan)
    assert code == 0 and "COMPLETE" in report
