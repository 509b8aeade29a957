"""Segmented campaign stores in the port (``repro_torch.core.segments``):
every case of the reference's ``tests/test_store_segments.py`` run through
the port — segment + manifest layout, incremental merge (segment adoption,
O(new segments), asserted by counting bytes actually parsed), orphan
healing, compaction, layout guards, and the fleet riding on
``store_format: "segments"`` with a report byte-identical to the legacy
single-process run — plus the cross-package cases: a segmented store, its
manifest and its canonical flatten written by either package open, replay
and merge in the other, exactly.

Measurement determinism: REPRO_SYNTH_MEASURE (the deterministic stand-in
clock of both packages); the reference's ``backend="interpret"`` is the
port's ``backend="cpu"``."""
import json
import os

import pytest

from repro.core import CampaignStore as RefCampaignStore
from repro.core import merge_stores as ref_merge_stores
from repro.core.segments import load_manifest as ref_load_manifest
from repro.core.segments import manifest_checksum as ref_manifest_checksum
from repro_torch.core import (CampaignStore, CampaignStoreError, compact_store,
                              io_tally, is_segmented, manifest_status,
                              merge_stores, remove_store, segments_dir,
                              store_exists)
from repro_torch.core import absorption as port_abs
from repro_torch.core.segments import (load_manifest, manifest_checksum,
                                       save_manifest)
from repro_torch.fleet.launchers import LocalLauncher

IN_PROCESS = LocalLauncher(in_process=True)


@pytest.fixture(autouse=True)
def _fresh_port_measure_state():
    port_abs.reset_floor_warnings()
    port_abs.reset_synth_state()
    yield
    port_abs.release_synth_hang()


def _fill(path, region, ks, *, segmented=True, mode="m",
          store_cls=CampaignStore):
    st = store_cls(path, segmented=segmented)
    st.append({"kind": "meta", "region": region, "mode": mode, "reps": 2,
               "compile_once": True})
    for k in ks:
        st.append({"kind": "point", "region": region, "mode": mode,
                   "k": k, "t": 1e-3 * (k + 1)})
    st.append({"kind": "done", "region": region, "mode": mode,
               "ks": list(ks), "drift": None, "stopped_early": False,
               "payload": None})
    st.close()
    return st


def _segment_files(path):
    sdir = segments_dir(path)
    return sorted(n for n in os.listdir(sdir) if n.endswith(".jsonl"))


# ---------------------------------------------------------------------------
# layout + session lifecycle
# ---------------------------------------------------------------------------

def test_segmented_roundtrip_one_segment_per_session(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _fill(path, "rA", [0, 2])
    _fill(path, "rB", [0, 4])
    assert is_segmented(path) and store_exists(path)
    assert not os.path.exists(path)          # the path is a NAME, not a file
    assert len(_segment_files(path)) == 2    # one sealed segment per session
    st = CampaignStore(path, readonly=True)
    st.close()
    assert st.stored_ts("rA", "m") == {0: 1e-3, 2: 3e-3}
    assert st.pair_status("rB", "m").complete
    m = load_manifest(segments_dir(path))
    assert [e["records"] for e in m["segments"]] == [4, 4]
    # per-segment pair coverage rides in the manifest (fleet watch's food)
    assert m["segments"][0]["pairs"] == [
        {"region": "rA", "mode": "m", "points": 2, "done": True}]


def test_segmented_supersede_across_segments(tmp_path):
    """Later segments supersede earlier ones at read time — same rule as
    later lines in a legacy file, including the meta-conflict discard."""
    path = str(tmp_path / "s.jsonl")
    _fill(path, "r", [0, 2])
    st = CampaignStore(path, segmented=True)
    st.append({"kind": "meta", "region": "r", "mode": "m", "reps": 5,
               "compile_once": True})        # conflicting settings
    st.close()
    st = CampaignStore(path, readonly=True)
    st.close()
    assert st.meta[("r", "m")]["reps"] == 5
    assert not st.points and not st.done     # discarded by the conflict


def test_layout_guards(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _fill(path, "r", [0], segmented=False)   # legacy file
    with pytest.raises(CampaignStoreError, match="legacy single-file"):
        CampaignStore(path, segmented=True)
    seg = str(tmp_path / "t.jsonl")
    _fill(seg, "r", [0])
    with pytest.raises(CampaignStoreError, match="segment"):
        CampaignStore(seg, segmented=False)
    # both layouts at one path: ambiguous, refuse
    with open(seg, "w") as f:
        f.write("")
    with pytest.raises(CampaignStoreError, match="both"):
        CampaignStore(seg)
    with pytest.raises(CampaignStoreError, match="both"):
        merge_stores(seg, [path])
    # readonly never creates either layout
    with pytest.raises(FileNotFoundError):
        CampaignStore(str(tmp_path / "absent.jsonl"), readonly=True,
                      segmented=True)
    assert not store_exists(str(tmp_path / "absent.jsonl"))


def test_remove_store_removes_either_layout(tmp_path):
    seg = str(tmp_path / "seg.jsonl")
    leg = str(tmp_path / "leg.jsonl")
    _fill(seg, "r", [0])
    _fill(leg, "r", [0], segmented=False)
    remove_store(seg)
    remove_store(leg)
    assert not store_exists(seg) and not store_exists(leg)


# ---------------------------------------------------------------------------
# corruption policy: checksummed manifest, immutable sealed segments
# ---------------------------------------------------------------------------

def test_manifest_checksum_detects_edits(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _fill(path, "r", [0, 2])
    mpath = os.path.join(segments_dir(path), "MANIFEST.json")
    m = json.load(open(mpath))
    m["segments"][0]["records"] = 999        # hand-edit without re-checksum
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(CampaignStoreError, match="checksum"):
        CampaignStore(path, readonly=True)


def test_missing_sealed_segment_file_hard_fails(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _fill(path, "r", [0, 2])
    os.unlink(os.path.join(segments_dir(path), _segment_files(path)[0]))
    with pytest.raises(CampaignStoreError, match="missing"):
        CampaignStore(path, readonly=True)


def test_mutated_sealed_segment_hard_fails(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _fill(path, "r", [0, 2])
    fp = os.path.join(segments_dir(path), _segment_files(path)[0])
    with open(fp, "a") as f:                 # sealed segments are immutable
        f.write('{"kind": "point", "region": "x", "mode": "m", '
                '"k": 9, "t": 1.0}\n')
    with pytest.raises(CampaignStoreError, match="immutable"):
        CampaignStore(path, readonly=True)


# ---------------------------------------------------------------------------
# orphan healing: writable opens heal, readonly opens tolerate
# ---------------------------------------------------------------------------

def _orphan_with_torn_tail(path):
    """An unsealed segment (writer died before sealing) with a torn tail."""
    good = json.dumps({"kind": "point", "region": "rO", "mode": "m",
                       "k": 7, "t": 2e-3})
    fp = os.path.join(segments_dir(path), "000099-dead-writer.jsonl")
    with open(fp, "wb") as f:
        f.write((good + "\n").encode() + good.encode()[:-9])
    return fp


def test_orphan_heals_on_writable_open_only(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _fill(path, "r", [0])
    fp = _orphan_with_torn_tail(path)
    before = os.path.getsize(fp)
    ro = CampaignStore(path, readonly=True)  # tolerate: replay, touch nothing
    ro.close()
    assert ro.stored_ts("rO", "m") == {7: 2e-3}
    assert os.path.getsize(fp) == before
    assert len(load_manifest(segments_dir(path))["segments"]) == 1
    st = CampaignStore(path)                 # writable: truncate + seal
    st.close()
    assert st.stored_ts("rO", "m") == {7: 2e-3}
    assert os.path.getsize(fp) < before      # torn tail truncated away
    m = load_manifest(segments_dir(path))
    assert [e["id"] for e in m["segments"]][-1] == "000099-dead-writer"
    assert manifest_status(path)["orphans"] == 0


def test_folded_orphan_is_garbage_not_data(tmp_path):
    """A segment id in ``folded`` whose file reappears (interrupted
    compaction cleanup) must be deleted, never replayed — its records
    already live in the compacted segment."""
    path = str(tmp_path / "s.jsonl")
    _fill(path, "r", [0])
    sdir = segments_dir(path)
    m = load_manifest(sdir)
    m["folded"] = ["000050-stale"]
    save_manifest(sdir, m)
    fp = os.path.join(sdir, "000050-stale.jsonl")
    with open(fp, "w") as f:
        f.write(json.dumps({"kind": "point", "region": "zombie", "mode": "m",
                            "k": 0, "t": 1.0}) + "\n")
    st = CampaignStore(path)
    st.close()
    assert ("zombie", "m") not in st.points
    assert not os.path.exists(fp)            # writable open deleted it


# ---------------------------------------------------------------------------
# incremental merge: O(new segments), idempotent, compaction-aware
# ---------------------------------------------------------------------------

def test_incremental_merge_reads_only_new_segments(tmp_path):
    """THE acceptance property: folding one new worker segment into an
    N-segment canonical store parses exactly the new segment's bytes —
    never the destination's, never an already-adopted source's."""
    dest = str(tmp_path / "canon.jsonl")
    for i in range(8):
        _fill(dest, f"r{i}", [0, 2, 4])
    w1 = str(tmp_path / "w1.jsonl")
    _fill(w1, "w1", [0, 2])
    merge_stores(dest, [w1])                 # adopt worker 1
    w2 = str(tmp_path / "w2.jsonl")
    _fill(w2, "w2", [0, 2])
    w2_bytes = sum(e["bytes"]
                   for e in load_manifest(segments_dir(w2))["segments"])
    io_tally(reset=True)
    stats = merge_stores(dest, [dest, w1, w2])
    tally = io_tally()
    assert stats.incremental
    assert stats.segments_new == 1           # only w2's segment is new
    assert stats.segments_skipped == 1       # w1's: skipped WITHOUT reading
    assert tally["records"] == 4             # w2's meta + 2 points + done
    assert tally["bytes"] == w2_bytes        # not one canonical byte parsed
    assert "folded 1 new segment(s)" in str(stats)
    st = CampaignStore(dest, readonly=True)
    st.close()
    assert len(st.done) == 10                # 8 canonical + both workers


def test_incremental_merge_idempotent_and_dest_as_source(tmp_path):
    dest = str(tmp_path / "canon.jsonl")
    _fill(dest, "r", [0])
    w = str(tmp_path / "w.jsonl")
    _fill(w, "w", [0])
    s1 = merge_stores(dest, [dest, w])
    assert (s1.segments_new, s1.segments_skipped) == (1, 0)
    s2 = merge_stores(dest, [dest, w])       # re-merge: nothing new
    assert (s2.segments_new, s2.segments_skipped) == (0, 1)
    files = _segment_files(dest)
    s3 = merge_stores(dest, [dest])          # self-merge: a no-op
    assert s3.segments_new == 0
    assert _segment_files(dest) == files


def test_incremental_merge_adopts_legacy_snapshot_once(tmp_path):
    """A legacy single-file source folds in as ONE content-addressed
    snapshot segment; re-merging the unchanged file is a no-op, a GROWN
    file is re-adopted and supersedes at read time."""
    dest = str(tmp_path / "canon.jsonl")
    _fill(dest, "r", [0])
    leg = str(tmp_path / "leg.jsonl")
    _fill(leg, "L", [0, 2], segmented=False)
    assert merge_stores(dest, [leg]).segments_new == 1
    assert merge_stores(dest, [leg]).segments_new == 0      # unchanged
    with open(leg, "a") as f:
        f.write(json.dumps({"kind": "point", "region": "L", "mode": "m",
                            "k": 8, "t": 9e-3}) + "\n")
    assert merge_stores(dest, [leg]).segments_new == 1      # grown: new snap
    st = CampaignStore(dest, readonly=True)
    st.close()
    assert st.stored_ts("L", "m")[8] == 9e-3


def test_incremental_merge_refuses_legacy_dest_file(tmp_path):
    dest = str(tmp_path / "canon.jsonl")
    _fill(dest, "r", [0], segmented=False)
    src = str(tmp_path / "w.jsonl")
    _fill(src, "w", [0])
    with pytest.raises(CampaignStoreError, match="legacy store file"):
        merge_stores(dest, [src], incremental=True)
    # but the auto dispatch keeps a legacy dest on the legacy path
    stats = merge_stores(dest, [dest, src])
    assert not stats.incremental
    st = CampaignStore(dest, readonly=True)
    st.close()
    assert ("r", "m") in st.done and ("w", "m") in st.done


def test_compact_collapses_and_future_merges_skip_folded(tmp_path):
    dest = str(tmp_path / "canon.jsonl")
    w = str(tmp_path / "w.jsonl")
    _fill(dest, "r", [0, 2])
    _fill(dest, "r", [0, 2])                 # superseded duplicate session
    _fill(w, "w", [0])
    merge_stores(dest, [dest, w])
    cstats = compact_store(dest)
    assert cstats.segments_in == 3 and cstats.records_in == 11
    assert cstats.records_out == 7           # one r sweep + one w sweep
    assert len(_segment_files(dest)) == 1
    assert "reclaimed" in str(cstats)
    st = CampaignStore(dest, readonly=True)
    st.close()
    assert st.pair_status("r", "m").complete
    assert st.pair_status("w", "m").complete
    # the original sources fold to nothing: their ids live in ``folded``
    s = merge_stores(dest, [dest, w])
    assert (s.segments_new, s.segments_skipped) == (0, 1)
    # and compacting a compacted store is a no-op shape (1 segment in/out)
    assert compact_store(dest).segments_in == 1


def test_compact_legacy_store_rewrites_canonical(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _fill(path, "r", [0], segmented=False)
    _fill(path, "r", [0], segmented=False)   # superseded duplicate
    cstats = compact_store(path)
    assert cstats.records_in == 6 and cstats.records_out == 3
    assert not is_segmented(path)
    with pytest.raises(FileNotFoundError):
        compact_store(str(tmp_path / "absent.jsonl"))


def test_segmented_flatten_byte_identical_to_legacy(tmp_path):
    """Deterministic twin of the hypothesis property: the same stream in
    both layouts flattens to the byte-identical canonical file."""
    leg = str(tmp_path / "leg.jsonl")
    seg = str(tmp_path / "seg.jsonl")
    for region, ks in (("rA", [0, 2]), ("rB", [0, 4])):
        _fill(leg, region, ks, segmented=False)
        _fill(seg, region, ks)
    fl, fs = str(tmp_path / "fl.jsonl"), str(tmp_path / "fs.jsonl")
    merge_stores(fl, [leg], incremental=False)
    merge_stores(fs, [seg], incremental=False)
    assert open(fl).read() == open(fs).read()


def test_campaign_cli_compact_and_merge_canonical(tmp_path, capsys):
    from repro_torch.core.campaign import _cli

    seg = str(tmp_path / "seg.jsonl")
    _fill(seg, "r", [0, 2])
    _fill(seg, "r", [0, 2])
    assert _cli(["compact", seg]) == 0
    assert "compacted 8 -> 4 record(s)" in capsys.readouterr().out
    flat = str(tmp_path / "flat.jsonl")
    assert _cli(["merge", "--canonical", flat, seg]) == 0
    assert os.path.isfile(flat) and not is_segmented(flat)
    assert _cli(["compact", str(tmp_path / "absent.jsonl")]) == 2


# ---------------------------------------------------------------------------
# the fleet on store_format: "segments"
# ---------------------------------------------------------------------------

@pytest.fixture
def synth_measure(monkeypatch):
    monkeypatch.setenv("REPRO_SYNTH_MEASURE", "1e-3")


def _plan(tmp_path, *, shards=2, stem="segfleet", store_format="segments",
          launcher=None, save=True):
    from repro_torch.fleet.plan import SweepPlan, TargetSpec

    plan = SweepPlan(
        name="fleet_probe", store=str(tmp_path / stem / "store.jsonl"),
        targets=[TargetSpec("pallas", ("fp", "mxu"),
                            {"kernel": "probe", "sizes": [8]})],
        reps=2, shards=shards, backend="cpu",
        store_format=store_format, launcher=launcher)
    path = str(tmp_path / f"{stem}_plan.json")
    if save:
        plan.save(path)
    return plan, path


def test_plan_store_format_validation(tmp_path):
    from repro_torch.fleet.plan import PlanError, SweepPlan

    plan, path = _plan(tmp_path)
    assert SweepPlan.load(path).store_format == "segments"
    legacy_plan, _ = _plan(tmp_path, stem="legacyfmt", store_format=None)
    assert plan.digest() != legacy_plan.digest()    # the layout is pinned
    with pytest.raises(PlanError, match="one of"):
        _plan(tmp_path, stem="badfmt", store_format="parquet",
              save=False)[0].validate()
    ssh_plan, _ = _plan(tmp_path, stem="sshfmt", save=False,
                        launcher={"kind": "ssh", "hosts": [{"addr": "n0"}]})
    with pytest.raises(PlanError, match="single-file staging"):
        ssh_plan.validate()


def test_segmented_fleet_matches_legacy_single_process(tmp_path,
                                                       synth_measure):
    """Acceptance: an N=2 fleet writing SEGMENTED stores end-to-end (worker
    stores and canonical store) produces a report byte-identical to the
    same plan run single-process on the LEGACY layout."""
    from repro_torch.fleet.executor import run_fleet, run_worker
    from repro_torch.fleet.plan import SweepPlan

    plan, path = _plan(tmp_path)
    res = run_fleet(path, launcher=IN_PROCESS)
    assert res.launched == [0, 1]
    assert is_segmented(plan.store)
    assert all(is_segmented(ws) for ws in plan.worker_stores())
    assert res.state.merge.get("segments_new", 0) >= 2   # one per worker
    report = open(plan.report_path(), "rb").read()

    single, single_path = _plan(tmp_path, stem="legacy_ref", shards=1,
                                store_format=None)
    run_worker(SweepPlan.load(single_path))
    assert not is_segmented(single.store)
    assert open(single.report_path(), "rb").read() == report

    # a completed segmented fleet replays with zero measurements and the
    # incremental re-merge adopts nothing new
    res2 = run_fleet(path, resume=True, expect_no_measure=True)
    assert res2.launched == []
    assert res2.state.merge.get("segments_new") == 0


def test_segmented_fleet_crash_heal_and_drop_point(tmp_path, synth_measure):
    """The mock launcher's fault injection speaks segments: a 'crash' tears
    the worker's done-bearing segment back into an unsealed orphan, a
    resume heals it and re-measures only the torn point."""
    from repro_torch.fleet.executor import FleetError, run_fleet
    from repro_torch.fleet.launchers import (MockClusterLauncher,
                                             drop_done_point, tear_store_tail)

    plan, path = _plan(tmp_path, stem="segcrash")
    with pytest.raises(FleetError, match=r"shard\(s\) \[0\]"):
        run_fleet(path, launcher=MockClusterLauncher({0: ("crash",)}))
    ws = plan.worker_stores()[0]
    assert manifest_status(ws)["orphans"] == 1          # torn, unsealed
    res = run_fleet(path, resume=True, launcher=IN_PROCESS)
    assert res.launched == [0]
    wstats = json.load(open(ws + ".stats.json"))
    assert wstats["measured"] == 1                      # only the torn point
    assert wstats["cached"] > 0

    # drop-point: store stays structurally valid, exactly one k missing
    drop_done_point(ws)
    st = CampaignStore(ws, readonly=True)
    st.close()
    bad = [ps for ps in st.grid_status(plan.grid()).values()
           if ps.done and not ps.complete]
    assert len(bad) == 1 and len(bad[0].missing) == 1

    # a segmented store with no done marker refuses both faults cleanly
    nodone = str(tmp_path / "nodone.jsonl")
    st = CampaignStore(nodone, segmented=True)
    st.append({"kind": "point", "region": "r", "mode": "m", "k": 0, "t": 1.0})
    st.close()
    with pytest.raises(FleetError, match="no done-promised point"):
        drop_done_point(nodone)
    with pytest.raises(FleetError, match="no done-marked sweep"):
        tear_store_tail(nodone)


def test_fleet_watch_once(tmp_path, synth_measure, capsys):
    from repro_torch.fleet.cli import main
    from repro_torch.fleet.executor import run_fleet

    plan, path = _plan(tmp_path, stem="watch")
    assert main(["watch", "--plan", path, "--once"]) == 1   # nothing yet
    out = capsys.readouterr().out
    assert "fleet watch" in out and "absent" in out
    assert "0/2 pair(s) done" in out
    run_fleet(path, launcher=IN_PROCESS)
    assert main(["watch", "--plan", path, "--once"]) == 0
    out = capsys.readouterr().out
    assert "sealed segment(s)" in out
    assert "2/2 pair(s) done" in out


def test_fleet_cli_plan_writes_store_format(tmp_path, synth_measure):
    from repro_torch.fleet.cli import main
    from repro_torch.fleet.plan import SweepPlan

    out_plan = str(tmp_path / "p.json")
    store = str(tmp_path / "cli" / "store.jsonl")
    assert main(["plan", "--out", out_plan, "--pallas", "probe",
                 "--sizes", "8", "--modes", "fp", "--shards", "1",
                 "--backend", "cpu", "--store", store,
                 "--store-format", "segments"]) == 0
    assert SweepPlan.load(out_plan).store_format == "segments"
    assert main(["run", "--plan", out_plan, "--in-process"]) == 0
    assert is_segmented(store)
    assert main(["status", "--plan", out_plan]) == 0


# ---------------------------------------------------------------------------
# cross-package: stores, manifests and flattens are interchangeable
# ---------------------------------------------------------------------------

PACKAGES = {"reference": (RefCampaignStore, ref_merge_stores),
            "port": (CampaignStore, merge_stores)}
DIRECTIONS = [("reference", "port"), ("port", "reference")]
DIRECTION_IDS = ["reference-to-port", "port-to-reference"]


def _sessions():
    """Three writer sessions: two sweeps, a sens and quality evidence, and
    a third session whose conflicting meta discards rB's first sweep."""
    def sweep(region, ks, reps=2):
        return ([{"kind": "meta", "region": region, "mode": "m",
                  "reps": reps, "compile_once": True},
                 {"kind": "sens", "region": region, "mode": "m",
                  "value": 1.5}]
                + [{"kind": "point", "region": region, "mode": "m", "k": k,
                    "t": 1e-3 * (k + 1)} for k in ks]
                + [{"kind": "quality", "region": region, "mode": "m",
                    "k": ks[-1], "verdict": "valid", "reason": None,
                    "spread": 0.01, "reps": reps, "detail": None},
                   {"kind": "done", "region": region, "mode": "m",
                    "ks": list(ks), "drift": None, "stopped_early": False,
                    "payload": None}])
    return [sweep("rA", [0, 2, 4]), sweep("rB", [0, 8]),
            sweep("rB", [0, 16], reps=3)]


def _write_sessions(path, store_cls, *, segmented=True):
    for recs in _sessions():
        st = store_cls(path, segmented=segmented)
        for rec in recs:
            st.append(rec)
        st.close()


def _view(store):
    store.close()
    return store.points, store.done, store.sens, store.meta, store.quality


@pytest.mark.parametrize("compacted", [False, True],
                         ids=["segments", "compacted"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=DIRECTION_IDS)
def test_segmented_store_replays_across_packages(tmp_path, writer, reader,
                                                 compacted):
    """(a) a segmented store one package writes (and, compacted, its one
    canonical segment) replays in the other with equal points, done, sens,
    meta and quality; each package's own view agrees."""
    from repro.core import compact_store as ref_compact_store

    path = str(tmp_path / "s.jsonl")
    _write_sessions(path, PACKAGES[writer][0])
    if compacted:
        (ref_compact_store if writer == "reference" else compact_store)(path)
        assert len(_segment_files(path)) == 1
    got = _view(PACKAGES[reader][0](path, readonly=True))
    want = _view(PACKAGES[writer][0](path, readonly=True))
    assert got == want
    assert got[0][("rB", "m")] == {0: 1e-3, 16: 1.7e-2}   # conflict applied


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=DIRECTION_IDS)
def test_manifest_loads_across_packages(tmp_path, writer, reader):
    """(b) each package's manifest loads in the other: the same body, the
    same checksum from both packages' checksum functions; an edit either
    package detects, the other detects too."""
    load = {"reference": ref_load_manifest, "port": load_manifest}
    checksum = {"reference": ref_manifest_checksum,
                "port": manifest_checksum}
    path = str(tmp_path / "s.jsonl")
    _write_sessions(path, PACKAGES[writer][0])
    sdir = segments_dir(path)
    m_writer = load[writer](sdir)
    m_reader = load[reader](sdir)
    assert m_reader == m_writer
    assert (checksum[reader](m_reader) == checksum[writer](m_writer)
            == m_writer["checksum"])
    assert [e["records"] for e in m_reader["segments"]] == \
        [len(recs) for recs in _sessions()]
    mpath = os.path.join(sdir, "MANIFEST.json")
    m = json.load(open(mpath))
    m["next_seq"] += 1                       # edited, checksum left stale
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(RuntimeError, match="checksum"):
        PACKAGES[reader][0](path, readonly=True)


def test_canonical_flatten_is_byte_identical_across_packages(tmp_path):
    """(c) the same records written segmented by each package, and as one
    legacy file, flatten (each package's full canonical merge, of its own
    store and of the other's) to one byte-identical canonical file."""
    flats = []
    for writer in PACKAGES:
        seg = str(tmp_path / f"{writer}_seg.jsonl")
        _write_sessions(seg, PACKAGES[writer][0])
        leg = str(tmp_path / f"{writer}_leg.jsonl")
        _write_sessions(leg, PACKAGES[writer][0], segmented=False)
        for merger in PACKAGES:
            for src in (seg, leg):
                out = str(tmp_path / f"flat_{writer}_{merger}_"
                          f"{os.path.basename(src)}")
                PACKAGES[merger][1](out, [src], incremental=False)
                flats.append(open(out, "rb").read())
    assert len(flats) == 8 and len(set(flats)) == 1
    assert flats[0].count(b"\n") == 13       # rA's 7 + rB's later sweep's 6


def test_port_adopts_a_reference_segment_once(tmp_path):
    """(d) a port destination adopts a reference-written worker segment
    once; the next merge skips it without reading a byte (``io_tally``),
    and the destination replays alike in both packages."""
    dest = str(tmp_path / "canon.jsonl")
    _fill(dest, "r", [0, 2])
    w = str(tmp_path / "w.jsonl")
    _fill(w, "w", [0, 4], store_cls=RefCampaignStore)
    first = merge_stores(dest, [dest, w])
    assert (first.segments_new, first.segments_skipped) == (1, 0)
    io_tally(reset=True)
    again = merge_stores(dest, [dest, w])
    assert (again.segments_new, again.segments_skipped) == (0, 1)
    assert io_tally() == {"bytes": 0, "records": 0}
    ids = [e["id"] for e in load_manifest(segments_dir(dest))["segments"]]
    assert ids[-1] == load_manifest(segments_dir(w))["segments"][0]["id"]
    port_view = _view(CampaignStore(dest, readonly=True))
    assert port_view == _view(RefCampaignStore(dest, readonly=True))
    assert port_view[0][("w", "m")] == {0: 1e-3, 4: 5e-3}
