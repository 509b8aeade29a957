"""Property tests for the port's campaign store merge semantics
(``repro_torch.core.campaign``): the reference's
``tests/test_store_merge_props.py`` properties run through the port, plus
one across the packages (hypothesis, optional: without it these skip, the
module still loads).

Pinned properties:
  * merge is idempotent — re-merging a merged store is a byte-level no-op;
  * merge is order-independent for stores with disjoint keys;
  * later records supersede earlier ones for the same key (within a store
    by line order, across stores by source order);
  * when metas agree, merge(a, b)'s replay view equals the union of the
    two stores' replay views (b winning point collisions);
  * LAYOUT EQUIVALENCE — the same record stream written as a legacy single
    file and as a segmented store (arbitrary session splits, optional torn
    tail, meta conflicts included) flattens to byte-identical canonical
    output through ``merge_stores(..., incremental=False)``;
  * QUALITY EVIDENCE — measurement-quality records ride every property
    above (same (region, mode, k) last-wins supersede as points), a meta
    conflict discards them with the rest of the pair's measured evidence,
    and ``compact_store`` preserves the quality view in both layouts;
  * CALIB RECORDS — fitted-threshold records supersede last-wins by
    hardware key, survive merge and compaction in both layouts, and are
    NOT settings-scoped (a meta conflict never drops them);
  * ACROSS PACKAGES — the port's segmented store, flattened by the port,
    is byte-identical to the reference's legacy store of the same stream
    flattened by the reference.
"""
try:
    import hypothesis
    import hypothesis.strategies as st
except ModuleNotFoundError:   # property tests skip; the rest still runs
    from conftest import hypothesis_stub as hypothesis
    from conftest import strategies_stub as st

import os
import tempfile

from repro_torch.core import CampaignStore, merge_stores

REGIONS = ("rA", "rB")
MODES = ("m1", "m2")

point = st.fixed_dictionaries({
    "kind": st.just("point"),
    "region": st.sampled_from(REGIONS),
    "mode": st.sampled_from(MODES),
    "k": st.integers(0, 6),
    "t": st.floats(1e-4, 1.0, allow_nan=False, allow_infinity=False),
})
sens = st.fixed_dictionaries({
    "kind": st.just("sens"),
    "region": st.sampled_from(REGIONS),
    "mode": st.sampled_from(MODES),
    "value": st.floats(0.1, 10.0, allow_nan=False, allow_infinity=False),
})
quality = st.fixed_dictionaries({
    "kind": st.just("quality"),
    "region": st.sampled_from(REGIONS),
    "mode": st.sampled_from(MODES),
    "k": st.integers(0, 6),
    "verdict": st.sampled_from(["valid", "quarantine"]),
    "reason": st.sampled_from([None, "timer_floor", "spread", "drift_span",
                               "timeout"]),
    "spread": st.one_of(st.none(), st.floats(0.0, 2.0, allow_nan=False,
                                             allow_infinity=False)),
    "reps": st.sampled_from([2, 5]),
    "detail": st.just(None),
})
calib = st.fixed_dictionaries({
    "kind": st.just("calib"),
    "hw": st.sampled_from(["cpu", "tpu"]),
    "low": st.floats(0.5, 8.0, allow_nan=False, allow_infinity=False),
    "high": st.floats(8.5, 64.0, allow_nan=False, allow_infinity=False),
    "fitted": st.booleans(),
    "reps": st.sampled_from([2, 5]),
    "samples": st.just([]),
})
records = st.lists(st.one_of(point, sens, quality, calib), max_size=24)


def _write(path, recs):
    store = CampaignStore(path)
    for rec in recs:
        store.append(rec)
    store.close()


def _load(path):
    store = CampaignStore(path)
    store.close()
    return store


@hypothesis.given(records, records)
@hypothesis.settings(max_examples=40, deadline=None)
def test_merge_idempotent(recs_a, recs_b):
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a.jsonl"), os.path.join(d, "b.jsonl")
        _write(a, recs_a)
        _write(b, recs_b)
        m1, m2 = os.path.join(d, "m1.jsonl"), os.path.join(d, "m2.jsonl")
        merge_stores(m1, [a, b])
        merge_stores(m2, [m1])
        assert open(m1).read() == open(m2).read()
        merge_stores(m1, [m1, m1])      # self-merge in place: still a no-op
        assert open(m1).read() == open(m2).read()


@hypothesis.given(records, records)
@hypothesis.settings(max_examples=40, deadline=None)
def test_merge_order_independent_for_disjoint_stores(recs_a, recs_b):
    # force key-disjointness: each store only ever sees its own region
    # (and, for hw-keyed calib records, its own hardware)
    recs_a = [dict(r, hw="cpu") if r["kind"] == "calib"
              else dict(r, region="rA") for r in recs_a]
    recs_b = [dict(r, hw="tpu") if r["kind"] == "calib"
              else dict(r, region="rB") for r in recs_b]
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a.jsonl"), os.path.join(d, "b.jsonl")
        _write(a, recs_a)
        _write(b, recs_b)
        ab, ba = os.path.join(d, "ab.jsonl"), os.path.join(d, "ba.jsonl")
        merge_stores(ab, [a, b])
        merge_stores(ba, [b, a])
        assert open(ab).read() == open(ba).read()


@hypothesis.given(records)
@hypothesis.settings(max_examples=40, deadline=None)
def test_later_records_supersede_within_a_store(recs):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.jsonl")
        _write(path, recs)
        store = _load(path)
        # the in-memory view must equal a left-to-right last-wins fold
        want_points, want_sens, want_quality, want_calib = {}, {}, {}, {}
        for rec in recs:
            if rec["kind"] == "calib":      # keyed by hardware, not pair
                want_calib[rec["hw"]] = rec
                continue
            key = (rec["region"], rec["mode"])
            if rec["kind"] == "point":
                want_points.setdefault(key, {})[rec["k"]] = rec["t"]
            elif rec["kind"] == "quality":
                want_quality.setdefault(key, {})[rec["k"]] = rec
            else:
                want_sens[key] = rec["value"]
        assert store.points == want_points
        assert store.sens == want_sens
        assert store.quality == want_quality
        assert store.calib == want_calib


meta = st.fixed_dictionaries({
    "kind": st.just("meta"),
    "region": st.sampled_from(REGIONS),
    "mode": st.sampled_from(MODES),
    "reps": st.sampled_from([2, 3]),      # two settings -> real conflicts
    "compile_once": st.just(True),
})
mixed_records = st.lists(st.one_of(point, sens, meta, quality, calib),
                         max_size=24)


@hypothesis.given(mixed_records, st.lists(st.integers(0, 24), max_size=3),
                  st.booleans())
@hypothesis.settings(max_examples=40, deadline=None)
def test_segmented_flatten_matches_legacy_store(recs, cuts, torn):
    """The segmented layout is INVISIBLE to merge semantics: the same
    record stream, split across writer sessions at arbitrary cut points
    (one sealed segment each) and optionally finished with the same torn
    partial tail, flattens to the byte-identical canonical store."""
    from repro_torch.core import segments_dir

    with tempfile.TemporaryDirectory() as d:
        legacy = os.path.join(d, "legacy.jsonl")
        _write(legacy, recs)
        seg = os.path.join(d, "seg.jsonl")
        prev = 0
        for cut in sorted({min(c, len(recs)) for c in cuts} | {len(recs)}):
            store = CampaignStore(seg, segmented=True)
            for rec in recs[prev:cut]:
                store.append(rec)
            store.close()
            prev = cut
        if torn:
            partial = b'{"kind": "point", "region": "rA", "mo'
            with open(legacy, "ab") as f:
                f.write(partial)
            # the same torn bytes as an unsealed orphan segment (a sealed
            # segment is immutable; only orphans can carry a torn tail)
            with open(os.path.join(segments_dir(seg),
                                   "999999-torn.jsonl"), "wb") as f:
                f.write(partial)
        flat_l = os.path.join(d, "flat_legacy.jsonl")
        flat_s = os.path.join(d, "flat_seg.jsonl")
        merge_stores(flat_l, [legacy], incremental=False)
        merge_stores(flat_s, [seg], incremental=False)
        assert open(flat_l).read() == open(flat_s).read()


@hypothesis.given(records, records)
@hypothesis.settings(max_examples=40, deadline=None)
def test_merge_replay_is_union_when_metas_agree(recs_a, recs_b):
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a.jsonl"), os.path.join(d, "b.jsonl")
        _write(a, recs_a)
        _write(b, recs_b)
        m = os.path.join(d, "m.jsonl")
        stats = merge_stores(m, [a, b])
        assert not stats.conflicts          # no metas at all -> no conflicts
        merged = _load(m)
        va, vb = _load(a), _load(b)
        want, want_q = {}, {}
        for src in (va, vb):                # b streams later: b wins ties
            for key, per_k in src.points.items():
                want.setdefault(key, {}).update(per_k)
            for key, per_k in src.quality.items():
                want_q.setdefault(key, {}).update(per_k)
        assert merged.points == want
        assert merged.sens == {**va.sens, **vb.sens}
        assert merged.quality == want_q
        assert merged.calib == {**va.calib, **vb.calib}


@hypothesis.given(st.lists(quality, min_size=1, max_size=12))
@hypothesis.settings(max_examples=40, deadline=None)
def test_meta_conflict_discards_quality_evidence(qrecs):
    """Quality records are settings-scoped: a meta conflict that drops a
    pair's points must drop its quality evidence too, both across stores
    (merge) and within one store's append order."""
    qrecs = [dict(r, region="rA", mode="m1") for r in qrecs]
    meta2 = {"kind": "meta", "region": "rA", "mode": "m1", "reps": 2,
             "compile_once": True}
    meta3 = dict(meta2, reps=3)
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a.jsonl"), os.path.join(d, "b.jsonl")
        _write(a, [meta2] + qrecs)
        _write(b, [meta3])
        m = os.path.join(d, "m.jsonl")
        stats = merge_stores(m, [a, b])
        assert stats.conflicts == [("rA", "m1")]
        assert _load(m).quality == {}
        c = os.path.join(d, "c.jsonl")
        _write(c, [meta2] + qrecs + [meta3])
        assert _load(c).quality == {}


@hypothesis.given(st.lists(calib, min_size=1, max_size=8), st.booleans())
@hypothesis.settings(max_examples=40, deadline=None)
def test_calib_records_are_not_settings_scoped(crecs, conflict):
    """Calibrated thresholds are per-hardware, not per-measurement-settings:
    a meta conflict that discards a pair's points/quality must leave the
    calib view untouched, and the last record per hw wins."""
    meta2 = {"kind": "meta", "region": "rA", "mode": "m1", "reps": 2,
             "compile_once": True}
    metas = [meta2] + ([dict(meta2, reps=3)] if conflict else [])
    want = {}
    for rec in crecs:
        want[rec["hw"]] = rec
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.jsonl")
        _write(path, [metas[0]] + crecs + metas[1:])
        assert _load(path).calib == want
        m = os.path.join(d, "m.jsonl")
        merge_stores(m, [path])
        assert _load(m).calib == want


@hypothesis.given(mixed_records, st.booleans())
@hypothesis.settings(max_examples=40, deadline=None)
def test_compaction_preserves_the_quality_view(recs, segmented):
    """``compact_store`` drops superseded lines, never surviving evidence:
    the points/sens/quality views are identical before and after, in both
    the legacy and the segmented layout."""
    from repro_torch.core import compact_store

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s.jsonl")
        store = CampaignStore(path, segmented=segmented)
        for rec in recs:
            store.append(rec)
        store.close()
        before = _load(path)
        compact_store(path)
        after = _load(path)
        assert after.points == before.points
        assert after.sens == before.sens
        assert after.quality == before.quality
        assert after.calib == before.calib


@hypothesis.given(mixed_records, st.lists(st.integers(0, 24), max_size=3))
@hypothesis.settings(max_examples=40, deadline=None)
def test_port_segmented_flatten_matches_reference_legacy(recs, cuts):
    """The port's segmented store (arbitrary session splits), flattened by
    the port, equals the reference's legacy store of the same stream,
    flattened by the reference, byte for byte."""
    from repro.core import CampaignStore as RefCampaignStore
    from repro.core import merge_stores as ref_merge_stores

    with tempfile.TemporaryDirectory() as d:
        legacy = os.path.join(d, "legacy.jsonl")
        ref_store = RefCampaignStore(legacy)
        for rec in recs:
            ref_store.append(rec)
        ref_store.close()
        seg = os.path.join(d, "seg.jsonl")
        prev = 0
        for cut in sorted({min(c, len(recs)) for c in cuts} | {len(recs)}):
            store = CampaignStore(seg, segmented=True)
            for rec in recs[prev:cut]:
                store.append(rec)
            store.close()
            prev = cut
        flat_ref = os.path.join(d, "flat_ref.jsonl")
        flat_port = os.path.join(d, "flat_port.jsonl")
        ref_merge_stores(flat_ref, [legacy], incremental=False)
        merge_stores(flat_port, [seg], incremental=False)
        assert open(flat_ref).read() == open(flat_port).read()
