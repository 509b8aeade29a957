"""Segmented campaign stores — append-only segments plus a checksummed
manifest.

A legacy campaign store is ONE JSONL file: every open re-reads all of it and
every merge rewrites all of it, which is O(store) per fleet round and the
scaling wall for million-point campaigns. A *segmented* store replaces the
single file with a directory next to the store path::

    experiments/campaigns/sweep.jsonl            # (absent — path is a name)
    experiments/campaigns/sweep.segments/
        MANIFEST.json                            # checksummed index
        000001-4242-0-9f1c.jsonl                 # sealed segment
        000002-4311-0-02ab.jsonl                 # unsealed (live writer)

Rules that make this safe without any locking:

  * segments are APPEND-ONLY while open and IMMUTABLE once sealed — a writer
    session opens a fresh segment, appends records to it, and seals it into
    the manifest at ``close()``; nothing ever appends to a sealed segment;
  * the manifest records each sealed segment's id, byte length, record count
    and per-(region, mode) pair coverage, plus a ``folded`` list of segment
    ids already compacted away; a sha256 checksum over the canonical JSON
    detects edits/bit-rot (checksum mismatch refuses to load);
  * replay order is deterministic: manifest segments in manifest order, then
    unsealed orphans sorted by filename (ids start with a zero-padded
    sequence number). Supersede semantics are therefore a property of READ
    time, exactly as in a legacy single file;
  * a writer killed before sealing leaves an *orphan* segment: the next
    writable open heals it — truncates a torn tail and seals it into the
    manifest — while readonly opens just tolerate it. Orphans whose id is in
    ``folded`` are garbage from an interrupted compaction (their records
    already live in the compacted segment) and are deleted, never replayed;
  * ``adopt_segments`` is the incremental merge: it copies whole segments a
    destination has never seen (id not in manifest or ``folded``) and skips
    the rest — cost is O(new segments), never O(store). Legacy single-file
    sources are adopted as one content-addressed snapshot segment.

``read_store_records`` (the line-streaming JSONL reader shared with legacy
stores) and ``CampaignStoreError`` live here so ``repro_torch.core.campaign``
can build both layouts on one tolerant read path.

The layout, the manifest's schema and checksum, segment ids and the adoption
rules are the reference package's (``repro.core.segments``), so a segmented
store either package writes opens, replays, merges and compacts in the other.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import shutil
from typing import Iterable, Iterator, Optional, Sequence

log = logging.getLogger("repro_torch.segments")

SEGMENT_SCHEMA = 1
MANIFEST_NAME = "MANIFEST.json"

_SEG_COUNT = itertools.count()


class CampaignStoreError(RuntimeError):
    """A store is corrupt in a way the loader must not paper over."""


# ---------------------------------------------------------------------------
# Streaming JSONL read path (shared by legacy files and segments)
# ---------------------------------------------------------------------------

_IO_TALLY = {"bytes": 0, "records": 0}


def io_tally(*, reset: bool = False) -> dict:
    """Process-wide tally of store bytes/records parsed by
    ``read_store_records`` — the measurement behind the incremental-merge
    guarantee (folding one new segment into an N-segment store reads O(new
    segment), not O(store)). Returns ``{"bytes": b, "records": n}``;
    ``reset=True`` zeroes the counters after reading them."""
    out = dict(_IO_TALLY)
    if reset:
        _IO_TALLY["bytes"] = 0
        _IO_TALLY["records"] = 0
    return out


def read_store_records(path: str) -> tuple[list[dict], int]:
    """Parse a JSONL store, streaming line-by-line, tolerating a truncated
    FINAL line.

    A process killed between ``write`` and ``flush`` leaves a partial last
    record; that is expected damage and costs at most one point, so it is
    dropped with a warning. A malformed record with valid records AFTER it
    cannot come from a torn append — that store is corrupt, and loading it
    raises ``CampaignStoreError``.

    Returns ``(records, valid_bytes)`` where ``valid_bytes`` is the length of
    the clean prefix (the caller may truncate the file to it).
    """
    records: list[dict] = []
    valid = 0
    pos = 0
    bad: Optional[tuple[int, int, Exception]] = None  # (pos, len, error)
    with open(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if line:
                if bad is not None:
                    # valid-looking data AFTER a corrupt record: not a torn
                    # append — refuse to load rather than silently drop
                    raise CampaignStoreError(
                        f"{path}: corrupt record at byte {bad[0]} with valid "
                        f"records after it ({bad[2]}); refusing to load"
                    ) from bad[2]
                try:
                    rec = json.loads(line.decode("utf-8"))
                    if not isinstance(rec, dict):
                        raise ValueError(f"record is {type(rec).__name__}, "
                                         "not an object")
                except (UnicodeDecodeError, ValueError) as e:
                    n = len(raw) - (1 if raw.endswith(b"\n") else 0)
                    bad = (pos, n, e)
                    pos += len(raw)
                    continue
                records.append(rec)
                _IO_TALLY["records"] += 1
            pos += len(raw)
            if bad is None:
                valid = pos
    _IO_TALLY["bytes"] += pos
    if bad is not None:
        log.warning(
            "%s: dropping truncated final record (%d bytes) — a previous "
            "run died mid-append", path, bad[1])
    return records, valid


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------


def segments_dir(path: str) -> str:
    """The segment directory of a store path: ``base.jsonl`` ->
    ``base.segments``."""
    base, _ = os.path.splitext(path)
    return base + ".segments"


def is_segmented(path: str) -> bool:
    """True when a segment directory exists for this store path."""
    return os.path.isdir(segments_dir(path))


def store_exists(path: str) -> bool:
    """True when a store exists at ``path`` in EITHER layout (legacy single
    file or segment directory) — the existence check every caller that used
    ``os.path.exists(store)`` must use instead."""
    return os.path.exists(path) or is_segmented(path)


def remove_store(path: str) -> None:
    """Delete a store in whichever layout(s) it exists."""
    if os.path.exists(path):
        os.unlink(path)
    sdir = segments_dir(path)
    if os.path.isdir(sdir):
        shutil.rmtree(sdir)


def _seq_of(sid: str) -> int:
    head = sid.split("-", 1)[0]
    return int(head) if head.isdigit() else 0


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------


def _fresh_manifest() -> dict:
    return {"segment_store": SEGMENT_SCHEMA, "next_seq": 1,
            "segments": [], "folded": []}


def manifest_checksum(m: dict) -> str:
    """sha256 over the canonical JSON of the manifest minus ``checksum``."""
    body = {k: v for k, v in m.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode("utf-8")).hexdigest()


def load_manifest(sdir: str) -> dict:
    """Load and verify a segment directory's manifest (fresh when absent)."""
    p = os.path.join(sdir, MANIFEST_NAME)
    if not os.path.exists(p):
        return _fresh_manifest()
    try:
        with open(p) as f:
            m = json.load(f)
    except ValueError as e:
        raise CampaignStoreError(
            f"{p}: manifest is not valid JSON ({e})") from e
    if not isinstance(m, dict) or m.get("segment_store") != SEGMENT_SCHEMA:
        raise CampaignStoreError(
            f"{p}: unsupported segment_store schema "
            f"{m.get('segment_store') if isinstance(m, dict) else m!r}")
    if m.get("checksum") != manifest_checksum(m):
        raise CampaignStoreError(
            f"{p}: manifest checksum mismatch — the manifest was edited or "
            "the disk lies; refusing to load")
    m.setdefault("segments", [])
    m.setdefault("folded", [])
    return m


def save_manifest(sdir: str, m: dict) -> None:
    """Checksum and atomically publish a manifest (tmp + rename)."""
    m = dict(m)
    m["checksum"] = manifest_checksum(m)
    tmp = os.path.join(sdir, f"{MANIFEST_NAME}.tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(m, f, sort_keys=True, indent=1)
        f.write("\n")
    os.replace(tmp, os.path.join(sdir, MANIFEST_NAME))


# -- per-segment pair coverage (what `fleet watch` renders) -----------------


def _cov_add(cov: dict, rec: dict) -> None:
    key = (rec.get("region"), rec.get("mode"))
    c = cov.setdefault(key, {"region": key[0], "mode": key[1],
                             "points": 0, "done": False})
    kind = rec.get("kind")
    if kind == "point":
        c["points"] += 1
    elif kind == "done":
        c["done"] = True
    elif kind == "quality":
        # last verdict per k within this segment (JSON keys are strings);
        # the key is absent for segments with no quality records, so
        # pre-guard manifests keep their exact shape
        c.setdefault("quality", {})[str(rec.get("k"))] = rec.get("verdict")


def _cov_list(cov: dict) -> list[dict]:
    return [cov[k] for k in sorted(cov, key=lambda k: (str(k[0]), str(k[1])))]


def _coverage(records: Iterable[dict]) -> list[dict]:
    cov: dict = {}
    for rec in records:
        _cov_add(cov, rec)
    return _cov_list(cov)


# ---------------------------------------------------------------------------
# SegmentStore: the write/replay backend behind CampaignStore
# ---------------------------------------------------------------------------


class SegmentStore:
    """One campaign store as a directory of append-only segment files.

    This is a storage BACKEND: it replays raw records and appends raw lines;
    supersede semantics, in-memory views, and the public store API stay in
    ``repro_torch.core.campaign.CampaignStore``, which delegates here when
    the store is segmented.
    """

    def __init__(self, path: str, *, readonly: bool = False):
        self.path = path
        self.dir = segments_dir(path)
        self.readonly = readonly
        self._f = None          # active (unsealed) segment file handle
        self._sid: Optional[str] = None
        self._seq = 0
        self._n_records = 0
        self._cov: dict = {}
        if not os.path.isdir(self.dir):
            if readonly:
                raise FileNotFoundError(
                    f"campaign store {path} does not exist")
            os.makedirs(self.dir, exist_ok=True)
            save_manifest(self.dir, _fresh_manifest())

    # -- replay -------------------------------------------------------------
    def load(self) -> list[dict]:
        """Replay every record in deterministic order: manifest segments in
        manifest (adoption) order, then orphans sorted by filename. Writable
        opens heal orphans — torn tails truncated, then sealed into the
        manifest — and delete folded leftovers; readonly opens change
        nothing on disk."""
        m = load_manifest(self.dir)
        out: list[dict] = []
        listed: set[str] = set()
        for ent in m["segments"]:
            fp = os.path.join(self.dir, ent["file"])
            listed.add(ent["file"])
            if not os.path.exists(fp):
                raise CampaignStoreError(
                    f"{self.path}: manifest names segment {ent['file']} but "
                    "the file is missing")
            size = os.path.getsize(fp)
            recs, valid = read_store_records(fp)
            if size != int(ent["bytes"]) or valid != size:
                raise CampaignStoreError(
                    f"{self.path}: sealed segment {ent['file']} is {size} "
                    f"bytes ({valid} valid), manifest says {ent['bytes']} — "
                    "sealed segments are immutable; refusing to load")
            out.extend(recs)
        folded = set(m["folded"])
        healed = False
        for name in sorted(os.listdir(self.dir)):
            if name in listed or not name.endswith(".jsonl"):
                continue
            sid = name[:-len(".jsonl")]
            fp = os.path.join(self.dir, name)
            if sid in folded:
                # interrupted compaction leftovers: these records already
                # live in the compacted segment — never replay them
                if not self.readonly:
                    os.unlink(fp)
                continue
            recs, valid = read_store_records(fp)   # tolerates a torn tail
            out.extend(recs)
            if self.readonly:
                continue
            if not recs:
                os.unlink(fp)
                continue
            if valid < os.path.getsize(fp):
                with open(fp, "r+b") as f:
                    f.truncate(valid)
            m["segments"].append({
                "id": sid, "file": name, "bytes": valid,
                "records": len(recs), "pairs": _coverage(recs)})
            m["next_seq"] = max(int(m.get("next_seq", 1)), _seq_of(sid) + 1)
            healed = True
            log.warning("%s: healed unsealed segment %s (%d record(s)) — a "
                        "previous writer died before sealing",
                        self.path, name, len(recs))
        if healed:
            save_manifest(self.dir, m)
        return out

    # -- append -------------------------------------------------------------
    def append_line(self, line: str, rec: dict) -> None:
        """Append one already-serialized record to this session's segment
        (opened lazily on first append) and flush it."""
        if self.readonly:
            raise RuntimeError(f"store {self.path} was opened readonly")
        if self._f is None:
            self._open_segment()
        self._f.write(line + "\n")
        self._f.flush()
        self._n_records += 1
        _cov_add(self._cov, rec)

    def _open_segment(self) -> None:
        m = load_manifest(self.dir)
        self._seq = int(m.get("next_seq", 1))
        self._sid = (f"{self._seq:06d}-{os.getpid()}-{next(_SEG_COUNT)}"
                     f"-{os.urandom(2).hex()}")
        self._f = open(os.path.join(self.dir, self._sid + ".jsonl"), "a")

    def close(self) -> None:
        """Seal this session's segment into the manifest (drop it when it
        never received a record). Until this runs the segment is an orphan —
        replayable, healed by the next writable open — so a crash loses at
        most the usual one torn record."""
        if self._f is None:
            return
        self._f.close()
        self._f = None
        fp = os.path.join(self.dir, self._sid + ".jsonl")
        if self._n_records == 0:
            os.unlink(fp)
            self._sid = None
            return
        # re-load: another writer may have sealed its segment meanwhile;
        # last sealer wins the manifest race and the loser's segment comes
        # back as a healed orphan on the next writable open
        m = load_manifest(self.dir)
        if all(e["id"] != self._sid for e in m["segments"]):
            m["segments"].append({
                "id": self._sid, "file": self._sid + ".jsonl",
                "bytes": os.path.getsize(fp), "records": self._n_records,
                "pairs": _cov_list(self._cov)})
        m["next_seq"] = max(int(m.get("next_seq", 1)), self._seq + 1)
        save_manifest(self.dir, m)
        self._sid = None
        self._n_records = 0
        self._cov = {}


# ---------------------------------------------------------------------------
# Incremental merge: adopt whole segments the destination has never seen
# ---------------------------------------------------------------------------


def _source_segments(src: str) -> Iterator[tuple[str, str, Optional[int]]]:
    """Yield ``(segment_id, file_path, sealed_bytes)`` for a merge source in
    replay order; ``sealed_bytes`` is None for unsealed/legacy content (adopt
    the valid prefix). Legacy single-file stores yield one content-addressed
    snapshot segment, so re-merging an unchanged file is a no-op and a grown
    file becomes a NEW snapshot whose records supersede the old one at read
    time (compaction reclaims the overlap)."""
    if is_segmented(src):
        sdir = segments_dir(src)
        sm = load_manifest(sdir)
        listed: set[str] = set()
        for ent in sm["segments"]:
            fp = os.path.join(sdir, ent["file"])
            listed.add(ent["file"])
            if not os.path.exists(fp):
                raise CampaignStoreError(
                    f"{src}: manifest names segment {ent['file']} but the "
                    "file is missing")
            yield ent["id"], fp, int(ent["bytes"])
        folded = set(sm["folded"])
        for name in sorted(os.listdir(sdir)):
            if (name.endswith(".jsonl") and name not in listed
                    and name[:-len(".jsonl")] not in folded):
                yield name[:-len(".jsonl")], os.path.join(sdir, name), None
    else:
        _, valid = read_store_records(src)   # validate before snapshotting
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read(valid)).hexdigest()
        yield f"lgcy-{digest[:12]}", src, None


def _copy_prefix(src_fp: str, dst_fp: str, nbytes: int) -> None:
    tmp = f"{dst_fp}.tmp-{os.getpid()}"
    try:
        with open(src_fp, "rb") as s, open(tmp, "wb") as t:
            remaining = nbytes
            while remaining > 0:
                chunk = s.read(min(1 << 20, remaining))
                if not chunk:
                    break
                t.write(chunk)
                remaining -= len(chunk)
        os.replace(tmp, dst_fp)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def adopt_segments(dest: str, sources: Sequence[str]) -> dict:
    """Fold ``sources`` into a segmented ``dest`` by ADOPTING whole segments.

    Every source segment whose id the destination manifest has never seen
    (neither live nor ``folded``) is copied in and appended to the manifest;
    everything else is skipped without reading a byte of record data — the
    incremental-merge contract. Unsealed source segments (a crashed writer's
    orphan) are adopted under a content-suffixed id, so if the source later
    seals that segment with MORE records, the sealed version is adopted too
    and its records supersede the partial snapshot at read time.

    Records never need rewriting because supersede semantics resolve at read
    time; dest-as-source is a no-op. Returns ``{"records_in", "records_out",
    "segments_new", "segments_skipped"}``.
    """
    ddir = segments_dir(dest)
    if not os.path.isdir(ddir):
        os.makedirs(ddir, exist_ok=True)
        save_manifest(ddir, _fresh_manifest())
    m = load_manifest(ddir)
    known = {e["id"] for e in m["segments"]} | set(m["folded"])
    dest_real = os.path.realpath(ddir)
    new = skipped = records_in = 0
    for src in sources:
        if os.path.realpath(segments_dir(src)) == dest_real:
            continue                    # dest as its own source: nothing new
        for sid, fp, sealed_bytes in _source_segments(src):
            if sid in known and sealed_bytes is not None:
                skipped += 1
                continue
            recs, valid = read_store_records(fp)
            if sealed_bytes is not None and valid != sealed_bytes:
                raise CampaignStoreError(
                    f"{src}: sealed segment {os.path.basename(fp)} has only "
                    f"{valid} valid bytes of {sealed_bytes}; refusing to "
                    "adopt a torn sealed segment")
            if sealed_bytes is None:
                # unsealed orphan: content-address the snapshot so a later
                # sealed (grown) version of the same segment is NOT skipped
                if not sid.startswith("lgcy-"):
                    with open(fp, "rb") as f:
                        tail = hashlib.sha256(f.read(valid)).hexdigest()[:8]
                    sid = f"{sid}-t{tail}"
                if sid in known:
                    skipped += 1
                    continue
            if not recs:
                continue
            name = sid + ".jsonl"
            _copy_prefix(fp, os.path.join(ddir, name), valid)
            m["segments"].append({
                "id": sid, "file": name, "bytes": valid,
                "records": len(recs), "pairs": _coverage(recs)})
            m["next_seq"] = max(int(m.get("next_seq", 1)), _seq_of(sid) + 1)
            known.add(sid)
            new += 1
            records_in += len(recs)
    save_manifest(ddir, m)
    return {"records_in": records_in,
            "records_out": sum(int(e.get("records", 0))
                               for e in m["segments"]),
            "segments_new": new, "segments_skipped": skipped}


# ---------------------------------------------------------------------------
# Compaction commit + manifest-driven live status
# ---------------------------------------------------------------------------


def replace_all_segments(path: str, lines: Sequence[str],
                         records: Sequence[dict]) -> dict:
    """The compaction commit: write ``lines`` as ONE new segment, publish a
    manifest whose ``folded`` list names every prior segment id (so an
    interrupted cleanup can never resurrect superseded records, and future
    incremental merges still skip already-folded source segments), then
    delete the old segment files. Returns ``{"bytes_in", "bytes_out",
    "segments_in"}``."""
    sdir = segments_dir(path)
    m = load_manifest(sdir)
    old = m["segments"]
    bytes_in = sum(int(e["bytes"]) for e in old)
    seq = int(m.get("next_seq", 1))
    sid = f"{seq:06d}-compact-{os.getpid()}-{next(_SEG_COUNT)}"
    name = sid + ".jsonl"
    tmp = os.path.join(sdir, f"{name}.tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    os.replace(tmp, os.path.join(sdir, name))
    nbytes = os.path.getsize(os.path.join(sdir, name))
    save_manifest(sdir, {
        "segment_store": SEGMENT_SCHEMA, "next_seq": seq + 1,
        "segments": [{"id": sid, "file": name, "bytes": nbytes,
                      "records": len(records), "pairs": _coverage(records)}],
        "folded": sorted(set(m["folded"]) | {e["id"] for e in old})})
    for ent in old:
        try:
            os.unlink(os.path.join(sdir, ent["file"]))
        except FileNotFoundError:
            pass
    return {"bytes_in": bytes_in, "bytes_out": nbytes,
            "segments_in": len(old)}


def manifest_status(path: str) -> dict:
    """Live store status from the manifest ALONE — no segment file is read,
    so ``fleet watch`` can poll this every couple of seconds against a store
    that active writers are appending to. Returns segment/record/byte totals,
    unsealed-orphan counts (live or crashed writers), and aggregated
    per-(region, mode) pair coverage ``{(r, m): {"points": n, "done": b,
    "quarantined": n}}`` from the sealed segments' coverage entries."""
    sdir = segments_dir(path)
    m = load_manifest(sdir)
    pairs: dict[tuple, dict] = {}
    verdicts: dict[tuple, dict] = {}
    records = nbytes = 0
    for ent in m["segments"]:
        records += int(ent.get("records", 0))
        nbytes += int(ent.get("bytes", 0))
        for c in ent.get("pairs", []):
            key = (c.get("region"), c.get("mode"))
            p = pairs.setdefault(key, {"points": 0, "done": False,
                                       "quarantined": 0})
            p["points"] += int(c.get("points", 0))
            p["done"] = p["done"] or bool(c.get("done"))
            # segments are listed in seal order, so a later segment's
            # verdict for the same k supersedes (a healed point clears
            # its quarantine)
            verdicts.setdefault(key, {}).update(c.get("quality", {}))
    for key, per_k in verdicts.items():
        pairs[key]["quarantined"] = sum(
            1 for v in per_k.values() if v == "quarantine")
    listed = {e["file"] for e in m["segments"]}
    folded = set(m["folded"])
    orphans = orphan_bytes = 0
    for name in os.listdir(sdir):
        if (name.endswith(".jsonl") and name not in listed
                and name[:-len(".jsonl")] not in folded):
            orphans += 1
            orphan_bytes += os.path.getsize(os.path.join(sdir, name))
    return {"segments": len(m["segments"]), "records": records,
            "bytes": nbytes, "orphans": orphans,
            "orphan_bytes": orphan_bytes, "pairs": pairs}
