"""Campaign engine — persistent, resumable noise-injection sweeps.

PyTorch port of the reference's campaign engine (single-file layout). For
every (region, mode) pair a k-sweep of wall-times is appended to a JSONL
store the moment each point exists; re-running first replays the store, so
completed sweeps are rebuilt with ZERO new measurements and partial sweeps
resume at the first missing k. Independent (region, mode) sweeps may fan out
over a thread pool; timed sections serialize through one lock.

Records are byte-compatible with the reference package — the same kinds,
keys, key order and ``json.dumps`` formatting — so a store either package
writes loads (and replays) in the other. Schema (one JSON object per line):
  {"kind": "meta",   "region": r, "mode": m, "reps": n, "compile_once": b}
  {"kind": "sens",   "region": r, "mode": m, "value": s}
  {"kind": "point",  "region": r, "mode": m, "k": k, "t": seconds}  # raw t
  {"kind": "done",   "region": r, "mode": m, "ks": [...], "drift": f|null,
   "stopped_early": b, "payload": {...}|null}
  {"kind": "region", "region": r, "body_size": n}
  {"kind": "quality", "region": r, "mode": m, "k": k, "verdict": "valid"
   |"quarantine", "reason": ..., "spread": f|null, "reps": n, "detail": s}
  {"kind": "decan",  "region": r, "variant": v, "t": seconds, "reps": n,
   "inner": n}                                  # Campaign.run_decan
  {"kind": "pred",   "region": r, "mode": m, "ks": [...], "ts": [...],
   "fit": {...}, "hw": {...}, "terms": {...}, "alpha": a, "tol": t,
   "k_max": n}                                  # AnalyticCampaign
``audit`` records (the static noise audit, ``fleet.executor.
audit_fleet_plan``) and ``calib`` records (``core.calibration``) are kept
under the reference's supersede rules, so a reference store reads alike.

Supersede rules: later records supersede earlier ones for the same key; a
"meta" record whose settings differ from the pair's current meta discards
the pair's accumulated sens/point/done/audit/quality records.

Points persist RAW; the two-point drift correction is applied at
curve-assembly time using the factor recorded in the "done" marker, so
replayed curves reproduce the original run exactly.

Durability: a process killed mid-append leaves a truncated final line; the
loader drops it ("loses at most one point"). A torn append that flushed the
whole record but not its newline is healed in place. Corruption BEFORE the
final record hard-fails. ``CampaignStore(path, readonly=True)`` loads
without creating, healing, or truncating anything.

Fan-out: ``worker_store`` names a shard's store, ``merge_stores`` folds
worker stores into one canonical store (sources in argument order, later
ones superseding; records written in a canonical sorted order with sorted
keys, so a merge is idempotent and matches the reference's byte for byte),
and ``compact_store`` rewrites a store without its superseded records.
``python -m repro_torch.core.campaign merge|inspect`` is the CLI.

Not ported yet: the segmented layout (refused wherever a store is opened
or merged).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.core import decan as decan_mod
from repro_torch.core.absorption import (DEFAULT_KS, STOP_CONSECUTIVE,
                                         AbsorptionFit, MeasureTimeout,
                                         absorption, assemble_curve,
                                         floor_time, measure, measure_sample)
from repro_torch.core.analytic import (StepTerms, predict_absorption,
                                       predict_curve)
from repro_torch.core.classifier import HIGH, LOW, BottleneckReport, classify
from repro_torch.core.controller import (Controller, ModeResult, RegionReport,
                                         RegionTarget, derive_body_size)
from repro_torch.core.payload import InjectionReport
from repro_torch.core.quality import (REASON_DRIFT_SPAN, REASON_TIMEOUT,
                                      QualityPolicy, RemeasureBudget,
                                      VERDICT_QUARANTINE, measure_quality)

log = logging.getLogger("repro_torch.campaign")


class CampaignStoreError(RuntimeError):
    """A store is corrupt in a way the loader must not paper over."""


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
            pos += len(raw)
            if bad is None:
                valid = pos
    if bad is not None:
        log.warning(
            "%s: dropping truncated final record (%d bytes) — a previous "
            "run died mid-append", path, bad[1])
    return records, valid


def _meta_settings(rec: dict) -> dict:
    """The measurement-settings payload of a meta record (key fields off)."""
    return {f: v for f, v in rec.items()
            if f not in ("kind", "region", "mode")}


def segments_dir(path: str) -> str:
    """Where the reference's segmented layout would keep a store:
    ``base.jsonl`` -> ``base.segments``."""
    return os.path.splitext(path)[0] + ".segments"


def _refuse_segmented(path: str) -> None:
    if os.path.isdir(segments_dir(path)):
        raise CampaignStoreError(
            f"{path}: a segmented store exists here; this package reads "
            "the single-file layout only")


def store_exists(path: str) -> bool:
    """True when a store exists at ``path`` (a segment directory counts, so
    callers see it and the store refuses it when opened)."""
    return os.path.exists(path) or os.path.isdir(segments_dir(path))


def remove_store(path: str) -> None:
    """Delete the store file at ``path``; a segmented store is refused."""
    _refuse_segmented(path)
    if os.path.exists(path):
        os.unlink(path)


def worker_store(path: str, index: int, count: int) -> str:
    """Per-worker store naming for fan-out: ``base.jsonl`` ->
    ``base.w0of2.jsonl``."""
    base, ext = os.path.splitext(path)
    return f"{base}.w{index}of{count}{ext or '.jsonl'}"


def host_store(path: str, host: str) -> str:
    """Per-HOST namespacing of a store path: ``base.jsonl`` ->
    ``base.h<host>-<hash6>.jsonl`` (host sanitized to filename-safe
    characters, plus a short hash of the raw host name, so two hosts whose
    sanitized names agree still get distinct staging files)."""
    base, ext = os.path.splitext(path)
    tag = "".join(c if c.isalnum() or c in "._-" else "-" for c in host)
    h = hashlib.sha256(host.encode("utf-8")).hexdigest()[:6]
    return f"{base}.h{tag}-{h}{ext or '.jsonl'}"


@dataclasses.dataclass(frozen=True)
class PairStatus:
    """Grid completeness of one (region, mode) pair: the points present,
    the points the sweep's ``done`` marker promised, and which of those are
    missing (a truncated store)."""
    points: int                       # point records present
    expected: Optional[int]           # len(done ks); None until done-marked
    done: bool                        # a "done" marker exists
    missing: tuple[int, ...] = ()     # done-promised ks with no point record
    quarantined: tuple[int, ...] = ()  # ks whose quality record condemns them

    @property
    def complete(self) -> bool:
        """Replayable with zero new measurements."""
        return self.done and not self.missing


class CampaignStore:
    """Append-only measurement store, loaded eagerly on open.

    Thread-safe: appends take a lock and flush immediately, so the on-disk
    store is never more than one record behind the in-memory view.

    The port reads and writes the single-file JSONL layout; a path whose
    segment directory (``<base>.segments``) exists is refused, since the
    segmented layout is not ported yet.
    """

    def __init__(self, path: str, *, readonly: bool = False):
        self.path = path
        self.points: dict[tuple[str, str], dict[int, float]] = {}
        self.sens: dict[tuple[str, str], float] = {}
        self.done: dict[tuple[str, str], dict] = {}
        self.meta: dict[tuple[str, str], dict] = {}
        self.preds: dict[tuple[str, str], dict] = {}
        self.decan: dict[tuple[str, str], dict] = {}
        self.audits: dict[tuple[str, str], dict] = {}
        self.quality: dict[tuple[str, str], dict[int, dict]] = {}
        self.calib: dict[str, dict] = {}
        self.body_sizes: dict[str, int] = {}
        self._lock = threading.Lock()
        self._f = None
        _refuse_segmented(path)
        has_file = os.path.exists(path)
        if readonly and not has_file:
            raise FileNotFoundError(f"campaign store {path} does not exist")
        if has_file:
            records, valid = read_store_records(path)
            for rec in records:
                self._ingest(rec)
            if not readonly:
                if valid < os.path.getsize(path):
                    with open(path, "r+b") as f:  # drop the torn tail for
                        f.truncate(valid)         # good: appends start clean
                elif valid and not self._ends_with_newline(path):
                    # torn append that DID flush the whole record but not its
                    # newline: the record is intact (JSON is self-delimiting)
                    # — heal the terminator so the next append starts a line
                    with open(path, "ab") as f:
                        f.write(b"\n")
        if readonly:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")

    @staticmethod
    def _ends_with_newline(path: str) -> bool:
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            return f.read(1) == b"\n"

    def _ingest(self, rec: dict) -> None:
        kind = rec.get("kind")
        key = (rec.get("region"), rec.get("mode"))
        if kind == "point":
            self.points.setdefault(key, {})[int(rec["k"])] = float(rec["t"])
        elif kind == "sens":
            self.sens[key] = float(rec["value"])
        elif kind == "done":
            self.done[key] = rec
        elif kind == "meta":
            old = self.meta.get(key)
            if old is not None and _meta_settings(old) != _meta_settings(rec):
                # a settings change mid-file means the old pair was discarded
                self._drop_measured(key)
            self.meta[key] = rec
        elif kind == "region":
            self.body_sizes[rec["region"]] = int(rec["body_size"])
        elif kind == "pred":
            self.preds[key] = rec
        elif kind == "decan":
            self.decan[(rec.get("region"), rec.get("variant"))] = rec
        elif kind == "audit":
            self.audits[key] = rec
        elif kind == "quality":
            self.quality.setdefault(key, {})[int(rec["k"])] = rec
        elif kind == "calib":
            self.calib[str(rec.get("hw", ""))] = rec

    def append(self, rec: dict) -> None:
        """Ingest one record and flush it to disk (locked; readonly stores
        refuse)."""
        if self._f is None:
            raise RuntimeError(f"store {self.path} was opened readonly")
        with self._lock:
            self._ingest(rec)
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        """Close the append handle (no-op for readonly stores)."""
        if self._f is not None:
            self._f.close()

    # convenience views ----------------------------------------------------
    def stored_ts(self, region: str, mode: str) -> dict[int, float]:
        """The pair's stored {k: wall-time} points (empty when unmeasured)."""
        return self.points.get((region, mode), {})

    def is_done(self, region: str, mode: str) -> bool:
        """True when the pair's sweep wrote its ``done`` marker."""
        return (region, mode) in self.done

    def quarantined_ks(self, region: str, mode: str) -> tuple[int, ...]:
        """The pair's ks condemned by a quarantine quality record (a later
        valid record for the same k clears it — supersede last-wins)."""
        q = self.quality.get((region, mode), {})
        return tuple(sorted(k for k, rec in q.items()
                            if rec.get("verdict") == "quarantine"))

    def pair_status(self, region: str, mode: str) -> PairStatus:
        """Completeness of one (region, mode) pair (see ``PairStatus``)."""
        key = (region, mode)
        pts = self.points.get(key, {})
        quar = self.quarantined_ks(region, mode)
        rec = self.done.get(key)
        if rec is None:
            return PairStatus(points=len(pts), expected=None, done=False,
                              quarantined=quar)
        ks = [int(k) for k in rec["ks"]]
        return PairStatus(points=len(pts), expected=len(ks), done=True,
                          missing=tuple(k for k in ks if k not in pts),
                          quarantined=quar)

    def grid_status(self, pairs: Sequence[tuple[str, str]]
                    ) -> dict[tuple[str, str], PairStatus]:
        """Completeness of every (region, mode) pair in an expected grid —
        what a fleet executor asks of worker stores to decide which shards
        still need (re)launching."""
        return {(r, m): self.pair_status(r, m) for r, m in pairs}

    def _drop_measured(self, key: tuple[str, str]) -> None:
        # audits and quality records are settings-scoped evidence measured
        # alongside the pair: stale ones must not feed apply_audit_evidence /
        # apply_quality_evidence after a re-measure. preds carry their own
        # settings inline and supersede independently.
        for d in (self.points, self.sens, self.done, self.audits,
                  self.quality):
            d.pop(key, None)

    def discard(self, region: str, mode: str) -> None:
        """Drop a pair's in-memory measured data (pred/decan records carry
        their own settings and stay); the file keeps the old lines — this
        run's fresh appends supersede them on the next load."""
        self._drop_measured((region, mode))
        self.meta.pop((region, mode), None)


# ---------------------------------------------------------------------------
# Multi-store fan-out: merge worker stores into one canonical store
# ---------------------------------------------------------------------------

_KIND_ORDER = {"meta": 0, "sens": 1, "point": 2, "done": 3, "region": 4,
               "decan": 5, "pred": 6, "audit": 7, "quality": 8, "calib": 9}


def _canon_line(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True)


def _canon_sort_key(rec: dict) -> tuple:
    return (str(rec.get("region", "")),
            str(rec.get("mode", rec.get("variant", ""))),
            _KIND_ORDER.get(rec.get("kind"), 99),
            int(rec.get("k", -1)),
            _canon_line(rec))


@dataclasses.dataclass
class MergeStats:
    """What ``merge_stores`` did: sources read, records in/out, and the
    (region, mode) pairs whose meta conflicted (the later source won)."""
    sources: int = 0
    records_in: int = 0
    records_out: int = 0
    conflicts: list = dataclasses.field(default_factory=list)  # (region, mode)

    def __str__(self) -> str:
        s = (f"merged {self.records_in} records from {self.sources} stores "
             f"into {self.records_out}")
        if self.conflicts:
            s += (f"; {len(self.conflicts)} pair(s) re-measured under newer "
                  f"settings won: {sorted(set(self.conflicts))}")
        return s


class _MergeView:
    """Raw-record mirror of CampaignStore's supersede semantics: the same
    ingest rules, but keeping the winning record verbatim so the merged file
    reproduces byte-exact replays."""

    def __init__(self, stats: MergeStats):
        self.meta: dict[tuple, dict] = {}
        self.sens: dict[tuple, dict] = {}
        self.points: dict[tuple, dict[int, dict]] = {}
        self.done: dict[tuple, dict] = {}
        self.preds: dict[tuple, dict] = {}
        self.regions: dict[str, dict] = {}
        self.decan: dict[tuple, dict] = {}
        self.audits: dict[tuple, dict] = {}
        self.quality: dict[tuple, dict[int, dict]] = {}
        self.calib: dict[str, dict] = {}
        self.other: dict[str, dict] = {}
        self.stats = stats

    def ingest(self, rec: dict) -> None:
        self.stats.records_in += 1
        kind = rec.get("kind")
        key = (rec.get("region"), rec.get("mode"))
        if kind == "point":
            self.points.setdefault(key, {})[int(rec["k"])] = rec
        elif kind == "sens":
            self.sens[key] = rec
        elif kind == "done":
            self.done[key] = rec
        elif kind == "meta":
            old = self.meta.get(key)
            if old is not None and _meta_settings(old) != _meta_settings(rec):
                log.warning(
                    "merge: %s/%s measured under %s and %s; keeping the "
                    "later store's sweep", key[0], key[1],
                    _meta_settings(old), _meta_settings(rec))
                self.stats.conflicts.append(key)
                # mirror CampaignStore._drop_measured: stale audit/quality
                # evidence from the superseded settings must not survive
                for d in (self.points, self.sens, self.done, self.audits,
                          self.quality):
                    d.pop(key, None)
            self.meta[key] = rec
        elif kind == "region":
            self.regions[rec["region"]] = rec
        elif kind == "pred":
            self.preds[key] = rec
        elif kind == "decan":
            self.decan[(rec.get("region"), rec.get("variant"))] = rec
        elif kind == "audit":
            self.audits[key] = rec
        elif kind == "quality":
            self.quality.setdefault(key, {})[int(rec["k"])] = rec
        elif kind == "calib":
            self.calib[str(rec.get("hw", ""))] = rec
        else:
            self.other[_canon_line(rec)] = rec   # unknown: keep, dedup exact

    def records(self) -> list[dict]:
        out: list[dict] = []
        out.extend(self.meta.values())
        out.extend(self.sens.values())
        for per_k in self.points.values():
            out.extend(per_k.values())
        out.extend(self.done.values())
        out.extend(self.regions.values())
        out.extend(self.decan.values())
        out.extend(self.preds.values())
        out.extend(self.audits.values())
        for per_k in self.quality.values():
            out.extend(per_k.values())
        out.extend(self.calib.values())
        out.extend(self.other.values())
        return sorted(out, key=_canon_sort_key)


# concurrent merges to the same dest never share a tmp name: each call gets a
# pid+counter-unique one (the last os.replace still wins the dest)
_MERGE_TMP_COUNT = itertools.count()


def merge_stores(dest: str, sources: Sequence[str]) -> MergeStats:
    """Fold worker stores into one canonical store at ``dest``.

    Sources stream in argument order, so later sources supersede earlier
    ones under the schema's supersede / meta-conflict rules; the output is
    written with records in a canonical sort order and canonical key order,
    then atomically renamed over ``dest``. Merging is idempotent (re-merging
    the output is a byte-level no-op), order-independent when the sources'
    keys are disjoint, and safe when ``dest`` is itself a source. Segmented
    stores are refused (the layout is not ported)."""
    for path in (dest, *sources):
        _refuse_segmented(path)
    stats = MergeStats(sources=len(sources))
    view = _MergeView(stats)
    d = os.path.dirname(dest)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{dest}.merge-tmp.{os.getpid()}.{next(_MERGE_TMP_COUNT)}"
    try:
        with open(tmp, "w") as f:
            # a corrupt source (CampaignStoreError) aborts mid-merge; the
            # finally removes the tmp, so ``dest`` only ever sees the atomic
            # rename of a COMPLETE merge
            for src in sources:
                for rec in read_store_records(src)[0]:
                    view.ingest(rec)
            records = view.records()
            stats.records_out = len(records)
            for rec in records:
                f.write(_canon_line(rec) + "\n")
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return stats


@dataclasses.dataclass
class CompactStats:
    """What ``compact_store`` reclaimed."""
    records_in: int = 0
    records_out: int = 0
    bytes_in: int = 0
    bytes_out: int = 0

    def __str__(self) -> str:
        pct = 1.0 - (self.bytes_out / self.bytes_in) if self.bytes_in else 0.0
        return (f"compacted {self.records_in} -> {self.records_out} "
                f"record(s), {self.bytes_in} -> {self.bytes_out} bytes "
                f"({pct:.0%} reclaimed)")


def compact_store(path: str) -> CompactStats:
    """Rewrite a store in place with superseded and discarded records
    dropped (the canonical full merge of the store into itself). Do not
    compact a store a live writer is appending to."""
    if not store_exists(path):
        raise FileNotFoundError(f"campaign store {path} does not exist")
    bytes_in = os.path.getsize(path) if os.path.exists(path) else 0
    ms = merge_stores(path, [path])
    return CompactStats(records_in=ms.records_in, records_out=ms.records_out,
                        bytes_in=bytes_in, bytes_out=os.path.getsize(path))


@dataclasses.dataclass
class CampaignStats:
    """A campaign run's measure-vs-replay tally (the ``--expect-no-measure``
    contract checks ``measured == 0``)."""
    measured: int = 0      # freshly timed points (incl. sensitivity probes)
    cached: int = 0        # points replayed from the store


class Campaign:
    """Resumable measurement campaign over RegionTargets × noise modes.

    ``workers`` > 1 fans independent (region, mode) sweeps across a thread
    pool; every timed section still serializes through one lock (wall-clock
    measurements on a shared machine must not overlap), so extra workers buy
    back the compile/verify time, which dominates on the trace-per-k fallback
    path and still bounds campaign latency on the compile-once path.

    ``measure_pairs``/``measure_shard`` measure one worker's slice of a
    grid; ``merge_stores`` folds the workers' stores into one.
    """

    def __init__(self, store: CampaignStore | str,
                 controller: Optional[Controller] = None, *,
                 workers: int = 1,
                 quality: Optional[QualityPolicy] = None,
                 remeasure: Optional[RemeasureBudget] = None,
                 heal_quarantined: bool = True,
                 thresholds: Optional[tuple[float, float]] = None):
        self.store = store if isinstance(store, CampaignStore) \
            else CampaignStore(store)
        self.ctl = controller if controller is not None else Controller()
        self.workers = max(1, int(workers))
        # the runtime measurement-integrity guard: with a QualityPolicy,
        # every fresh point is dispersion-gated (re-measured under the
        # RemeasureBudget, quarantined when it won't settle), baseline
        # sentinels interleave when the policy asks, and the watchdog
        # deadline turns a hung kernel into a recorded timeout quarantine.
        # heal_quarantined makes resume re-measure previously-quarantined
        # points (pass False for a replay that must not measure).
        self.quality = quality
        self.remeasure = remeasure if remeasure is not None \
            else (RemeasureBudget() if quality is not None else None)
        self.heal_quarantined = bool(heal_quarantined)
        # the effective (low, high) classification thresholds; None keeps
        # the paper defaults
        self.thresholds = thresholds
        self.stats = CampaignStats()
        self._measure_lock = threading.Lock()
        self._stats_lock = threading.Lock()

    def _note(self, *, measured: int = 0, cached: int = 0) -> None:
        with self._stats_lock:
            self.stats.measured += measured
            self.stats.cached += cached

    # -- one (region, mode) sweep, store-backed -----------------------------
    def _check_meta(self, target: RegionTarget, mode: str) -> None:
        """Stored timings are only reusable under the same measurement
        settings; on mismatch, discard the pair and remeasure."""
        key = (target.name, mode)
        cur = {"reps": self.ctl.reps,
               "compile_once": self.ctl._rt_fn(target, mode) is not None}
        old = self.store.meta.get(key)
        if old is not None and any(old.get(f) != cur[f] for f in cur):
            log.warning(
                "campaign store for %s/%s was measured with %s, current "
                "settings are %s; discarding stored sweep and remeasuring",
                target.name, mode,
                {f: old.get(f) for f in cur}, cur)
            self.store.discard(*key)
        if self.store.meta.get(key) is None:
            self.store.append({"kind": "meta", "region": target.name,
                               "mode": mode, **cur})

    def _sensitivity(self, target: RegionTarget, mode: str) -> float:
        key = (target.name, mode)
        if key in self.store.sens:
            return self.store.sens[key]
        # before t(0) is known only the watchdog floor applies — enough to
        # keep a kernel that hangs on its very first call from parking the
        # shard forever (the timeout is recorded by sweep_mode's caller)
        dl = self._deadline(None)
        with self._measure_lock:
            s = self.ctl.probe_sensitivity(target, mode, deadline=dl)
        self._note(measured=2)   # t0 + t(probe_k)
        self.store.append({"kind": "sens", "region": target.name,
                           "mode": mode, "value": s})
        return s

    def _deadline(self, t0: Optional[float]) -> Optional[float]:
        """The quality policy's per-point watchdog deadline (None when no
        policy is set or its watchdog is off)."""
        if self.quality is None:
            return None
        return self.quality.deadline(t0, stop_ratio=self.ctl.stop_ratio,
                                     reps=self.ctl.reps, warmup=2)

    def _point_fn(self, target: RegionTarget, mode: str, fn_rt, k: int):
        if fn_rt is not None:
            return fn_rt, (int(k), *target.args_for_rt(mode))
        return target.build(mode, k), target.args_for(mode, k)

    def _quality_rec(self, region: str, mode: str, k: int, verdict: str,
                     reason: Optional[str], *, spread: Optional[float] = None,
                     reps: Optional[int] = None,
                     detail: Optional[str] = None) -> None:
        self.store.append({"kind": "quality", "region": region, "mode": mode,
                           "k": int(k), "verdict": verdict, "reason": reason,
                           "spread": spread, "reps": reps, "detail": detail})

    def _sentinel(self, target: RegionTarget, mode: str, fn_rt, k0: int,
                  t0: float, span: list[int], sentinels: list[dict]) -> None:
        """Interleaved baseline sentinel: re-time k=k0 mid-sweep (the
        generalization of the end-of-sweep two-point drift check). A reading
        outside ``sentinel_tol`` means something changed under the sweep —
        quarantine ONLY the span of fresh points since the last sentinel."""
        fn, a = self._point_fn(target, mode, fn_rt, k0)
        with self._measure_lock:
            t = measure(fn, a, reps=max(self.ctl.reps - 2, 2),
                        deadline=self._deadline(t0))
        self._note(measured=1)
        ratio = t / floor_time(t0, f"campaign({target.name}/{mode}) t(k=0)")
        ok = abs(ratio - 1.0) <= self.quality.sentinel_tol
        sentinels.append({"after_k": int(span[-1]) if span else int(k0),
                          "ratio": ratio, "ok": ok})
        if not ok and span:
            log.warning(
                "campaign %s/%s: baseline sentinel read %.3gx t(0) "
                "mid-sweep; quarantining the affected span ks=%s",
                target.name, mode, ratio, span)
            for qk in span:
                self._quality_rec(target.name, mode, qk, VERDICT_QUARANTINE,
                                  REASON_DRIFT_SPAN,
                                  detail=f"sentinel ratio {ratio:.4g}")
        span.clear()

    def sweep_mode(self, target: RegionTarget, mode: str) -> ModeResult:
        """Measure (or replay) the k-sweep for one (region, mode) pair."""
        key = (target.name, mode)
        self._check_meta(target, mode)
        if self.store.is_done(*key):
            return self._replay(target, mode)

        try:
            ks = self.ctl._ks_for(self._sensitivity(target, mode))
        except MeasureTimeout as e:
            # the sensitivity probe (k=0 / probe_k) hung: record the timeout
            # against k=0 so doctor can explain it, then surface the error —
            # with no k grid there is nothing to sweep or mark done
            self._note(measured=1)
            self._quality_rec(target.name, mode, 0, VERDICT_QUARANTINE,
                              REASON_TIMEOUT, detail=str(e))
            raise
        stored = dict(self.store.stored_ts(*key))
        if self.quality is not None and self.heal_quarantined:
            for qk in self.store.quarantined_ks(*key):
                stored.pop(qk, None)     # quarantined points re-measure
        fn_rt = self.ctl._rt_fn(target, mode)

        out_ks: list[int] = []
        out_ts: list[float] = []
        n_over = 0
        n_fresh = 0
        stopped = False
        timed_out: list[int] = []
        sentinels: list[dict] = []
        span: list[int] = []         # fresh ks since the last sentinel
        since_sentinel = 0
        for k in ks:
            if k in stored:
                t = stored[k]
                self._note(cached=1)
            elif self.quality is None:
                fn, a = self._point_fn(target, mode, fn_rt, k)
                with self._measure_lock:
                    t = measure(fn, a, reps=self.ctl.reps)
                self._note(measured=1)
                n_fresh += 1
                self.store.append({"kind": "point", "region": target.name,
                                   "mode": mode, "k": k, "t": t})
            else:
                # quality-guarded point: dispersion-gated sample under the
                # re-measure budget, on a watchdog deadline derived from
                # the worst time the online stop rule would accept
                fn, a = self._point_fn(target, mode, fn_rt, k)
                deadline = self._deadline(out_ts[0] if out_ts else None)

                def once(n: int, _fn=fn, _a=a, _dl=deadline):
                    return measure_sample(_fn, _a, reps=n, deadline=_dl)

                try:
                    with self._measure_lock:
                        sample, verdict, reason = measure_quality(
                            once, reps=self.ctl.reps, policy=self.quality,
                            budget=self.remeasure)
                except MeasureTimeout as e:
                    self._note(measured=1)
                    log.warning("campaign %s/%s k=%d: %s — recording a "
                                "timeout quarantine and ending the sweep",
                                target.name, mode, k, e)
                    self._quality_rec(target.name, mode, k,
                                      VERDICT_QUARANTINE, REASON_TIMEOUT,
                                      reps=self.ctl.reps, detail=str(e))
                    timed_out.append(k)
                    break      # the executable hung; later ks would too
                self._note(measured=1)
                n_fresh += 1
                t = sample.t
                self.store.append({"kind": "point", "region": target.name,
                                   "mode": mode, "k": k, "t": t,
                                   "spread": sample.spread})
                self._quality_rec(target.name, mode, k, verdict, reason,
                                  spread=sample.spread,
                                  reps=len(sample.reps))
                span.append(k)
                since_sentinel += 1
                if (self.quality.sentinel_every and out_ts
                        and since_sentinel >= self.quality.sentinel_every):
                    self._sentinel(target, mode, fn_rt, out_ks[0], out_ts[0],
                                   span, sentinels)
                    since_sentinel = 0
            out_ks.append(k)
            out_ts.append(t)
            # same online saturation rule as absorption.sweep
            if t / floor_time(out_ts[0], f"campaign({target.name}/{mode}) "
                              "t(k=0)") > self.ctl.stop_ratio:
                n_over += 1
                if n_over >= STOP_CONSECUTIVE:
                    stopped = True
                    break
            else:
                n_over = 0

        # two-point drift correction (absorption.sweep's behaviour), only
        # when the whole series was measured in THIS run — a drift factor is
        # meaningless across sessions (and pointless after a timeout, whose
        # resume re-measures the pair anyway). Raw points stay raw in the
        # store; the factor is recorded so replays reproduce this curve.
        drift = None
        if n_fresh == len(out_ks) and len(out_ts) > 2 and not timed_out:
            fn, a = self._point_fn(target, mode, fn_rt, out_ks[0])
            with self._measure_lock:
                t0_end = measure(fn, a, reps=max(self.ctl.reps - 2, 2),
                                 deadline=self._deadline(out_ts[0]))
            self._note(measured=1)
            drift = t0_end / floor_time(
                out_ts[0], f"campaign({target.name}/{mode}) t(k=0)")

        inj = self.ctl.verify_mode_payload(target, mode, out_ks) \
            if self.ctl.verify_payload and out_ks else None
        rec = {
            "kind": "done", "region": target.name, "mode": mode,
            "ks": out_ks + timed_out, "stopped_early": stopped,
            "drift": drift,
            "payload": dataclasses.asdict(inj) if inj is not None else None}
        if sentinels:
            rec["sentinels"] = sentinels
        # the done marker is written even after a timeout: its ks then
        # include the hung point, so the pair reads INCOMPLETE (missing k)
        # and resume re-enters the measuring path instead of replaying
        self.store.append(rec)
        if not out_ts:
            raise MeasureTimeout(
                f"campaign {target.name}/{mode}: the first attempted point "
                f"(k={timed_out[0]}) hit its watchdog deadline; no curve")
        return self._assemble_mode(mode, out_ks, out_ts, drift, stopped, inj)

    def _assemble_mode(self, mode, ks, ts, drift, stopped, inj) -> ModeResult:
        curve = assemble_curve(mode, ks, ts, drift=drift,
                               stopped_early=stopped)
        return ModeResult(mode=mode, curve=curve,
                          fit=absorption(curve, tol=self.ctl.tol),
                          injection=inj)

    def _replay(self, target: RegionTarget, mode: str) -> ModeResult:
        rec = self.store.done[(target.name, mode)]
        ts = self.store.stored_ts(target.name, mode)
        ks = [int(k) for k in rec["ks"]]
        missing = [k for k in ks if k not in ts]
        heal: list[int] = []
        if self.quality is not None and self.heal_quarantined:
            heal = [k for k in self.store.quarantined_ks(target.name, mode)
                    if k not in missing]
        if missing or heal:   # truncated store / condemned points: re-enter
            log.warning("campaign store for %s/%s lost points %s, "
                        "quarantined %s; remeasuring",
                        target.name, mode, missing, heal)
            del self.store.done[(target.name, mode)]
            return self.sweep_mode(target, mode)
        self._note(cached=len(ks))
        inj = InjectionReport(**rec["payload"]) if rec.get("payload") else None
        return self._assemble_mode(mode, ks, [ts[k] for k in ks],
                                   rec.get("drift"),
                                   bool(rec.get("stopped_early")), inj)

    # -- DECAN variants, store-backed ---------------------------------------
    def run_decan(self, target, *, inner: int = 1):
        """Measure (or replay) DECAN variant timings through this campaign's
        store: ``decan`` records keyed (region, variant), superseded when
        reps/inner change."""
        return decan_mod.run_decan(target, reps=self.ctl.reps, inner=inner,
                                   store=self.store,
                                   lock=self._measure_lock, stats=self.stats)

    # -- region / campaign level --------------------------------------------
    def _body_size(self, target: RegionTarget) -> int:
        if target.body_size:
            return target.body_size
        if target.name in self.store.body_sizes:
            return self.store.body_sizes[target.name]
        body = derive_body_size(target)
        self.store.append({"kind": "region", "region": target.name,
                           "body_size": body})
        return body

    def _assemble_region(self, target: RegionTarget,
                         results: dict[str, ModeResult]) -> RegionReport:
        low, high = self.thresholds if self.thresholds is not None \
            else (LOW, HIGH)
        report = classify({m: r.fit.k1 for m, r in results.items()},
                          low=low, high=high)
        return RegionReport(region=target.name, results=results,
                            bottleneck=report,
                            body_size=self._body_size(target))

    def _pooled_sweeps(self, pairs):
        """Run (target, mode) sweeps, fanned over the pool when enabled."""
        if self.workers > 1 and len(pairs) > 1:
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                futs = [pool.submit(self.sweep_mode, t, m) for t, m in pairs]
                return {(t.name, m): f.result()
                        for (t, m), f in zip(pairs, futs)}
        return {(t.name, m): self.sweep_mode(t, m) for t, m in pairs}

    def characterize(self, target: RegionTarget,
                     modes: Sequence[str]) -> RegionReport:
        """Store-backed equivalent of ``Controller.characterize``: mode sweeps
        fan out over the worker pool, completed sweeps replay from disk."""
        res = self._pooled_sweeps([(target, m) for m in modes])
        return self._assemble_region(
            target, {m: res[(target.name, m)] for m in modes})

    def run(self, targets: Sequence[RegionTarget],
            modes: Sequence[str]) -> dict[str, RegionReport]:
        """Characterize every region; (region, mode) pairs share one pool."""
        res = self._pooled_sweeps([(t, m) for t in targets for m in modes])
        return {t.name: self._assemble_region(
                    t, {m: res[(t.name, m)] for m in modes})
                for t in targets}

    def measure_pairs(self, pairs: Sequence[tuple[RegionTarget, str]], *,
                      index: int = 0, count: int = 1
                      ) -> dict[tuple[str, str], ModeResult]:
        """Measure this worker's slice of an explicit (target, mode) grid.

        ``pairs`` is the FULL grid in a canonical order every worker agrees
        on (a SweepPlan's ``pairs()``, or target-major/mode-minor for
        ``measure_shard``); worker ``index`` of ``count`` takes every
        count-th pair, so every pair lands on exactly one worker given
        identical arguments. No classification happens here: a shard sees
        only its slice.
        """
        if not (0 <= index < count):
            raise ValueError(f"shard index {index} not in [0, {count})")
        mine = [p for i, p in enumerate(pairs) if i % count == index]
        res = self._pooled_sweeps(mine)
        # the worker owning a region's FIRST grid pair also records its body
        # size, so a merged store replays without a single build
        seen: set[int] = set()
        for i, (t, _) in enumerate(pairs):
            if id(t) not in seen:
                seen.add(id(t))
                if i % count == index:
                    self._body_size(t)
        return res

    def measure_shard(self, targets: Sequence[RegionTarget],
                      modes: Sequence[str], *, index: int, count: int
                      ) -> dict[tuple[str, str], ModeResult]:
        """``measure_pairs`` over the homogeneous (targets × modes) grid in
        target-major, mode-minor order."""
        return self.measure_pairs([(t, m) for t in targets for m in modes],
                                  index=index, count=count)


# ---------------------------------------------------------------------------
# Analytic campaign: predictions through the same store artifact
# ---------------------------------------------------------------------------


class AnalyticCampaign:
    """Resumable *prediction* campaign: ``core.analytic`` absorption curves
    through the same store machinery as measured sweeps.

    Each (region, mode) prediction persists as ONE self-contained ``pred``
    record (curve + fit + every setting that determined it: HardwareConfig,
    roofline terms, alpha, tol, ks, k_max). Re-running with identical
    settings replays the record byte-identically and computes nothing; any
    settings change recomputes and supersedes. Because the record kinds are
    disjoint, a pred campaign can share its store with a measured campaign —
    measured and predicted curves for a region live in one artifact.
    """

    def __init__(self, store: CampaignStore | str, *, hw, tol: float = 0.05,
                 alpha: float = 1.0, ks: Optional[Sequence[int]] = None,
                 k_max: int = 1 << 20,
                 thresholds: Optional[tuple[float, float]] = None):
        self.store = store if isinstance(store, CampaignStore) \
            else CampaignStore(store)
        self.hw = hw
        self.tol = tol
        self.alpha = alpha
        self.ks = [int(k) for k in (ks if ks is not None else DEFAULT_KS)]
        self.k_max = k_max
        # effective classification thresholds, like Campaign.thresholds
        self.thresholds = thresholds
        self.stats = CampaignStats()

    def _settings(self, terms: StepTerms) -> dict:
        return {"hw": dataclasses.asdict(self.hw), "terms": terms.as_dict(),
                "alpha": self.alpha, "tol": self.tol, "ks": self.ks,
                "k_max": self.k_max}

    def predict_mode(self, region: str, terms: StepTerms, mode) -> ModeResult:
        """Predict (or replay) the absorption curve of one noise mode."""
        cur = self._settings(terms)
        rec = self.store.preds.get((region, mode.name))
        if rec is not None and all(rec.get(f) == cur[f] for f in cur):
            self.stats.cached += len(rec["ks"])
            curve = assemble_curve(mode.name, [int(k) for k in rec["ks"]],
                                   [float(t) for t in rec["ts"]])
            return ModeResult(mode=mode.name, curve=curve,
                              fit=AbsorptionFit(**rec["fit"]))
        fit = predict_absorption(terms, mode, self.hw, tol=self.tol,
                                 alpha=self.alpha, k_max=self.k_max)
        ts = [float(t) for t in
              predict_curve(terms, mode, self.hw, self.ks, alpha=self.alpha)]
        self.store.append({"kind": "pred", "region": region,
                           "mode": mode.name, "ks": self.ks, "ts": ts,
                           "fit": dataclasses.asdict(fit), **cur})
        self.stats.measured += len(self.ks)
        curve = assemble_curve(mode.name, self.ks, ts)
        return ModeResult(mode=mode.name, curve=curve, fit=fit)

    def characterize(self, region: str, terms: StepTerms,
                     modes: Mapping[str, "object"], *,
                     classify_fn: Optional[Callable[
                         [dict[str, ModeResult]], BottleneckReport]] = None
                     ) -> RegionReport:
        """Predict every mode and classify — the analytic mirror of
        ``Campaign.characterize``. ``classify_fn`` overrides the default
        raw-absorption classification."""
        results = {name: self.predict_mode(region, terms, mode)
                   for name, mode in modes.items()}
        if classify_fn is not None:
            report = classify_fn(results)
        else:
            low, high = self.thresholds if self.thresholds is not None \
                else (LOW, HIGH)
            report = classify({m: r.fit.k1 for m, r in results.items()},
                              low=low, high=high)
        return RegionReport(region=region, results=results, bottleneck=report,
                            body_size=0)


# ---------------------------------------------------------------------------
# CLI: merge / inspect stores (the fan-out hosts' rendezvous step)
# ---------------------------------------------------------------------------


def _cli(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.campaign",
        description="campaign store maintenance (merge worker stores, "
                    "inspect contents)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="fold worker stores into one "
                                      "canonical store")
    mp.add_argument("dest")
    mp.add_argument("sources", nargs="+")
    ip = sub.add_parser("inspect", help="summarize one store with per-"
                                        "(region, mode) grid completeness")
    ip.add_argument("path")
    ip.add_argument("--plan", default=None, metavar="PLAN.json",
                    help="a repro_torch.fleet SweepPlan: also check the "
                         "store against the plan's full expected grid (exit "
                         "1 when any pair is missing or incomplete)")
    args = ap.parse_args(argv)

    if args.cmd == "merge":
        stats = merge_stores(args.dest, args.sources)
        print(f"{args.dest}: {stats}")
        return 0
    try:   # readonly: inspecting must neither create nor heal the store
        st = CampaignStore(args.path, readonly=True)
    except FileNotFoundError as e:
        print(e)
        return 2
    print(f"{args.path}:")
    measured_keys = sorted(set(st.meta) | set(st.points) | set(st.done))
    n_complete = 0
    for key in measured_keys:
        ps = st.pair_status(*key)
        n_complete += ps.complete
        if ps.done:
            state = f"{ps.points}/{ps.expected} point(s), done"
            if ps.missing:
                state += f", MISSING ks {sorted(ps.missing)}"
        else:
            state = f"{ps.points} point(s), in progress"
        if ps.quarantined:
            reasons = sorted({(st.quality.get(key, {}).get(k) or {})
                              .get("reason") or "?"
                              for k in ps.quarantined})
            state += (f", QUARANTINED ks {sorted(ps.quarantined)} "
                      f"({', '.join(reasons)})")
        meta = _meta_settings(st.meta[key]) if key in st.meta else "?"
        print(f"  measured {key[0]}/{key[1]}: {state}  [settings {meta}]")
    for key, rec in sorted(st.preds.items()):
        terms = rec.get("terms", {})
        dominant = max(terms, key=terms.get) if terms else "?"
        print(f"  pred     {key[0]}/{key[1]}: {len(rec['ks'])} point(s), "
              f"hw={rec['hw'].get('name', '?')} dominant={dominant} "
              f"Abs={rec['fit']['k1']:.0f}")
    for (region, variant), rec in sorted(st.decan.items()):
        print(f"  decan    {region}/{variant}: t={rec['t']:.6f}s "
              f"(reps={rec.get('reps')}, inner={rec.get('inner')})")
    for hw, rec in sorted(st.calib.items()):
        tag = "fitted" if rec.get("fitted") else "FALLBACK (paper defaults)"
        print(f"  calib    hw={hw}: low={rec.get('low'):g} "
              f"high={rec.get('high'):g} [{tag}] from "
              f"{len(rec.get('samples', []))} sample(s)")
    for key, rec in sorted(st.audits.items()):
        surv = max(0.0, min(1.0, float(rec.get("survival", 0.0))))
        agrees = rec.get("agrees")
        extra = "" if agrees is None else f", {'' if agrees else 'DIS'}agrees"
        corr = rec.get("corruption")
        print(f"  audit    {key[0]}/{key[1]}: {rec.get('verdict')} "
              f"(survival {surv:.0%}/pattern, predicts "
              f"{rec.get('predicted')}{extra}"
              + (f", {corr}" if corr else "") + ")")
    if measured_keys:
        print(f"  grid: {n_complete}/{len(measured_keys)} measured pair(s) "
              "complete")
    if args.plan:
        from repro_torch.fleet.plan import SweepPlan   # fleet sits above core
        plan = SweepPlan.load(args.plan)
        grid = plan.grid()
        status = st.grid_status(grid)
        missing = [key for key in grid if not status[key].complete]
        print(f"  plan {plan.name!r}: {len(grid) - len(missing)}/{len(grid)} "
              "pair(s) complete")
        for r, m in missing:
            ps = status[(r, m)]
            what = (f"{ps.points} point(s), in progress" if ps.points or ps.done
                    else "absent")
            print(f"    missing {r}/{m} ({what})")
        return 1 if missing else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
