"""SweepPlan — the declarative unit of fleet work.

A plan enumerates the FULL measurement grid up front — regions × modes × ks
× reps × kernel size/q families — and serializes to JSON next to the store,
so every participant (the launcher, each worker subprocess, a human at the
``status`` CLI) agrees on exactly the same grid in exactly the same order:

  * ``targets`` is a list of declarative ``TargetSpec``s, not live objects —
    a spec resolves to one or more RegionTargets in whatever process needs
    them (a subprocess shard rebuilds its regions from the plan file alone);
  * a "pallas" spec spans a whole size/q FAMILY (``kernels.region.
    pallas_family``): one plan — and one campaign store — holds a kernel's
    entire grid;
  * ``pairs()``/``grid()`` fix the canonical (region, mode) enumeration
    (region-major, mode-minor, targets in declaration order). Worker ``i`` of
    ``N`` measures every N-th pair — the same slicing as
    ``Campaign.measure_pairs`` — so the plan file IS the shard assignment;
  * ``digest()`` hashes the canonical JSON; fleet state pins it so a resumed
    fleet refuses to splice shards measured under a different plan.

The JSON schema, digest and grid order are the reference's (``repro.fleet.
plan``), so a plan file names the same regions in both packages. What the
port accepts is narrower: ``backend`` "cuda" (the default) or "cpu",
"step" targets of every family (but an encdec decode step, which the
reference cannot build: ``KeyError: 'frames'``), and "serve" targets of
the paged layout's families (dense, moe and vlm without a sliding window),
refused at plan time where the reference fails later in every worker.

Plan JSON (one object, schema-versioned):

  {"sweep_plan": 1, "name": ..., "store": ..., "reps": 2, "shards": 2,
   "workers": 1, "compile_once": true, "backend": "cuda",
   "targets": [{"kind": "pallas", "modes": ["fp", "mxu", "vmem"],
                "params": {"kernel": "attention", "sizes": [4096],
                           "heads": 32, "kv_heads": 4, "head_dim": 128}}]}
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

PLAN_SCHEMA = 1

BACKENDS = ("cuda", "cpu")


class PlanError(ValueError):
    """A plan file (or plan construction) is invalid."""


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    """One declarative target family: what to measure and under which modes.

    kinds:
      * "pallas" — params {kernel, sizes[, qs, ...spec kwargs]}; resolves
        via ``pallas_family`` to one RegionTarget per size/q;
      * "step" — params {arch[, kind, seq, batch]}; resolves via
        ``launch.probe.build_step_region`` to one model-step region;
      * "serve" — params {arch[, slots, prompt, max_new, page_size]};
        resolves via ``serve.load.build_serve_regions`` to TWO regions of
        one paged serving workload: the engine's batched prefill and its
        decode tick;
      * "calibrate" — params {[n, chunk]}; resolves to the four
        known-regime calibration targets
        (``core.calibration.calibrate_targets``).
    """
    kind: str
    modes: tuple[str, ...]
    params: dict

    def validate(self) -> None:
        """Reject unknown kinds/modes/params at plan-build time (a bad
        family must not fail later in every worker subprocess)."""
        if not self.modes:
            raise PlanError(f"target {self.kind!r} has no modes")
        if self.kind == "calibrate":
            self._validate_calibrate()
            return
        if self.kind in ("step", "serve"):
            self._validate_model()
            return
        if self.kind != "pallas":
            raise PlanError(f"unknown target kind {self.kind!r}; one of "
                            "['calibrate', 'pallas', 'step', 'serve']")
        from repro_torch.kernels.region import KERNEL_MODES, check_family_args
        kernel = self.params.get("kernel")
        if kernel not in KERNEL_MODES:
            raise PlanError(f"unknown pallas kernel {kernel!r}; one of "
                            f"{sorted(KERNEL_MODES)}")
        sizes = self.params.get("sizes")
        if not sizes:
            raise PlanError(f"pallas target {kernel!r} needs a non-empty "
                            "sizes list")
        try:
            check_family_args(kernel, sizes, self.params.get("qs"),
                              self._extra_params())
        except ValueError as e:
            raise PlanError(str(e)) from e
        bad = [m for m in self.modes if m not in KERNEL_MODES[kernel]]
        if bad:
            raise PlanError(f"kernel {kernel!r} supports modes "
                            f"{KERNEL_MODES[kernel]}, not {bad}")

    def _validate_model(self) -> None:
        """A "step" or "serve" target: a known architecture (a decode step
        not of the encdec family; a serve target of the paged layout's
        families, without a sliding window), the graph-level modes, and
        positive serve parameters."""
        from repro_torch.configs import canonical, get_config
        from repro_torch.core.noise import make_modes
        from repro_torch.launch.probe import ENCDEC_DECODE_REFUSED
        from repro_torch.models.model import LM_FAMILIES

        arch = self.params.get("arch")
        if not arch:
            raise PlanError(f"{self.kind} target needs an 'arch'")
        try:
            cfg = get_config(canonical(arch))
        except KeyError as e:
            raise PlanError(str(e)) from None
        if (self.kind == "step" and cfg.family == "encdec"
                and self.params.get("kind", "train") == "decode"):
            raise PlanError(f"step target {arch!r}: "
                            f"{ENCDEC_DECODE_REFUSED}")
        if self.kind == "serve" and cfg.family not in LM_FAMILIES:
            raise PlanError(f"serve target {arch!r}: paged serving needs "
                            "an attention KV cache without a sliding window "
                            f"(family={cfg.family!r}, window={cfg.window})")
        if self.kind == "serve" and cfg.window:
            raise PlanError(f"serve target {arch!r}: a sliding-window "
                            f"config (window={cfg.window}) is not served; "
                            "the reference's dense layout cannot serve it "
                            "and the paged layout has no ring (ROADMAP "
                            "queue 3)")
        known = make_modes(device="cpu")
        bad = [m for m in self.modes if m not in known]
        if bad:
            raise PlanError(f"unknown graph-level mode(s) {bad}")
        if self.kind == "serve":
            for key in ("slots", "prompt", "max_new", "page_size"):
                v = self.params.get(key)
                if v is not None and (not isinstance(v, int) or v < 1):
                    raise PlanError(f"serve target {key}={v!r}: want a "
                                    "positive int")

    def _validate_calibrate(self) -> None:
        from repro_torch.core.calibration import CALIB_MODES
        bad = [m for m in self.modes if m not in CALIB_MODES]
        if bad:
            raise PlanError(f"calibrate targets sweep the loop modes "
                            f"{list(CALIB_MODES)}, not {bad}")
        unknown = sorted(set(self.params) - {"n", "chunk"})
        if unknown:
            raise PlanError(f"unknown calibrate param(s) {unknown}")
        for key in ("n", "chunk"):
            v = self.params.get(key)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise PlanError(f"calibrate target {key}={v!r}: want a "
                                "positive int")

    def _extra_params(self) -> dict:
        return {k: v for k, v in self.params.items()
                if k not in ("kernel", "sizes", "qs")}

    def resolve(self, backend: str = "cuda") -> list:
        """Build this spec's RegionTargets (in the calling process) on the
        backend's device."""
        p = self.params
        if self.kind == "calibrate":
            from repro_torch.core.calibration import calibrate_targets
            return calibrate_targets(n=int(p.get("n", 4096)),
                                     chunk=int(p.get("chunk", 512)),
                                     device=backend)
        if self.kind == "serve":
            from repro_torch.serve.load import build_serve_regions
            return build_serve_regions(
                p["arch"], list(self.modes), slots=int(p.get("slots", 4)),
                prompt=int(p.get("prompt", 32)),
                max_new=int(p.get("max_new", 8)),
                page_size=int(p.get("page_size", 16)), device=backend)
        if self.kind == "step":
            from repro_torch.launch.probe import build_step_region
            return [build_step_region(p["arch"], p.get("kind", "train"),
                                      list(self.modes),
                                      seq=int(p.get("seq", 128)),
                                      batch=int(p.get("batch", 4)),
                                      device=backend)]
        from repro_torch.kernels.region import pallas_family
        return pallas_family(self.params["kernel"], self.params["sizes"],
                             qs=self.params.get("qs"), device=backend,
                             **self._extra_params())

    def region_names(self) -> list[str]:
        """The names ``resolve()``'s regions will carry, derived WITHOUT
        building anything (grid queries stay cheap)."""
        p = self.params
        if self.kind == "calibrate":
            from repro_torch.core.calibration import REGIME_NAMES
            return list(REGIME_NAMES)
        if self.kind == "serve":
            from repro_torch.serve.load import serve_region_names
            return serve_region_names(p["arch"],
                                      slots=int(p.get("slots", 4)),
                                      prompt=int(p.get("prompt", 32)),
                                      max_new=int(p.get("max_new", 8)),
                                      page_size=int(p.get("page_size", 16)))
        if self.kind == "step":
            from repro_torch.configs import get_smoke_config  # no model
            from repro_torch.launch.probe import step_region_name
            return [step_region_name(get_smoke_config(p["arch"]).name,
                                     p.get("kind", "train"),
                                     int(p.get("seq", 128)),
                                     int(p.get("batch", 4)))]
        from repro_torch.kernels.region import family_names
        return family_names(self.params["kernel"], self.params["sizes"],
                            qs=self.params.get("qs"), **self._extra_params())

    def to_dict(self) -> dict:
        """The JSON-able form embedded in a plan's ``targets`` list."""
        return {"kind": self.kind, "modes": list(self.modes),
                "params": self.params}

    @classmethod
    def from_dict(cls, d: dict) -> "TargetSpec":
        """Rebuild a spec from its plan-JSON entry."""
        return cls(kind=d.get("kind", ""), modes=tuple(d.get("modes", ())),
                   params=dict(d.get("params", {})))


@dataclasses.dataclass
class SweepPlan:
    """The full declarative grid plus every setting that shapes measurement
    (reps, compile path, backend) and distribution (shards, threads, and —
    when declared — the launcher and retry policy).

    ``backend``: "cuda" (the default: the kernels on the card; a worker
    without a card fails) or "cpu" (the plain PyTorch versions). The
    reference's "auto", "pallas", "interpret" and "ref" are refused: "auto"
    would fall back to the CPU without saying so.

    ``launcher`` (optional): ``{"kind": "local"[, "in_process": true]}``,
    ``{"kind": "ssh", "hosts": [{addr, python, workdir, env}, ...]}``, or
    ``{"kind": "mock", "script": {"0": ["crash"], ...}}`` for deterministic
    fault injection. ``retry`` (optional): ``{"max_attempts": N, "backoff":
    s, "per_shard_cap": M}``. ``store_format`` (optional): "jsonl" (one
    legacy file, the default) or "segments" (``core.segments`` —
    append-only segments and a manifest: incremental merges and ``fleet
    watch``'s live status; not with the ssh launcher). ``quality``
    (optional): one flat dict of QualityPolicy and RemeasureBudget fields.
    Each optional field is serialized — and hashed into the digest — only
    when set.
    """
    name: str
    store: str
    targets: list[TargetSpec]
    reps: int = 2
    shards: int = 1
    workers: int = 1
    compile_once: bool = True
    backend: str = "cuda"
    launcher: Optional[dict] = None
    retry: Optional[dict] = None
    store_format: Optional[str] = None
    quality: Optional[dict] = None

    # -- validation / identity ----------------------------------------------
    def validate(self) -> None:
        """Reject malformed plans (empty grids, bad sizes, unknown modes,
        refused backends, invalid launcher/retry specs) before they land on
        disk."""
        if not self.name:
            raise PlanError("plan needs a name")
        if not self.store:
            raise PlanError("plan needs a store path")
        if not self.targets:
            raise PlanError("plan has no targets")
        if self.shards < 1 or self.workers < 1 or self.reps < 1:
            raise PlanError("shards, workers and reps must be >= 1")
        if self.backend not in BACKENDS:
            raise PlanError(f"backend {self.backend!r} is not supported; one "
                            f"of {list(BACKENDS)} (cuda: the kernels on the "
                            "card, cpu: their plain PyTorch versions)")
        for spec in self.targets:
            spec.validate()
        self._validate_distribution()

    def _validate_distribution(self) -> None:
        """Validate the optional store-format / launcher / retry / quality
        specs (lazy import: launchers sit above plan in the layer order)."""
        from repro_torch.fleet import launchers as ln

        if self.store_format not in (None, "jsonl", "segments"):
            raise PlanError(f"store_format {self.store_format!r} unknown; "
                            "one of ['jsonl', 'segments']")
        if (self.store_format == "segments" and self.launcher is not None
                and self.launcher.get("kind") == "ssh"):
            # the ssh launcher pushes and pulls ONE file per worker store; a
            # segment directory does not fit that staging protocol
            raise PlanError("store_format 'segments' is not supported with "
                            "the ssh launcher (single-file staging); use "
                            "local/mock, or the default jsonl layout")
        if self.launcher is not None:
            kind = self.launcher.get("kind")
            if kind not in ln.LAUNCHER_KINDS:
                raise PlanError(f"launcher kind {kind!r} unknown; one of "
                                f"{list(ln.LAUNCHER_KINDS)}")
            unknown = sorted(set(self.launcher)
                             - {"kind", "hosts", "script", "in_process"})
            if unknown:
                raise PlanError(f"unknown launcher key(s) {unknown}")
            try:
                if kind == "ssh":
                    hosts = [ln.HostSpec.from_dict(h)
                             for h in self.launcher.get("hosts", [])]
                    if not hosts:
                        raise PlanError("ssh launcher spec needs a "
                                        "non-empty hosts list")
                elif kind == "mock":
                    ln.MockClusterLauncher(self.launcher.get("script"))
            except ln.FleetError as e:
                raise PlanError(str(e)) from e
        if self.retry is not None:
            try:
                ln.RetryBudget.from_dict(self.retry)
            except ln.FleetError as e:
                raise PlanError(str(e)) from e
        if self.quality is not None:
            from repro_torch.core.quality import quality_from_dict
            try:
                quality_from_dict(self.quality)
            except ValueError as e:
                raise PlanError(str(e)) from e

    def to_dict(self) -> dict:
        """The canonical JSON-able form; optional fields appear only when
        declared."""
        d = {"sweep_plan": PLAN_SCHEMA, "name": self.name,
             "store": self.store, "reps": self.reps,
             "shards": self.shards, "workers": self.workers,
             "compile_once": self.compile_once, "backend": self.backend,
             "targets": [t.to_dict() for t in self.targets]}
        if self.launcher is not None:
            d["launcher"] = self.launcher
        if self.retry is not None:
            d["retry"] = self.retry
        if self.store_format is not None:
            d["store_format"] = self.store_format
        if self.quality is not None:
            d["quality"] = self.quality
        return d

    def canonical_json(self) -> str:
        """``to_dict`` with sorted keys — the digest's input bytes."""
        return json.dumps(self.to_dict(), sort_keys=True)

    def digest(self) -> str:
        """Content hash pinning the grid AND the measurement settings —
        fleet state refuses to splice shards from a different digest."""
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()[:12]

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> str:
        """Validate, then atomically write the plan JSON (with its digest
        echoed for humans) to ``path``; returns ``path``."""
        self.validate()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({**self.to_dict(), "digest": self.digest()}, f,
                      indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def from_dict(cls, d: dict) -> "SweepPlan":
        """Rebuild (and validate) a plan from its JSON object. A plan
        without a ``backend`` key runs on the card."""
        if d.get("sweep_plan") != PLAN_SCHEMA:
            raise PlanError(f"not a sweep plan (sweep_plan="
                            f"{d.get('sweep_plan')!r}, want {PLAN_SCHEMA})")
        plan = cls(name=d.get("name", ""), store=d.get("store", ""),
                   targets=[TargetSpec.from_dict(t)
                            for t in d.get("targets", [])],
                   reps=int(d.get("reps", 2)), shards=int(d.get("shards", 1)),
                   workers=int(d.get("workers", 1)),
                   compile_once=bool(d.get("compile_once", True)),
                   backend=d.get("backend", "cuda"),
                   launcher=d.get("launcher"), retry=d.get("retry"),
                   store_format=d.get("store_format"),
                   quality=d.get("quality"))
        plan.validate()
        return plan

    @classmethod
    def load(cls, path: str) -> "SweepPlan":
        """Load and validate a plan JSON file."""
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- the canonical grid --------------------------------------------------
    def resolve(self) -> list[tuple[TargetSpec, list]]:
        """Resolve every spec (cached: a plan resolves once per process, so
        all grid queries see the SAME RegionTarget objects)."""
        if getattr(self, "_resolved", None) is None:
            self._resolved = [(spec, spec.resolve(self.backend))
                              for spec in self.targets]
        return self._resolved

    def pairs(self) -> list[tuple[object, str]]:
        """The full (RegionTarget, mode) grid in canonical order — the exact
        sequence ``Campaign.measure_pairs`` slices across workers."""
        return [(region, mode) for spec, regions in self.resolve()
                for region in regions for mode in spec.modes]

    def grid(self) -> list[tuple[str, str]]:
        """The grid by (region name, mode), WITHOUT resolving targets — the
        same enumeration order as ``pairs()``."""
        out = [(name, mode) for spec in self.targets
               for name in spec.region_names() for mode in spec.modes]
        if len(set(out)) != len(out):
            raise PlanError(f"plan {self.name!r} enumerates duplicate "
                            "(region, mode) pairs; targets must not overlap")
        return out

    # -- derived paths -------------------------------------------------------
    def worker_stores(self) -> list[str]:
        """Every shard's worker-store path (``store.wIofN.jsonl``)."""
        from repro_torch.core.campaign import worker_store
        return [worker_store(self.store, i, self.shards)
                for i in range(self.shards)]

    def fleet_path(self) -> str:
        """Where this plan's ``fleet.json`` ledger lives."""
        return os.path.splitext(self.store)[0] + ".fleet.json"

    def report_path(self) -> str:
        """Where this plan's canonical ``report.json`` lands."""
        return os.path.splitext(self.store)[0] + ".report.json"
