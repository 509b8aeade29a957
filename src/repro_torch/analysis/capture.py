"""Capture the audit's golden SASS fixtures on the card.

    python -m repro_torch.analysis.capture --out tests/golden_torch/sass
    python -m repro_torch.analysis.capture --out tests/golden_torch/sass \
        --from-fixtures      # the expected reports again, on any machine

Builds the static noise audit's three builds (clean, ``K_LO``, ``K_HI``) of
every main-path kernel region pair (the probe at 1056 steps, spmxv at 2^21
rows and L = 16, the matmul at 4096, attention at Qwen3-30B-A3B's widths,
hd 128 f32 at seq 4096), of one graph-level noise mode (hbm_latency, a
step region's pointer chase) and of the probe's fp mode under the
sabotage switch (``REPRO_NOISE_SABOTAGE=const``: the pair the audit must
read dead), and writes one gzipped JSON a pair holding the three SASS
dumps of the region's functions (the encodings dropped), the pair's
target and audit hint, and ``audit_expected.json`` beside the fixture
directory: each pair's ``AuditReport`` as ``audit_texts`` computes it from
the stored dumps. The CPU tests (``tests/test_torch_audit.py``) hold the
fixtures to that file exactly. Needs ``nvcc`` and ``cuobjdump``; launches
nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.analysis.audit import (K_HI, K_LO, AuditError, audit_texts,
                                        site_text)

# the encoding comments cuobjdump prints beside and below each instruction
_ENCODING = re.compile(r"\s*/\* 0x[0-9a-f]{16} \*/")

MAIN_REGIONS = (
    ("probe", {"n_steps": 1056}),
    ("spmxv", {"n": 2 ** 21, "nnz_per_row": 16, "q": 0.0}),
    ("matmul", {"n": 4096}),
    ("attention", {"batch": 1, "heads": 32, "kv_heads": 4, "seq": 4096,
                   "head_dim": 128}),
)
GRAPH_MODE = "hbm_latency"


def strip_encodings(text: str) -> str:
    """A dump without its encoding columns and encoding-only lines."""
    out = []
    for line in text.splitlines():
        line = _ENCODING.sub("", line).rstrip()
        if line:
            out.append(line)
    return "\n".join(out) + "\n"


def pairs() -> list[dict]:
    """Every fixture pair: {name, region, mode, target, hint, sites}."""
    import torch

    from repro_torch.analysis.audit import _payload_target, _site, audit_hint
    from repro_torch.core.injector import STEP_SCALE, step_region
    from repro_torch.core.noise import make_modes
    from repro_torch.kernels.region import KERNEL_MODES, pallas_region

    out = []

    def add(name, target, mode, sabotage=None):
        sites = [dataclasses.replace(_site(target, mode, k),
                                     sabotage=sabotage)
                 for k in (0, K_LO, K_HI)]
        out.append({"name": name, "region": target.name, "mode": mode,
                    "target": _payload_target(target, mode),
                    "hint": audit_hint(target, mode), "sites": sites})

    for kernel, sizes in MAIN_REGIONS:
        region = pallas_region(kernel, device="cuda", **sizes)
        for mode in KERNEL_MODES[kernel]:
            add(f"{region.name}__{mode}", region, mode)
    probe = pallas_region("probe", device="cuda", n_steps=1056)
    add(f"{probe.name}__fp__sabotaged", probe, "fp", sabotage=True)
    registry = make_modes(STEP_SCALE, device="cuda")
    x = torch.zeros(1, device="cuda")
    step = step_region("graph_noise_step", lambda t: t + 1, (x,),
                       {GRAPH_MODE: registry[GRAPH_MODE]})
    add(f"{step.name}__{GRAPH_MODE}", step, GRAPH_MODE)
    return out


def _report(fx: dict):
    """The AuditReport of one fixture's three dumps."""
    return audit_texts(fx["clean"], fx["lo"], fx["hi"], region=fx["region"],
                       mode=fx["mode"], target=fx["target"], hint=fx["hint"],
                       k_lo=fx["k_lo"], k_hi=fx["k_hi"])


def _write_expected(fixtures: dict, expected_path: str) -> dict:
    """Audit every fixture ({name: fixture}), print each verdict and write
    the reports to ``expected_path``; returns them."""
    expected = {}
    for name, fx in sorted(fixtures.items()):
        rep = _report(fx)
        expected[name] = rep.to_dict()
        print(f"  {rep.explain()} [{rep.detail}]")
    with open(expected_path, "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    return expected


def capture(out_dir: str, expected_path: str, workers: int = 16) -> dict:
    """Build, dump and write every fixture; returns {name: report dict}."""
    todo = pairs()
    sites = list(dict.fromkeys(s for p in todo for s in p["sites"]))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(workers, len(sites))) as ex:
        texts = dict(zip(sites, ex.map(
            lambda s: strip_encodings(site_text(s)), sites)))
    print(f"{len(sites)} static builds dumped in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    fixtures = {}
    for p in todo:
        clean, lo, hi = (texts[s] for s in p["sites"])
        fixtures[p["name"]] = fx = {
            "region": p["region"], "mode": p["mode"], "target": p["target"],
            "hint": p["hint"], "k_lo": K_LO, "k_hi": K_HI, "clean": clean,
            "lo": lo, "hi": hi}
        with gzip.open(os.path.join(out_dir, p["name"] + ".json.gz"),
                       "wt") as f:
            json.dump(fx, f, sort_keys=True)
    return _write_expected(fixtures, expected_path)


def recompute(out_dir: str, expected_path: str) -> dict:
    """``audit_expected.json`` from fixtures already captured (after a
    change to the census; the dumps stay the card's)."""
    fixtures = {}
    for name in os.listdir(out_dir):
        if name.endswith(".json.gz"):
            with gzip.open(os.path.join(out_dir, name), "rt") as f:
                fixtures[name[:-len(".json.gz")]] = json.load(f)
    return _write_expected(fixtures, expected_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="fixture directory (one <pair>.json.gz each)")
    ap.add_argument("--expected", default=None,
                    help="the expected reports (default: "
                         "audit_expected.json beside --out)")
    ap.add_argument("--from-fixtures", action="store_true",
                    help="no builds: recompute the expected reports from "
                         "the fixtures in --out (needs no card)")
    args = ap.parse_args(argv)
    expected = args.expected or os.path.join(
        os.path.dirname(os.path.abspath(args.out)), "audit_expected.json")
    if args.from_fixtures:
        recompute(args.out, expected)
        print(f"expected reports -> {expected}")
        return 0
    try:
        capture(args.out, expected)
    except AuditError as e:
        print(f"capture: {e}", file=sys.stderr)
        return 1
    print(f"fixtures -> {args.out}; expected reports -> {expected}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
