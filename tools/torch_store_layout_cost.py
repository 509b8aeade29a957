"""Phase 4b's attention plan (seq 256/512, two subprocess shards) on the
single-file and the segmented layout in turns (after one warm-up run that
builds the kernels): none, segments, segments, none. Prints each run's
wall seconds and the segmented runs' in-process calls. Run it from the
repository's root on a machine with a card (it builds what phase 4b
builds): ``python3 tools/torch_store_layout_cost.py``."""
import json
import os
import sys
import tempfile
import time

ROOT = os.getcwd()
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
import chip_smoke as cs  # noqa: E402
from repro_torch.fleet.plan import TargetSpec  # noqa: E402

print(cs.card_line(), flush=True)
kernels = cs.Kernels()
targets = [TargetSpec("pallas", ("fp", "mxu", "vmem"),
                      {"kernel": "attention", "sizes": [256, 512]})]
out = []
for i, fmt in enumerate([None, None, "segments", "segments", None]):
    tmp = tempfile.mkdtemp(prefix="cmp4b_")
    secs = {}
    t0 = time.perf_counter()
    cs._fleet_plan_run(tmp, "attention_family", targets, 2, kernels,
                       store_format=fmt, seconds=secs)
    dt = time.perf_counter() - t0
    out.append({"run": i, "format": fmt or "jsonl", "s": dt,
                "in_process": secs, "card": cs.card_state()})
    print("RUN " + json.dumps(out[-1]), flush=True)
print("SUMMARY " + json.dumps(out[1:]))
print(cs.card_line())
