"""Fleet orchestration end to end, from Python, in the PyTorch port: declare
a SweepPlan spanning a kernel's whole size/q family, fan it out over 2
subprocess shards writing segmented stores, merge them (incrementally: one
new segment per worker), classify — ask the fleet doctor why each region got
its label — then prove the completed fleet replays with ZERO new
measurements.

    PYTHONPATH=src python examples/torch_fleet_probe.py              # card
    PYTHONPATH=src python examples/torch_fleet_probe.py --backend cpu

Everything here also exists as a CLI:

    python -m repro_torch.fleet plan / run / doctor / status / watch
    python -m repro_torch.launch.probe --plan PLAN --shard I/N  (the worker)

For the multi-host flow (hosts.json, ssh/mock launchers, retry budgets) see
examples/torch_multihost_fleet.py. This example imports only the public
entry points of ``repro_torch.fleet``.
"""
import argparse
import os

from repro_torch.fleet import SweepPlan, TargetSpec, fleet_doctor, run_fleet
from repro_torch.fleet.cli import main as fleet_cli

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                help="cuda (default): the kernels on the card; cpu: their "
                     "plain PyTorch versions")
ap.add_argument("--dir", default="experiments/campaigns/fleet",
                help="where the plan, stores and report go")
args = ap.parse_args()

plan_path = os.path.join(args.dir, "torch_example_plan.json")
# one plan = one store = the kernel's whole (size, q) grid: 2 sizes x 2 swap
# probabilities x 2 noise modes = 8 (region, mode) sweeps over 2 shards
plan = SweepPlan(
    name="torch_example_spmxv_family",
    store=os.path.join(args.dir, "torch_example_spmxv.jsonl"),
    targets=[
        TargetSpec("pallas", ("fp", "vmem"),
                   {"kernel": "spmxv", "sizes": [128, 256],
                    "qs": [0.0, 1.0], "nnz_per_row": 8}),
    ],
    reps=2, shards=2, backend=args.backend, store_format="segments")
plan.save(plan_path)
print(f"plan {plan.name!r} [{plan.digest()}]: "
      f"{len(plan.grid())} (region, mode) pairs -> {plan_path}\n")

# spawn 2 subprocess shards, stream their output, merge, classify. A killed
# shard leaves an unsealed segment; re-running this exact call with
# resume=True relaunches only the incomplete shard, which heals it.
result = run_fleet(plan_path, resume=os.path.exists(plan.fleet_path()))
merge = result.state.merge or {}
print(f"\nmerge: {merge.get('segments_new')} new segment(s) adopted, "
      f"{merge.get('segments_skipped')} already merged")

print("\nclassifications:")
for name, rep in sorted(result.reports.items()):
    print(f"  {name}: {rep.bottleneck}")

# why each label: the doctor's per-shard forensics, then each region's
# decision path (strategy node fired, thresholds and their provenance)
code, report = fleet_doctor(plan, explain=True)
print("\n" + report)
assert code == 0

# the completed fleet is a durable artifact: replaying it measures nothing
replay = run_fleet(plan_path, resume=True)
assert replay.launched == [] and replay.stats.measured == 0
print(f"\nreplay: 0 launched, 0 measured, "
      f"{replay.stats.cached} points from the merged store")
fleet_cli(["status", "--plan", plan_path])
print(f"report: {plan.report_path()}")
