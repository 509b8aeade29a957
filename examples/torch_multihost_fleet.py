"""Multi-host fleet flow in the PyTorch port — hosts.json, pluggable
launchers, retry budgets — runnable anywhere: the cluster is the
deterministic fault-injection launcher, so you see the whole spawn -> crash
-> retry -> heal -> merge -> classify arc without any real hosts.

    PYTHONPATH=src python examples/torch_multihost_fleet.py           # card
    PYTHONPATH=src python examples/torch_multihost_fleet.py --backend cpu

Swap the mock for real machines by running the same plan with:

    python -m repro_torch.fleet run --plan PLAN --launcher ssh \\
        --hosts hosts.json

(a relative ``--store``; without ssh and scp/rsync the launcher refuses to
start and prints the manual recipe shown at the end).
"""
import argparse
import json
import os

from repro_torch.fleet import (MockClusterLauncher, RetryBudget, SSHLauncher,
                               SweepPlan, TargetSpec, fleet_doctor,
                               load_hosts, run_fleet)
from repro_torch.fleet.launchers import MANUAL_RECIPE

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                help="cuda (default): the kernels on the card; cpu: their "
                     "plain PyTorch versions")
ap.add_argument("--dir", default="experiments/campaigns/fleet",
                help="where the hosts file, plan, stores and report go")
args = ap.parse_args()

plan_path = os.path.join(args.dir, "torch_multihost_plan.json")
hosts_path = os.path.join(args.dir, "hosts.json")

# -- 1. the cluster, declared once ------------------------------------------
# Only "addr" is required; python/workdir/env describe each host's checkout.
os.makedirs(args.dir, exist_ok=True)
with open(hosts_path, "w") as f:
    json.dump({"hosts": [
        {"addr": "alice@n0", "python": "/opt/venv/bin/python",
         "workdir": "/scratch/repro", "env": {"PYTHONPATH": "src"}},
        {"addr": "n1", "workdir": "repro", "env": {"PYTHONPATH": "src"}},
    ]}, f, indent=1)
hosts = load_hosts(hosts_path)
print(f"hosts.json -> {hosts_path}")
ring = SSHLauncher(hosts)
for i in range(4):
    print(f"  shard {i} would run on {ring.host_for(i).addr}")

# -- 2. the plan: grid + distribution policy in one artifact ----------------
# The launcher/retry specs are part of the plan's digest — a different
# cluster layout or retry policy is a different plan identity. Here the
# plan declares the MOCK launcher (shard 0's first attempt crashes) so this
# example runs without ssh; for real hosts declare
#   launcher={"kind": "ssh", "hosts": [...]}   (or override at the CLI).
plan = SweepPlan(
    name="torch_multihost_demo",
    store=os.path.join(args.dir, "torch_multihost_demo.jsonl"),
    targets=[TargetSpec("pallas", ("fp", "mxu"),
                        {"kernel": "probe", "sizes": [8, 16]})],
    reps=2, shards=2, backend=args.backend,
    launcher={"kind": "mock", "script": {"0": ["crash"]}},
    retry={"max_attempts": 2, "backoff": 0.0})
plan.save(plan_path)
print(f"\nplan {plan.name!r} [{plan.digest()}]: {len(plan.grid())} "
      f"(region, mode) pairs -> {plan_path}")

# -- 3. run: crash on attempt 1, heal on attempt 2, merge, classify --------
# MockClusterLauncher tears shard 0's store tail exactly like a SIGKILL
# mid-append; the retry budget re-launches ONLY that shard, the store
# heals, and only the missing point is re-measured.
result = run_fleet(plan_path, resume=os.path.exists(plan.fleet_path()),
                   launcher=MockClusterLauncher({0: ["crash"]}),
                   retry=RetryBudget(max_attempts=2))

print("\nclassifications:")
for name, rep in sorted(result.reports.items()):
    print(f"  {name}: {rep.bottleneck}")

print("\nattempt ledger (fleet.json):")
for i, ss in sorted(result.state.shards.items()):
    for a in ss.attempt_log:
        print(f"  shard {i} attempt {a['attempt']}: {a['launcher']}@"
              f"{a['host']} rc={a['rc']} measured={a['measured']} "
              f"cached={a['cached']}")

# -- 4. the doctor reads the same ledger: each shard's attempts, and the
# verdict the stores back
code, report = fleet_doctor(plan)
print("\n" + report)
assert code == 0

print(f"\nreport: {plan.report_path()}")
print("same plan on real machines:  python -m repro_torch.fleet run "
      f"--plan {plan_path} --launcher ssh --hosts {hosts_path}")
print("\nwhere ssh or scp/rsync is missing, the launcher refuses to "
      "start and prints:\n" + MANUAL_RECIPE)
