"""Fleet orchestration: one launcher that plans, spawns, merges, classifies.

``SweepPlan`` (plan.py) declares the full grid — regions × modes × kernel
size/q families — plus, optionally, HOW to distribute it (a launcher spec
and a retry budget). ``run_fleet`` (executor.py) drives it end to end:
spawn N worker shards through a pluggable ``Launcher`` (launchers.py —
local subprocesses, ssh hosts from a hosts.json, or a deterministic
fault-injection mock), retry failed shards within the ``RetryBudget``,
survive crashes, merge worker stores (incrementally, by segment adoption,
when the plan declares ``store_format: "segments"``), classify from the
merged store. ``fleet_doctor`` explains an incomplete fleet per shard.
``python -m repro_torch.fleet`` is the CLI
(plan / run / audit / doctor / calibrate / status / watch).
"""
from repro_torch.fleet.executor import (FleetError, FleetResult,  # noqa: F401
                                        FleetState, fleet_doctor, run_fleet,
                                        run_worker)
from repro_torch.fleet.launchers import (HostSpec, Launcher,  # noqa: F401
                                         LocalLauncher, MockClusterLauncher,
                                         RetryBudget, SSHLauncher,
                                         ShardOutcome, load_hosts,
                                         resolve_launcher)
from repro_torch.fleet.plan import PlanError, SweepPlan, TargetSpec  # noqa: F401
