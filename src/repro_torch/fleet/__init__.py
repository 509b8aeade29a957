"""Fleet orchestration: one launcher that plans, spawns, merges, classifies.

``SweepPlan`` (plan.py) declares the full grid — regions × modes × kernel
size/q families — plus, optionally, HOW to distribute it (a launcher spec
and a retry budget). ``run_fleet`` (executor.py) drives it end to end:
spawn N worker shards through a pluggable ``Launcher`` (launchers.py —
local subprocesses or a deterministic fault-injection mock), retry failed
shards within the ``RetryBudget``, survive crashes, merge worker stores,
classify from the merged store. ``python -m repro_torch.fleet`` is the CLI
(plan / run / status).
"""
from repro_torch.fleet.executor import (FleetError, FleetResult,  # noqa: F401
                                        FleetState, run_fleet, run_worker)
from repro_torch.fleet.launchers import (Launcher, LocalLauncher,  # noqa: F401
                                         MockClusterLauncher, RetryBudget,
                                         ShardOutcome, resolve_launcher)
from repro_torch.fleet.plan import PlanError, SweepPlan, TargetSpec  # noqa: F401
