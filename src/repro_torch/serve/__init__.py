"""Concurrent multi-request serving planner (`repro_torch.serve`).

The paper plans one service chain R = (s, d, b, mode) in isolation; this
package admits *fleets* of chains onto one `PhysicalNetwork` with
residual-capacity accounting (link bandwidth consumed by smashed-data flows,
node memory/disk by placed sub-models), pluggable admission policies, and
capacity-aware replanning against the residual network before a request is
declared blocked.  See docs/serve.md.

`ServeSim` layers an event-driven *dynamic* admission process on top:
chains arrive, hold their reservation for ``duration_s``, and depart —
releasing their exact demand back to the fabric, with an optional retry
queue for capacity-blocked requests.  See docs/sim.md.

Substrate failures (`link_down`/`node_down`/`recover` events) take committed
chains down mid-flight; victims are detected through the ResidualState
reverse index and live-migrated onto the degraded fabric, with HA standby
preplanning and a migration cost model.  See docs/failures.md.

Every layer plans through the port's solver registry.  The default solver
is ``bcd_torch``, bit-identical to the JAX package's default ``bcd``; the
torch solvers (`dfts_torch`, `bcd_torch`) take their device through
``solver_kwargs={"device": ...}``, the card unless the caller names the CPU
(``device_kwargs``: without a card they raise, they never fall back).

CLI:  ``PYTHONPATH=src python -m repro_torch.serve --n-requests 16 --policy fcfs``
      ``PYTHONPATH=src python -m repro_torch.serve --sim --hold-model exp \\
          --duration-s 4 --arrival poisson --retry --failure-rate 0.2``
      (``bcd_torch`` on the card by default; ``--device cpu`` on the CPU)
"""
from .admission import AdmissionCore, ServedRequest
from .failures import (FAILURE_KINDS, FailureEvent, MigrationCostModel,
                       generate_failures, migration_delta, standby_network)
from .gateway import (GatewayConfig, GatewayOutcome, GatewayStats,
                      ServeGateway)
from .plancache import PlanCache
from .planner import (ServeOutcome, ServePlanner, device_kwargs,
                      replay_verify)
from .policies import POLICIES, POLICY_NAMES
from .requests import (ARRIVALS, BATCH_SPREAD, HOLD_MODELS, ServeRequest,
                       generate_fleet)
from .residual import (PlanDemand, ResidualState, effective_rate_rps,
                       plan_demand, plan_footprint)
from .sim import (FailureOutcome, ServeSim, SimOutcome, replay_verify_sim,
                  replay_verify_sim_report)

__all__ = [
    "ARRIVALS", "BATCH_SPREAD", "FAILURE_KINDS", "HOLD_MODELS", "POLICIES",
    "POLICY_NAMES", "AdmissionCore", "FailureEvent",
    "FailureOutcome", "GatewayConfig", "GatewayOutcome", "GatewayStats",
    "MigrationCostModel", "PlanCache", "PlanDemand", "ResidualState",
    "ServeGateway", "ServeOutcome", "ServePlanner", "ServeRequest",
    "ServeSim", "ServedRequest", "SimOutcome", "effective_rate_rps",
    "device_kwargs", "generate_failures", "generate_fleet", "migration_delta",
    "plan_demand", "plan_footprint", "replay_verify", "replay_verify_sim",
    "replay_verify_sim_report", "standby_network",
]
