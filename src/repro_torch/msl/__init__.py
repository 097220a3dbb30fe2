"""Plan execution: the planner applied to a model's pattern groups, and the
chain simulator that runs a plan's sub-models stage by stage, forward
(``run_plan``) or as a training round trip (``round_trip``)."""
from .planner import PipelinePlan, group_profile, plan_pipeline
from .simulator import (
    ChainResult,
    ChainSimulator,
    RoundTripResult,
    StageTrace,
    executed_round_trip_s,
)

__all__ = ["PipelinePlan", "plan_pipeline", "group_profile", "ChainSimulator",
           "ChainResult", "StageTrace", "RoundTripResult",
           "executed_round_trip_s"]
