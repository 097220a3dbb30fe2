"""Plan execution: the planner applied to a model's pattern groups, the
chain simulator that runs a plan's sub-models stage by stage, forward
(``run_plan``) or as a training round trip (``round_trip``), and the
microbatch pipeline runtime (``pipeline_forward``,
``make_pipeline_train_step``), its stages in one process or, in a started
process group, one (stage, replica) a rank (``StageMesh``)."""
from .pipeline import (
    PipelineMesh,
    StageMesh,
    local_shards,
    make_pipeline_mesh,
    make_pipeline_train_step,
    pipeline_forward,
    pipeline_loss,
    replica_rows,
    shard_stage,
    stack_for_pipeline,
    stage_params,
)
from .planner import PipelinePlan, group_profile, plan_pipeline
from .simulator import (
    ChainResult,
    ChainSimulator,
    RoundTripResult,
    StageTrace,
    executed_round_trip_s,
)

__all__ = ["PipelinePlan", "plan_pipeline", "group_profile",
           "make_pipeline_mesh", "make_pipeline_train_step",
           "pipeline_forward", "pipeline_loss", "stack_for_pipeline",
           "PipelineMesh", "StageMesh", "replica_rows", "stage_params",
           "shard_stage", "local_shards",
           "ChainSimulator", "ChainResult", "StageTrace", "RoundTripResult",
           "executed_round_trip_s"]
