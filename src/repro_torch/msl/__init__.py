"""Plan execution: the planner applied to a model's pattern groups, and the
chain simulator that runs a plan's sub-models stage by stage."""
from .planner import PipelinePlan, group_profile, plan_pipeline
from .simulator import ChainResult, ChainSimulator, StageTrace

__all__ = ["PipelinePlan", "plan_pipeline", "group_profile", "ChainSimulator",
           "ChainResult", "StageTrace"]
