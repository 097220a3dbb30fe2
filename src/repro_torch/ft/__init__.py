from .manager import ElasticPlanController, FTEvent, StepTimeCalibrator

__all__ = ["ElasticPlanController", "FTEvent", "StepTimeCalibrator"]
