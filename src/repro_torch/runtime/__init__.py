"""Runtime bookkeeping of the fleet: the elastic device registry, the
§6.4 churn model, and checkpoint/restart (``CheckpointPolicy``,
``resume_or_init``)."""
from .elastic import DeviceInfo, ElasticRegistry
from .fault_tolerance import ChurnModel, CheckpointPolicy, resume_or_init

__all__ = ["ChurnModel", "CheckpointPolicy", "DeviceInfo", "ElasticRegistry",
           "resume_or_init"]
