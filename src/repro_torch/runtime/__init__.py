"""Runtime bookkeeping of the fleet: the elastic device registry and the
§6.4 churn model.  Checkpoint/restart (``CheckpointPolicy``,
``resume_or_init``) comes with ROADMAP item A3."""
from .elastic import DeviceInfo, ElasticRegistry
from .fault_tolerance import ChurnModel

__all__ = ["ChurnModel", "DeviceInfo", "ElasticRegistry"]
