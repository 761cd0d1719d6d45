"""The supervised host runtime of the port: liveness, restarts and the
degradation ladder (:mod:`.supervisor`)."""

from mercury_tpu_torch.runtime.supervisor import BUDGET_BUCKETS, LEVEL_NAMES, HostSupervisor

__all__ = ["HostSupervisor", "LEVEL_NAMES", "BUDGET_BUCKETS"]
