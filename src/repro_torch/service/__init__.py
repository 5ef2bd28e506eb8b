"""repro_torch.service: the slot-based multi-tenant simulation service, the
port of the JAX package's ``repro.service``.

Public surface:

  ``SimulationService`` / ``ServiceConfig``  host loop: admission,
      deadlines, retry/backoff, watchdog, degradation ladder;
  ``SlotBatch``                              device layer: B lanes, each
      one tenant's rank states, run one after another;
  ``SimRequest`` / ``RequestHandle`` / ``TenantResult`` / request status
      + typed rejections.
"""
from repro_torch.service.service import (SERVICE_LIFECYCLE_KEYS,
                                         ServiceConfig, SimulationService)
from repro_torch.service.slots import SlotBatch
from repro_torch.service.types import (BackoffRecord, IncompatibleRequest,
                                       RequestHandle, RequestStatus,
                                       ServiceError, ServiceOverloaded,
                                       ServiceConfigError, SimRequest,
                                       TenantResult)

__all__ = [
    "SimulationService", "ServiceConfig", "SERVICE_LIFECYCLE_KEYS",
    "SlotBatch",
    "SimRequest", "RequestHandle", "TenantResult", "BackoffRecord",
    "RequestStatus", "ServiceError", "ServiceOverloaded",
    "IncompatibleRequest", "ServiceConfigError",
]
