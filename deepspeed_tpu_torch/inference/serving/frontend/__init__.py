"""Multi-tenant serving front end of the port.

Copy of ``deepspeed_tpu/inference/serving/frontend/`` over the port's
serving engine:

  * :mod:`streaming` — per-token :class:`TokenEvent` delivery at
    iteration boundaries;
  * :mod:`tenancy` — tenant specs (weight / priority / SLO targets)
    and their live virtual-token counters (Sheng et al., OSDI '24);
  * :mod:`frontend` — :class:`ServingFrontend`, wiring the registry
    into the scheduler's admission / prefill / shed policy hooks and
    the per-tenant ``dstpu_serving_tenant_*`` metrics.
"""
from .frontend import ServingFrontend  # noqa: F401
from .streaming import (StreamCollector, StreamDeduper,  # noqa: F401
                        StreamReplayError, TokenEvent)
from .tenancy import TenantRegistry, TenantSpec  # noqa: F401

__all__ = ["ServingFrontend", "StreamCollector", "StreamDeduper",
           "StreamReplayError", "TokenEvent",
           "TenantRegistry", "TenantSpec"]
