"""Always-on serving tier: streaming ingress, multi-tenant admission
control, and continuous batching over the rollout orchestrator.

Importing this package registers the ``"serving"`` scheduler policy and
the admission controllers (``fifo`` / ``weighted_fair`` / ``slo_aware``);
``repro_torch.core.policy`` loads it lazily on first registry use, so
``make_policy("serving")`` works without an explicit import.
"""
from repro_torch.serve.arrivals import (Arrival, BurstyArrivals, PoissonArrivals,
                                  TraceArrivals, default_prompt_sampler,
                                  make_arrivals, record_trace)
from repro_torch.serve.serving import ServingOrchestrator
from repro_torch.serve.tenants import (Ingress, QueuedRequest, ServeMeta,
                                 ServingPolicy, TenantQueue, TenantSpec,
                                 available_admissions, coerce_specs,
                                 make_admission, register_admission)

__all__ = [
    "Arrival", "BurstyArrivals", "PoissonArrivals", "TraceArrivals",
    "default_prompt_sampler", "make_arrivals", "record_trace",
    "ServingOrchestrator",
    "Ingress", "QueuedRequest", "ServeMeta", "ServingPolicy",
    "TenantQueue", "TenantSpec", "available_admissions", "coerce_specs",
    "make_admission", "register_admission",
]
