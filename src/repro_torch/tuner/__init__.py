"""repro_torch.tuner: persistent runtime tuning on top of the Eq. 1 mapper.

The paper resolves kernel mappings at runtime from hardware parameters;
its §3 observes that the closed-form answer is near- but not always
exactly optimal.  This package refines it and amortises the refinement:

  ``signature``  canonical workload signatures and hardware keys (the
                 JAX package's keys for the same workload),
  ``cache``      an LRU and a JSON file of refined plans (versioned, safe
                 under concurrent writers), per checkout by default,
  ``dispatch``   the one entry point every op and the serving router
                 resolve their plans through: Eq. 1 seed -> cache ->
                 refine -> memoise, under ``MappingPolicy.TUNED``.
"""

from repro_torch.tuner.cache import CacheStats, TuningCache, \
    default_cache_path
from repro_torch.tuner.dispatch import (KERNEL_REGISTRY, MEASURE_MODES,
                                        KernelSpec, ResolveInfo,
                                        get_default_cache, register_kernel,
                                        resolve_plan, set_default_cache,
                                        tuned_call)
from repro_torch.tuner.signature import (SCHEMA_VERSION, WorkloadSignature,
                                         hardware_key, workload_signature)

__all__ = [
    "SCHEMA_VERSION",
    "WorkloadSignature",
    "workload_signature",
    "hardware_key",
    "CacheStats",
    "TuningCache",
    "default_cache_path",
    "KernelSpec",
    "KERNEL_REGISTRY",
    "MEASURE_MODES",
    "ResolveInfo",
    "register_kernel",
    "resolve_plan",
    "tuned_call",
    "get_default_cache",
    "set_default_cache",
]
