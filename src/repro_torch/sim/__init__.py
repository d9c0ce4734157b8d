"""Scheduling policies.  The port has no simulator: the policies drive
``ServeSession`` over the torch ``EngineBackend``."""
from repro_torch.sim.policies import (  # noqa: F401
    ColocationPolicy, DisaggregationPolicy, DynaServePolicy,
    ElasticDynaServePolicy,
)
