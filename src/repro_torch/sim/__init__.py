from repro_torch.sim.simulator import (  # noqa: F401
    ClusterSim, SessionStallError, SimBackend, SimConfig, SimMetrics,
)
from repro_torch.sim.policies import (  # noqa: F401
    ColocationPolicy, DisaggregationPolicy, DynaServePolicy,
    ElasticDynaServePolicy,
)
