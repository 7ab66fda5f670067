"""Federation runtime (round clock): aggregation policies and the
orchestrator, ported from ``repro.fed``."""

from .aggregator import (AggregationStats, Aggregator,  # noqa: F401
                         AsyncBufferedAggregator, FlatAggregator,
                         LevelStats, TreeAggregator, make_aggregator)
from .orchestrator import (FedRunResult, FederationConfig,  # noqa: F401
                           Orchestrator, RoundRecord, StragglerModel,
                           run_federated)
