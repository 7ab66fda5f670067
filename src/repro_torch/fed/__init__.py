"""Federation runtime, ported from ``repro.fed``: aggregation policies, the
orchestrator on the round and event clocks, and the event clock's
primitives (``simtime``, with the counter-based profile sampler
``profile_rng``)."""

from .aggregator import (AggregationStats, Aggregator,  # noqa: F401
                         AsyncBufferedAggregator, FlatAggregator,
                         LevelStats, TreeAggregator, make_aggregator)
from .orchestrator import (FedRunResult, FederationConfig,  # noqa: F401
                           Orchestrator, RoundRecord, StragglerModel,
                           run_federated)
from .simtime import (BucketedEventQueue, ClientProfile,  # noqa: F401
                      Event, EventQueue, HeterogeneityConfig,
                      HeterogeneityModel, PopulationModel,
                      PROFILE_STREAMS, SimTimeConfig)
