"""Federation runtime, ported from ``repro.fed``: aggregation policies, the
orchestrator on the round and event clocks, the event clock's primitives
(``simtime``, with the counter-based profile sampler ``profile_rng``), and
``checkpoint``, which persists a run (params, server state, round, the
async late buffer, the event queue and virtual clock) in the reference's
format so long runs survive restarts."""

from .aggregator import (AggregationStats, Aggregator,  # noqa: F401
                         AsyncBufferedAggregator, FlatAggregator,
                         LevelStats, TreeAggregator, make_aggregator)
from .checkpoint import latest_round, restore, save  # noqa: F401
from .orchestrator import (FedRunResult, FederationConfig,  # noqa: F401
                           Orchestrator, RoundRecord, StragglerModel,
                           run_federated)
from .simtime import (BucketedEventQueue, ClientProfile,  # noqa: F401
                      Event, EventQueue, HeterogeneityConfig,
                      HeterogeneityModel, PopulationModel,
                      PROFILE_STREAMS, SimTimeConfig)
