"""The paper's own configuration: the SharedDB engine over the TPC-W schema.

This mirrors Figure 6 of the paper (26 database operators over the nine TPC-W
base tables) at engine scale, plus the cycle/queue capacities that implement
the batch-oriented execution model.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    name: str = "shareddb-tpcw"
    family: str = "engine"
    # Query-batch capacity per heartbeat cycle (global Q_max is per-operator
    # capacity x live templates; 1024 matches "hundreds of concurrent
    # queries and updates" in the paper).
    max_queries_per_cycle: int = 1024
    # Per-operator concurrent-query capacity (bitmask width = ceil(cap/32)).
    operator_query_capacity: int = 256
    # Storage capacities (rows) for the scaled TPC-W instance used in
    # benchmarks; base cardinalities follow the TPC-W scale rules.
    scale_items: int = 10000
    scale_customers: int = 28800
    max_results_per_query: int = 128
    updates_per_cycle: int = 256
    # SLA model (paper §3.5): provision so worst-case cycle <= sla_seconds/2.
    sla_seconds: float = 3.0


CONFIG = EngineConfig()
