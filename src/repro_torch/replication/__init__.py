"""Dynamic expert-replica topology planning (DESIGN.md §12; the port's copy
of ``repro.replication``).

Plans *where replicas live*, not just how tokens split: water-filled
replica counts onto forecast loads, an EPLB-style move-minimizing
reorder, and a migration controller that prices topology changes in
migration bytes through the exact LPP-1 oracle (LPLB/EPLB-style;
SNIPPETS.md snippet 2).

The ``'replicated'`` placement strategy is registered by
``repro_torch.engine.registry`` (lazily, so the engine never imports
this package at module load and disabled runs stay byte-identical).
"""
from .controller import TopologyController
from .topology import plan_topology, replica_histogram, replicated_placement

__all__ = [
    "TopologyController",
    "plan_topology",
    "replica_histogram",
    "replicated_placement",
]
