"""Attributed-graph substrate: containers, generators, batching."""

from repro_torch.graphs.graph import Graph, GraphDB
from repro_torch.graphs.generators import (
    aids_like_db,
    graphgen_db,
    random_graph,
    perturb_graph,
)
from repro_torch.graphs.batching import PaddedGraphBatch

__all__ = [
    "Graph",
    "GraphDB",
    "aids_like_db",
    "graphgen_db",
    "random_graph",
    "perturb_graph",
    "PaddedGraphBatch",
]
