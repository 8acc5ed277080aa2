"""Graph similarity serving on the port: the batched range / top-k
``GraphQueryEngine`` and its shared verification worklist."""
from repro_torch.serve.graph_engine import (GraphQuery, GraphQueryEngine,
                                            TopKState, VerifyScheduler)

__all__ = ["GraphQuery", "GraphQueryEngine", "TopKState", "VerifyScheduler"]
