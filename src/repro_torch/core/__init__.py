# The MSQ-Index system on PyTorch / CUDA (the slice ported so far):
#   qgrams       — degree-/label-based q-gram extraction + vocabularies
#   filters      — the admissible lower-bound filters (Lemmas 2, 5)
#   region       — reduced query region (Section 4, formula (1))
#   arrays, slab — the filter pass's array containers and FilterSlab
#   device_cache — per-bucket device-resident slab operands
#   engine       — batched multi-query candidate generation
#   search       — FlatMSQIndex (Algorithm 2 without the tree)
#   verify       — exact GED (A* with cutoff), host-side
#   tree         — the query four-tuple only

from repro_torch.core.search import FlatMSQIndex, QueryResult
from repro_torch.core.engine import (BatchedFilterEval, CandidateBatch,
                                     CandidateSource, bucket_queries)

__all__ = ["FlatMSQIndex", "QueryResult", "BatchedFilterEval",
           "CandidateBatch", "CandidateSource", "bucket_queries"]
