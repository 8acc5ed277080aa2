"""Fused q-gram filter cascade, query-batched (DESIGN.md §13)."""
