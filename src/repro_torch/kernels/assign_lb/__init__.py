"""Batched branch-assignment GED lower bounds (DESIGN.md §16)."""
