"""Hybrid bit-packed block decode: the packed FilterSlab's F_D carrier
(DESIGN.md §3, §11)."""
