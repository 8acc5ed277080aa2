"""Reduced query region (Section 4).

Each graph is the 2-D point (|V|, |E|).  The plane is partitioned into
45-degree-rotated square subregions A_{i,j} of diagonal length ``l`` around
an initial division point (x0, y0); the number-count filter becomes the L1
ball |x - |V_h|| + |y - |E_h|| <= tau, and the query region Q_h is the set
of subregions intersecting it — formula (1):

  i1 = floor((|E_h| - tau + |V_h| - (x0+y0)) / l)
  i2 = floor((|E_h| + tau + |V_h| - (x0+y0)) / l)
  j1 = floor((|E_h| - tau - |V_h| - (y0-x0)) / l)
  j2 = floor((|E_h| + tau - |V_h| - (y0-x0)) / l)

Subregion coordinates of a point (x, y):
  i = floor(((x+y) - (x0+y0)) / l),   j = floor(((y-x) - (y0-x0)) / l)
(the paper's 1/sqrt(2) factors cancel between offset and side length).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np


@dataclass(frozen=True)
class RegionPartition:
    """Partition parameters (x0, y0, l)."""

    x0: int
    y0: int
    l: int = 4

    def region_of(self, nv, ne):
        """(i, j) subregion indices; vectorised over numpy inputs."""
        nv = np.asarray(nv, np.int64)
        ne = np.asarray(ne, np.int64)
        i = np.floor_divide((nv + ne) - (self.x0 + self.y0), self.l)
        j = np.floor_divide((ne - nv) - (self.y0 - self.x0), self.l)
        return i, j

    def query_region(self, nv_h: int, ne_h: int, tau: int) -> Tuple[int, int, int, int]:
        """Formula (1): inclusive bounds (i1, i2, j1, j2)."""
        s, d = self.x0 + self.y0, self.y0 - self.x0
        i1 = (ne_h - tau + nv_h - s) // self.l
        i2 = (ne_h + tau + nv_h - s) // self.l
        j1 = (ne_h - tau - nv_h - d) // self.l
        j2 = (ne_h + tau - nv_h - d) // self.l
        return i1, i2, j1, j2

    def regions_in_query(self, nv_h: int, ne_h: int, tau: int) -> List[Tuple[int, int]]:
        i1, i2, j1, j2 = self.query_region(nv_h, ne_h, tau)
        return [(i, j) for i in range(i1, i2 + 1) for j in range(j1, j2 + 1)]


def default_partition(nv: np.ndarray, ne: np.ndarray, l: int = 4) -> RegionPartition:
    """Initial division point at the median graph — keeps |i|,|j| small."""
    x0 = int(np.median(nv)) if len(nv) else 0
    y0 = int(np.median(ne)) if len(ne) else 0
    return RegionPartition(x0=x0, y0=y0, l=l)


def group_by_region(part: RegionPartition, nv: np.ndarray, ne: np.ndarray
                    ) -> Dict[Tuple[int, int], np.ndarray]:
    """Map each subregion (i, j) to the array of graph ids inside it."""
    i, j = part.region_of(nv, ne)
    out: Dict[Tuple[int, int], List[int]] = {}
    for gid, key in enumerate(zip(i.tolist(), j.tolist())):
        out.setdefault(key, []).append(gid)
    return {k: np.asarray(v, np.int64) for k, v in out.items()}
