"""The paper's own AIDS configuration (Table 1): 42687 molecule graphs,
avg |V|=25.6 avg |E|=27.5, 62 vertex labels, 3 edge labels; subregion
length l=4 (Section 7.1)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class MSQConfig:
    name: str
    num_graphs: int
    n_vlabels: int
    n_elabels: int
    subregion_l: int = 4
    seed: int = 0
    # serving FilterSlab layout (DESIGN.md §11): 'dense' keeps the full
    # (B, U) F_D matrix resident, 'hot' keeps only a frequency-ordered
    # prefix of its columns dense (CSR tail corrected per batch),
    # 'packed' keeps the hybrid bit-packed rows and decodes on device.
    # Candidate sets are bit-identical across all three.
    slab_layout: str = "dense"
    # stage-1.5 batched assignment lower bound (DESIGN.md §16): provable
    # (LB <= GED), so match sets are bit-identical with it on or off — it
    # only prunes/tightens the verification worklist.  lb_hungarian > 0
    # additionally runs the exact Hungarian assignment on that many top-LB
    # survivors per query (host-side, off by default).
    assign_lb: bool = True
    lb_hungarian: int = 0


def get_config() -> MSQConfig:
    return MSQConfig(name="msq_aids", num_graphs=42687, n_vlabels=62,
                     n_elabels=3)
