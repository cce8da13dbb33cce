"""ops of the PyTorch port (see smart_crossover_tpu/ops)."""
from smart_crossover_tpu_torch.ops.mst import boruvka_bipartite_mst
from smart_crossover_tpu_torch.ops.ranking import (
    mcf_flow_indicators,
    ot_flow_indicators,
    sort_flows,
)
from smart_crossover_tpu_torch.ops.tree import (
    bipartite_tree_solve,
    push_to_bfs,
)

__all__ = [
    "mcf_flow_indicators",
    "ot_flow_indicators",
    "sort_flows",
    "boruvka_bipartite_mst",
    "bipartite_tree_solve",
    "push_to_bfs",
]
