"""network_methods of the PyTorch port (see smart_crossover_tpu/network_methods)."""
from smart_crossover_tpu_torch.network_methods.algorithms import (
    column_generation,
    network_crossover,
)
from smart_crossover_tpu_torch.network_methods.managers import (
    MCFManager,
    NetworkManager,
    OTManager,
)
from smart_crossover_tpu_torch.network_methods.tree_bi import tree_basis_identify

__all__ = [
    "network_crossover",
    "column_generation",
    "MCFManager",
    "OTManager",
    "NetworkManager",
    "tree_basis_identify",
]
