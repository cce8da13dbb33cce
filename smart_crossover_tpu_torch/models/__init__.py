from smart_crossover_tpu_torch.models.formats import (
    GeneralLP,
    MinCostFlow,
    OptTransport,
    StandardLP,
)
from smart_crossover_tpu_torch.models.output import Basis, Output

__all__ = [
    "GeneralLP",
    "StandardLP",
    "MinCostFlow",
    "OptTransport",
    "Basis",
    "Output",
]
