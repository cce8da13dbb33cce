"""parallel of the PyTorch port (see smart_crossover_tpu/parallel).

The single-device pipelines, and the mesh-sharded ones on
``torch.distributed``: one process per rank, each called with the full
arguments of the JAX signature and returning the gathered result
(``parallel/mesh.py``).
"""
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet,
    batched_tnet_exact,
    batched_tnet_exact_device,
    sharded_batched_tnet,
    sharded_batched_tnet_exact_device,
    tnet_single,
)
from smart_crossover_tpu_torch.parallel.batched_lp import batched_lp_crossover
from smart_crossover_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    MODEL_AXIS,
    init_distributed,
    make_mesh,
)
from smart_crossover_tpu_torch.parallel.pdhg_sharded import sharded_pdhg
from smart_crossover_tpu_torch.parallel.projector import (
    sharded_projector,
    sharded_sinkhorn_plan,
)
from smart_crossover_tpu_torch.parallel.ranking_sharded import (
    sharded_mcf_flow_indicators,
    sharded_sorted_flows,
)
from smart_crossover_tpu_torch.parallel.scenarios import (
    lp_scenario_sweep,
    mcf_scenario_sweep,
)
from smart_crossover_tpu_torch.parallel.tnet_sharded import sharded_tnet_single

__all__ = [
    "make_mesh",
    "BATCH_AXIS",
    "MODEL_AXIS",
    "batched_tnet",
    "batched_tnet_exact",
    "batched_lp_crossover",
    "batched_tnet_exact_device",
    "sharded_batched_tnet",
    "sharded_batched_tnet_exact_device",
    "tnet_single",
    "sharded_projector",
    "sharded_pdhg",
    "sharded_mcf_flow_indicators",
    "sharded_sorted_flows",
    "sharded_tnet_single",
    "mcf_scenario_sweep",
    "sharded_sinkhorn_plan",
    "init_distributed",
]
