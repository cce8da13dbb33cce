"""parallel of the PyTorch port (see smart_crossover_tpu/parallel).

The single-device pipelines are ported.  The mesh and the sharded
pipelines are ROADMAP 1.15 (multi-device): their names are here, and each
raises NotImplementedError naming that item when called.
"""
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet,
    batched_tnet_exact,
    batched_tnet_exact_device,
    tnet_single,
)
from smart_crossover_tpu_torch.parallel.batched_lp import batched_lp_crossover

BATCH_AXIS = "batch"
MODEL_AXIS = "model"


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP 1.15, multi-device")

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = "Not ported yet (ROADMAP 1.15): raises NotImplementedError."
    return fn


make_mesh = _not_ported("make_mesh")
sharded_batched_tnet = _not_ported("sharded_batched_tnet")
sharded_batched_tnet_exact_device = _not_ported(
    "sharded_batched_tnet_exact_device")
sharded_projector = _not_ported("sharded_projector")
sharded_pdhg = _not_ported("sharded_pdhg")
sharded_mcf_flow_indicators = _not_ported("sharded_mcf_flow_indicators")
sharded_sorted_flows = _not_ported("sharded_sorted_flows")
sharded_tnet_single = _not_ported("sharded_tnet_single")
mcf_scenario_sweep = _not_ported("mcf_scenario_sweep")
sharded_sinkhorn_plan = _not_ported("sharded_sinkhorn_plan")

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
]
