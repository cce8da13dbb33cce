"""PyTorch / CUDA port of smart_crossover_tpu on an NVIDIA Hopper card: the
certified-exact batched OT crossover (device route with host repair, and
the host route), the paper's network crossover (``sinkhorn`` then
``network_crossover``: TNET, CNET_OT, CNET_MCF), the dense-LP
first-order path (PDHG warm start, then an exact host vertex), and the LP
front door: the ``solve_lp`` / ``solve_mcf`` / ``solve_ot`` facade and the
paper's perturbation crossover for general LPs (``run_perturb_algorithm``,
host barrier and simplex), and the barrier fleets (``ipm_fleet``: a batched
Mehrotra IPM on the card, then a host f64 endgame).

The layout mirrors ``smart_crossover_tpu/``; each module names its JAX
counterpart.  Plain tensor code is PyTorch; every TPU kernel of the JAX
package is hand-written CUDA here (``csrc/``), built with nvcc at first
use.  The package imports torch, numpy and scipy, never jax.
"""
from smart_crossover_tpu_torch._build import (
    kernel_launch_counts,
    reset_kernel_launch_counts,
)
from smart_crossover_tpu_torch.lp_methods import run_perturb_algorithm
from smart_crossover_tpu_torch.models import (
    Basis,
    GeneralLP,
    MinCostFlow,
    OptTransport,
    Output,
    StandardLP,
)
from smart_crossover_tpu_torch.network_methods import (
    column_generation,
    network_crossover,
)
from smart_crossover_tpu_torch.network_methods.certify import (
    OTCertificate,
    certify_ot_basis,
    certify_ot_basis_batch,
)
from smart_crossover_tpu_torch.ops.sinkhorn_fused import sinkhorn_plan_fused
from smart_crossover_tpu_torch.ops.transport_simplex_mega import (
    batched_transport_simplex_mega,
)
from smart_crossover_tpu_torch.parallel.batched import (
    batched_tnet,
    batched_tnet_exact,
    batched_tnet_exact_device,
    tnet_single,
)
from smart_crossover_tpu_torch.parallel.batched_lp import batched_lp_crossover
from smart_crossover_tpu_torch.solvers.ipm_fleet import ipm_fleet
from smart_crossover_tpu_torch.solvers.pdhg import PDHGResult, pdhg_solve
from smart_crossover_tpu_torch.solvers.pdhg_batched import pdhg_dense_batched
from smart_crossover_tpu_torch.solvers.settings import SolverSettings
from smart_crossover_tpu_torch.solvers.sinkhorn import sinkhorn
from smart_crossover_tpu_torch.solvers.solving import (
    solve_lp,
    solve_mcf,
    solve_ot,
)
from smart_crossover_tpu_torch.utils.timer import Timer

__version__ = "0.1.0"

__all__ = [
    "Basis",
    "GeneralLP",
    "MinCostFlow",
    "OTCertificate",
    "OptTransport",
    "Output",
    "PDHGResult",
    "SolverSettings",
    "StandardLP",
    "Timer",
    "__version__",
    "batched_lp_crossover",
    "batched_tnet",
    "batched_tnet_exact",
    "batched_tnet_exact_device",
    "batched_transport_simplex_mega",
    "certify_ot_basis",
    "certify_ot_basis_batch",
    "column_generation",
    "ipm_fleet",
    "kernel_launch_counts",
    "network_crossover",
    "pdhg_dense_batched",
    "pdhg_solve",
    "reset_kernel_launch_counts",
    "run_perturb_algorithm",
    "sinkhorn",
    "sinkhorn_plan_fused",
    "solve_lp",
    "solve_mcf",
    "solve_ot",
    "tnet_single",
]
