"""PyTorch / CUDA port of smart_crossover_tpu: the certified-exact batched
OT crossover on an NVIDIA Hopper card.

The layout mirrors ``smart_crossover_tpu/``; each module names its JAX
counterpart.  Plain tensor code is PyTorch; the two TPU kernels on this
path are hand-written CUDA (``csrc/``), built with nvcc at first use.  The
package imports torch, numpy and scipy, never jax.
"""
from smart_crossover_tpu_torch._build import (
    kernel_launch_counts,
    reset_kernel_launch_counts,
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
    batched_tnet_exact_device,
    tnet_single,
)

__all__ = [
    "OTCertificate",
    "batched_tnet",
    "batched_tnet_exact_device",
    "batched_transport_simplex_mega",
    "certify_ot_basis",
    "certify_ot_basis_batch",
    "kernel_launch_counts",
    "reset_kernel_launch_counts",
    "sinkhorn_plan_fused",
    "tnet_single",
]
