"""The perturbation crossover for general LPs (host copies of
``smart_crossover_tpu/lp_methods``)."""
from smart_crossover_tpu_torch.lp_methods.algorithms import run_perturb_algorithm
from smart_crossover_tpu_torch.lp_methods.lp_manager import LPManager

__all__ = ["run_perturb_algorithm", "LPManager"]
