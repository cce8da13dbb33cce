"""Instance readers, writers and generators of the PyTorch port (host
numpy / scipy copies of ``smart_crossover_tpu/data``)."""
from smart_crossover_tpu_torch.data.dimacs import read_dimacs_min
from smart_crossover_tpu_torch.data.dimacs_write import write_dimacs_min
from smart_crossover_tpu_torch.data.loaders import load_instance, save_instance
from smart_crossover_tpu_torch.data.lp_format import read_lp, write_lp
from smart_crossover_tpu_torch.data.lp_gen import random_sparse_lp
from smart_crossover_tpu_torch.data.mcf_gen import (
    goto_like_mcf,
    transshipment_mcf,
)
from smart_crossover_tpu_torch.data.mps import read_mps
from smart_crossover_tpu_torch.data.mps_write import write_mps
from smart_crossover_tpu_torch.data.ot_gen import (
    images_to_ot,
    mnist_like_ot_suite,
    random_ot_batch,
    synthetic_digits,
)
from smart_crossover_tpu_torch.data.results import ResultStore

__all__ = [
    "ResultStore",
    "goto_like_mcf",
    "images_to_ot",
    "load_instance",
    "mnist_like_ot_suite",
    "random_ot_batch",
    "random_sparse_lp",
    "read_dimacs_min",
    "read_lp",
    "read_mps",
    "save_instance",
    "synthetic_digits",
    "transshipment_mcf",
    "write_dimacs_min",
    "write_lp",
    "write_mps",
]
