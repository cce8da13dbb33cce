"""The benchmark of smart_crossover_tpu_torch on one NVIDIA H100 (see
README.md).  Its per-name files (requests, metrics, end-to-end metrics)
are loaded by path, so none of them shadows an installed module."""
