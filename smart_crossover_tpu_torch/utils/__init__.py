"""utils of the PyTorch port (see smart_crossover_tpu/utils)."""
