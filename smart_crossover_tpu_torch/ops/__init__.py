"""ops of the PyTorch port (see smart_crossover_tpu/ops)."""
