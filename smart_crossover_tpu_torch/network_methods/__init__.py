"""network_methods of the PyTorch port (see smart_crossover_tpu/network_methods)."""
