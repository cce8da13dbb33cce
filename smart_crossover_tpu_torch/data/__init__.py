"""data of the PyTorch port (see smart_crossover_tpu/data); only the
synthetic min-cost-flow generators are ported so far."""
