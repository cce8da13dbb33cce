"""Acceptance tolerances, equal to the JAX package's
(``smart_crossover_tpu/parameters.py``), which mirror the reference
implementation's artificial-variable and reduced-cost tests."""

TOLERANCE_FOR_ARTIFICIAL_VARS = 1e-8
TOLERANCE_FOR_REDUCED_COSTS = 1e-6
