"""Algorithm constants, equal to the JAX package's
(``smart_crossover_tpu/parameters.py``), which mirror the reference
implementation's artificial-variable and reduced-cost tests."""

TOLERANCE_FOR_ARTIFICIAL_VARS = 1e-8
TOLERANCE_FOR_REDUCED_COSTS = 1e-6

# network crossover (CNET / TNET): column generation grows its subproblem
# by this factor per round
COLUMN_GENERATION_RATIO = 2

# entropic regularisation of the Sinkhorn warm start, relative to max cost
SINKHORN_DEFAULT_REG = 1e-2
NETWORK_SIMPLEX_MAX_ITERS = 10_000_000
