"""Algorithm constants, equal to the JAX package's
(``smart_crossover_tpu/parameters.py``), which mirror the reference
implementation's artificial-variable and reduced-cost tests."""

TOLERANCE_FOR_ARTIFICIAL_VARS = 1e-8
TOLERANCE_FOR_REDUCED_COSTS = 1e-6

# network crossover (CNET / TNET): column generation grows its subproblem
# by this factor per round
COLUMN_GENERATION_RATIO = 2

# perturbation crossover (lp_methods/algorithms.py)
OPTIMAL_FACE_ESTIMATOR = 1e-3
OPTIMAL_FACE_ESTIMATOR_UPDATE_RATIO = 1e-5
PERTURB_THRESHOLD = 1e-6
CONSTANT_SCALE_FACTOR = 1e-2
PRIMAL_DUAL_GAP_THRESHOLD = 1e-8
PROJECTOR_THRESHOLD = 1e-8
PERTURB_UPPER_BOUND = 1e6

# in-house solver defaults
SINKHORN_DEFAULT_REG = 1e-2   # entropic regularisation, relative to max cost
SINKHORN_MAX_ITERS = 1000
PDHG_MAX_ITERS = 100_000
PDHG_RESTART_PERIOD = 40
IPM_MAX_ITERS = 200
SIMPLEX_MAX_ITERS = 200_000
NETWORK_SIMPLEX_MAX_ITERS = 10_000_000
CG_TOL = 1e-8
CG_MAX_ITERS = 1000
