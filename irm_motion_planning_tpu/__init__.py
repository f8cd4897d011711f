"""irm_motion_planning_tpu — a batched RKHS trajectory-optimization engine.

A from-scratch JAX/XLA re-design of the capabilities of
simongroeger/irm_motion_planning: collision-free trajectory planning for a
planar n-link arm via RKHS trajectory parametrization and penalty-method
functional-gradient optimization — batched over hundreds of thousands of
scenarios per GPU and sharded over a device mesh.
"""

from .config import (
    PlannerConfig,
    REFERENCE_FINAL_COST,
    REFERENCE_INNER_SCHEDULE_BLS,
    REFERENCE_INNER_SCHEDULE_GD,
)
from .models.rkhs import Basis, make_basis, evaluate, evaluate_at, init_alpha
from .ops.scenario import (
    Scenario,
    make_scenario,
    reference_scenario,
    random_scenarios,
    replicate_scenario,
)
from .ops.costs import (
    Penalty,
    initial_penalty,
    total_cost,
    total_cost_grad,
    cost_and_grad,
    constraints_fulfilled,
    constraint_report,
    solution_quality,
)

__version__ = "0.1.0"
