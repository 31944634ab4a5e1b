"""osqp_tpu — a TPU-native operator-splitting QP solver.

A from-scratch JAX/XLA re-design with the capabilities of OSQP 0.6.2
(reference: the ANSI-C library at github.com/osqp/osqp):

    minimize    0.5 x' P x + q' x
    subject to  l <= A x <= u

Same algorithm family (ADMM with Ruiz equilibration, adaptive rho,
infeasibility certificates, solution polishing), accelerator-first
architecture:

* dense batched KKT algebra instead of sparse LDL' + AMD,
* the whole solve is one jitted ``lax.while_loop`` (state = pytree),
* native instance-batching: thousands of QPs per chip via one batched
  program (``osqp_tpu.batch``), sharded across meshes (``osqp_tpu.parallel``).
"""

__version__ = "0.1.0"

from . import constants
from .batch import BatchSolveResults, solve_batch
from .constants import (
    OSQP_DUAL_INFEASIBLE,
    OSQP_DUAL_INFEASIBLE_INACCURATE,
    OSQP_MAX_ITER_REACHED,
    OSQP_NON_CVX,
    OSQP_PRIMAL_INFEASIBLE,
    OSQP_PRIMAL_INFEASIBLE_INACCURATE,
    OSQP_SIGINT,
    OSQP_SOLVED,
    OSQP_SOLVED_INACCURATE,
    OSQP_TIME_LIMIT_REACHED,
    OSQP_UNSOLVED,
    ErrorCode,
    NonConvexError,
    OSQPError,
)
from .diff import make_qp_layer
from .large import SparseSolver, solve_sparse
from .parametric import BatchedSolver
from .solver import OSQP, Info, Results, Settings, Solver
from .types import DynSettings, QPData, ScalingData, StaticConfig

__all__ = [
    "OSQP",
    "Solver",
    "BatchedSolver",
    "solve_sparse",
    "SparseSolver",
    "make_qp_layer",
    "Settings",
    "Info",
    "Results",
    "solve_batch",
    "BatchSolveResults",
    "QPData",
    "ScalingData",
    "DynSettings",
    "StaticConfig",
    "OSQPError",
    "NonConvexError",
    "ErrorCode",
    "constants",
    "OSQP_SOLVED",
    "OSQP_SOLVED_INACCURATE",
    "OSQP_MAX_ITER_REACHED",
    "OSQP_PRIMAL_INFEASIBLE",
    "OSQP_PRIMAL_INFEASIBLE_INACCURATE",
    "OSQP_DUAL_INFEASIBLE",
    "OSQP_DUAL_INFEASIBLE_INACCURATE",
    "OSQP_NON_CVX",
    "OSQP_UNSOLVED",
    "OSQP_SIGINT",
    "OSQP_TIME_LIMIT_REACHED",
]
