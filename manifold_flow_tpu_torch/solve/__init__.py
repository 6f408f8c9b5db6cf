"""Linear solvers for the per-frame FEM systems: PCG (solve.cg) with
block-Jacobi or the two-level preconditioner (solve.coarse), mixed-precision
refinement (solve.refine), the dense direct solve (solve.cholesky) and the
API (solve.api). Counterpart of manifold_flow_tpu.solve."""

from manifold_flow_tpu_torch.solve.api import compute_velocity_fields
from manifold_flow_tpu_torch.solve.cg import solve_cg
from manifold_flow_tpu_torch.solve.cholesky import solve_cholesky
from manifold_flow_tpu_torch.solve.coarse import build_tables, make_two_level
from manifold_flow_tpu_torch.solve.refine import solve_refined

__all__ = ["compute_velocity_fields", "solve_cg", "solve_cholesky",
           "solve_refined", "build_tables", "make_two_level"]
