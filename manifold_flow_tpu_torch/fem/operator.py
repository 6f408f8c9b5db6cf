"""Matrix-free batched operator A_k = a1_k + lambda * a2.

Counterpart of manifold_flow_tpu/fem/operator.py. The a1 part is never
materialized: its local block is B1 = (A/12) * (J + I) ⊗ g g^T, so A1 x
reduces to two small contractions per triangle. `matvec` and `residual` go
through the `fem_matvec` kernel wrapper (CUDA tensors launch the kernel, CPU
tensors take its plain version); the refinement residual f - A x is the f64
instance of the same kernel, where the JAX package needed two-float32 pairs.
"""

from __future__ import annotations

import dataclasses

import torch

from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.geometry.mesh import TriMesh, mesh_cached
from manifold_flow_tpu_torch.kernels import fem as kfem
# The 2x2 block helpers live beside the kernels whose plain versions use them.
from manifold_flow_tpu_torch.kernels.fem import apply_block_diag, invert_2x2_blocks
from manifold_flow_tpu_torch.utils import profiling

__all__ = ["FlowOperator", "make_operator", "block_jacobi_inverse", "jacobi_inputs",
           "invert_2x2_blocks", "apply_block_diag"]


@dataclasses.dataclass(frozen=True)
class FlowOperator:
    """Batched linear operator for T frames over one mesh.

      dof          (M, 6)       int32 global DOF ids per triangle
      blocks2      (M, 6, 6)    a2 local blocks (frame-independent)
      g            (T, M, 3, 2) per-frame a1 factors (grad_M I . e)
      w_scale      (M,)         A/12 scale of the a1 contraction
      lambda_      float        regularization weight
      gather_base  (N, C)       int32 vertex -> (cell*6 + slot*2) table
      tiles        VertexTiles  K1's tables (assembly.vertex_tiles)
    """

    dof: torch.Tensor
    blocks2: torch.Tensor
    g: torch.Tensor
    w_scale: torch.Tensor
    lambda_: float
    gather_base: torch.Tensor
    tiles: assembly.VertexTiles

    def astype(self, dtype: torch.dtype) -> "FlowOperator":
        """The operator rounded to `dtype` (lambda_ too, as the JAX refined
        solve's f32 operator holds the f32-rounded high-precision one)."""
        lam = torch.tensor(self.lambda_, dtype=dtype).item()
        return dataclasses.replace(
            self, blocks2=self.blocks2.to(dtype), g=self.g.to(dtype),
            w_scale=self.w_scale.to(dtype), lambda_=lam,
            tiles=self.tiles._replace(blocks2=self.tiles.blocks2.to(dtype)))

    def local_contributions(self, x: torch.Tensor) -> torch.Tensor:
        """Per-triangle local products y_loc (T, M, 6) of A x (plain torch)."""
        return kfem.local_contributions(x, self.dof, self.blocks2, self.g,
                                        self.w_scale, self.lambda_)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Apply A to x (T, 2N) -> (T, 2N)."""
        return kfem.fem_matvec(x, self.dof, self.blocks2, self.g, self.w_scale,
                               self.lambda_, self.gather_base, self.tiles)

    def residual(self, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """f - A x in one pass (the subtraction is fused into the reduction)."""
        return kfem.fem_matvec(x, self.dof, self.blocks2, self.g, self.w_scale,
                               self.lambda_, self.gather_base, self.tiles, f=f)


def make_operator(mesh: TriMesh, g: torch.Tensor, lambda_: float) -> FlowOperator:
    """Operator for the frames of the a1 factors g (T, M, 3, 2).

    The JAX `make_operator` takes the movie and computes g itself; here g
    comes from `kernels.fem.frame_factors_rhs` (or `assembly.frame_factors`),
    which builds it together with the right-hand side. The frame-independent
    tables are computed in the mesh dtype and cast to g's dtype; K1's tile
    tables take the mesh's cached index tables (`assembly.mesh_cell_tiles`,
    built on the host once per mesh) and gather the cells' data from them.

    Counts (utils.profiling) `solve.tile_cells`, the cells K1's tiles list,
    and `solve.cells`, the mesh's: their ratio is the tiles' listing factor
    (geometry.order), read from the tables' sizes alone.
    """
    dtype = g.dtype
    dof = assembly.local_dof_indices(mesh)
    blocks2 = assembly.a2_blocks(mesh).to(dtype).contiguous()
    gather_base = assembly.gather_base_table(mesh)
    tiles = assembly.vertex_tiles(gather_base, dof, blocks2,
                                  index=assembly.mesh_cell_tiles(mesh))
    profiling.count("solve.tile_cells", tiles.cells.numel())
    profiling.count("solve.cells", mesh.n_triangles)
    return FlowOperator(
        dof=dof,
        blocks2=blocks2,
        g=g.contiguous(),
        w_scale=(mesh.areas / 12.0).to(dtype),
        lambda_=float(lambda_),
        gather_base=gather_base,
        tiles=tiles,
    )


def jacobi_inputs(mesh: TriMesh, dtype: torch.dtype) -> tuple:
    """The `jacobi_blocks` kernel's per-mesh inputs in `dtype`: reg (M, 3, 2,
    2) (`assembly.corner_regularization`), areas (M,) and gather_base (N, C)
    int32, built once per mesh and dtype (`mesh_cached`, pinned on the mesh
    tensors they are computed from)."""
    return mesh_cached(
        (mesh.triangles, mesh.basis, mesh.grad_w, mesh.areas, mesh.vertex_cells,
         mesh.vertex_cell_slot), ("jacobi_inputs", dtype),
        lambda: (assembly.corner_regularization(mesh, dtype).contiguous(),
                 mesh.areas.to(dtype).contiguous(), assembly.gather_base_table(mesh)))


def block_jacobi_inverse(mesh: TriMesh, g: torch.Tensor,
                         lambda_: float) -> torch.Tensor:
    """Inverted per-vertex 2x2 diagonal blocks (T, N, 2, 2) of A, in g's dtype
    (the `jacobi_blocks` kernel on CUDA tensors)."""
    reg, areas, gather_base = jacobi_inputs(mesh, g.dtype)
    return kfem.jacobi_blocks(g.contiguous(), reg, areas, lambda_, gather_base)
