"""Geometry layer: mesh container, tangent bases, FEM quantities, synthetic
surfaces and the S1 surface reconstruction. Counterpart of
manifold_flow_tpu.geometry."""

from manifold_flow_tpu_torch.geometry import reconstruct, synthetic
from manifold_flow_tpu_torch.geometry.fem_quantities import (
    hat_gradients,
    mass_integrals,
    triangle_areas,
    vertex_normals_from_cells,
)
from manifold_flow_tpu_torch.geometry.mesh import TriMesh, build_mesh
from manifold_flow_tpu_torch.geometry.tangent import (
    express_on_basis,
    position_diff_on_basis,
    project_to_plane,
    tangent_basis,
)

__all__ = [
    "TriMesh", "build_mesh", "reconstruct", "synthetic", "tangent_basis",
    "project_to_plane",
    "express_on_basis", "position_diff_on_basis", "hat_gradients",
    "triangle_areas", "vertex_normals_from_cells", "mass_integrals",
]
