"""Carry a mesh and coarse tables across from the JAX package.

`mesh_from_jax_arrays` takes the array leaves of a `manifold_flow_tpu`
TriMesh, handed over as numpy arrays, and builds the port's TriMesh from
them, so both packages can compute on exactly the same geometry.
`coarse_tables_from_jax_arrays` does the same for the aggregation of a JAX
`solve.coarse.CoarseTables`. This module imports neither JAX nor the JAX
package: the caller converts the leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from manifold_flow_tpu_torch.geometry.mesh import ARRAY_FIELDS, TriMesh
from manifold_flow_tpu_torch.solve.coarse import CoarseTables, tables_from_aggregation


def mesh_from_jax_arrays(arrays: dict[str, np.ndarray], device="cpu") -> TriMesh:
    """The port's TriMesh from a JAX TriMesh's leaves, as numpy arrays.

    `arrays` maps each TriMesh array field name to its value, for example
    ``{name: np.asarray(getattr(jax_mesh, name)) for name in ARRAY_FIELDS}``.
    Padded JAX meshes (`pad_mesh`) are refused: the port has no padding. The
    valid counts may be passed as ``n_valid_vertices`` / ``n_valid_triangles``
    and must then be 0 or the full counts.
    """
    missing = [name for name in ARRAY_FIELDS if name not in arrays]
    if missing:
        raise ValueError(f"missing TriMesh arrays: {missing}")
    n = int(np.shape(arrays["points"])[0])
    m = int(np.shape(arrays["triangles"])[0])
    for key, full in (("n_valid_vertices", n), ("n_valid_triangles", m)):
        valid = int(np.asarray(arrays.get(key, 0)))
        if valid not in (0, full):
            raise ValueError(
                f"padded JAX meshes are not supported ({key}={valid} of {full})")
    tensors = {name: torch.from_numpy(np.array(arrays[name], order="C"))
               for name in ARRAY_FIELDS}
    return TriMesh(**tensors).to(device)


def coarse_tables_from_jax_arrays(arrays: dict, mesh: TriMesh) -> CoarseTables:
    """The port's CoarseTables from a JAX CoarseTables, on `mesh`'s device.

    `arrays` holds ``agg``, ``seeds`` and ``members`` as numpy arrays and
    ``n_coarse`` as an int. The members table is rebuilt from the
    aggregation and must equal the JAX one (tables of a padded JAX mesh,
    with a pad aggregate, are refused); K8's assembly CSR, which the JAX
    package does not have, is built from `mesh`'s triangles.
    """
    tables = tables_from_aggregation(mesh, arrays["agg"], arrays["seeds"])
    if tables.n_coarse != int(arrays["n_coarse"]) or not np.array_equal(
            tables.members.cpu().numpy(), np.asarray(arrays["members"])):
        raise ValueError("the JAX coarse tables do not match their aggregation "
                         "on this mesh (a padded JAX mesh, or another mesh)")
    return tables
