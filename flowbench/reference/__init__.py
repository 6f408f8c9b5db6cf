"""The plain reference the benchmark holds the port's outputs against.

numpy and scipy only: it imports neither JAX, nor the JAX package, nor
anything of `manifold_flow_tpu_torch`, and takes nothing the port made
except the outputs it judges. Every function computes in the dtype it is
given (float64 for the reference, float32 for the control), so that the
same code serves as the control put in the program's place.

- `geometry`: the surface's P1 quantities (areas, normals, tangent bases,
  hat gradients, adjacency), from the points and triangles alone.
- `rbf`: S2's RBF interpolation of amplitudes and of phases (scipy.Rbf's
  multiquadric semantics) and the Hilbert phase.
- `flow`: S3's P1-FEM optical-flow system, one sparse solve per frame.
- `analysis`: S3's singularity detection and Jacobian classification.
- `fields`: S4's SVD and S5's phase wave speed.
"""
