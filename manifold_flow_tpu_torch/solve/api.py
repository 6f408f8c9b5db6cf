"""High-level velocity-field API.

Counterpart of manifold_flow_tpu/solve/api.py: one call solves every frame
of a potentials movie and returns the velocity DOFs in the reference's
layout (T-1, 2N) (dof = vertex + N * alpha).

Spans (utils.profiling): each window of frames is a `solve.window` (a
movie solved whole is one window), with `solve.setup` spans around its
right-hand side, operators and preconditioner, whose count of zeroed coarse
matrices is a `sync.solve.zeroed` read; solve.refine and solve.cg add
theirs inside; `solve.concat` joins the windows' results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from manifold_flow_tpu_torch.fem import assembly
from manifold_flow_tpu_torch.fem.operator import block_jacobi_inverse, make_operator
from manifold_flow_tpu_torch.geometry.mesh import TriMesh
from manifold_flow_tpu_torch.kernels import fem as kfem
from manifold_flow_tpu_torch.solve import coarse
from manifold_flow_tpu_torch.solve.cg import solve_cg
from manifold_flow_tpu_torch.solve.cholesky import solve_cholesky
from manifold_flow_tpu_torch.solve.refine import (
    DEFAULT_INNER_TOL,
    check_anchor_stride,
    solve_refined,
)
from manifold_flow_tpu_torch.utils import profiling

# precond='auto' picks the two-level preconditioner from this many vertices
# up: the JAX package's crossover (measured on a TPU), kept for parity;
# chip_smoke.py measures both preconditioners on either side of it.
TWO_LEVEL_MIN_VERTICES = 6000
# frame_chunk='auto' solves movies of more than FRAME_CHUNK_AUTO_MIN velocity
# frames in windows of FRAME_CHUNK_SIZE frames (the JAX package's values).
FRAME_CHUNK_SIZE = 104
FRAME_CHUNK_AUTO_MIN = 160

METHODS = ("cg", "refined", "cholesky", "auto")


class VelocityResult(NamedTuple):
    v_k: torch.Tensor         # (T-1, 2N) velocity DOFs
    e: torch.Tensor           # (N, 2, 3) tangent bases
    iterations: int           # CG iterations (inner iterations for 'refined')
    residual: torch.Tensor    # (T-1,) final |f - A x| per frame
    converged: torch.Tensor   # (T-1,) bool per frame
    coarse_zeroed: int = 0    # coarse matrices whose factorization failed, so
                              # their inverse was zeroed (two-level only),
                              # summed over the windows of a chunked solve


def build_rhs(mesh: TriMesh, potentials: torch.Tensor, times: torch.Tensor,
              potentials_next: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """a1 factors g (T-1, M, 3, 2) and RHS f (T-1, 2N) of a (T, N) movie.

    The JAX `build_rhs` returns f from an operator that already holds g; the
    `frame_factors_rhs` kernel builds both in one pass. `potentials_next`
    supports the reference's optional second movie I_k_2 for the time
    derivative (utils/compute_optical_flow.py:174-176); it defaults to
    `potentials`. The mesh tables are cast to the movie's dtype; the kernel's
    tiles are the mesh's cached ones, which the operator's K1 shares.
    """
    dtype = potentials.dtype
    nxt = potentials if potentials_next is None else potentials_next
    return kfem.frame_factors_rhs(
        potentials.contiguous(), nxt.contiguous(), times.contiguous(),
        mesh.triangles, mesh.grad_w.to(dtype), mesh.basis.to(dtype),
        mesh.areas.to(dtype), assembly.gather_base_table(mesh),
        assembly.mesh_cell_tiles(mesh))


def resolve_precond(mesh: TriMesh, precond: str) -> str:
    """'jacobi' or 'two_level': `precond` with 'auto' resolved (two_level
    from TWO_LEVEL_MIN_VERTICES vertices up); ValueError for another name."""
    if precond not in ("jacobi", "two_level", "auto"):
        raise ValueError(f"unknown precond: {precond!r}")
    if precond == "auto":
        return "two_level" if mesh.n_vertices >= TWO_LEVEL_MIN_VERTICES else "jacobi"
    return precond


def check_movie(mesh: TriMesh, potentials, times, method: str = "cg"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The movie (T, N) and its times (T,) on the mesh's device, in the
    dtype that geometry and movie combine in (promoted, as in JAX); raises
    ValueError for a movie that is not floating point, shapes that do not
    match the mesh or each other, fewer than 2 frames, or a movie that is
    not float64 for method='refined'."""
    potentials = torch.as_tensor(potentials, device=mesh.device)
    movie_dtype = potentials.dtype
    if not potentials.is_floating_point():
        raise ValueError(f"potentials must be floating point; got {movie_dtype}")
    dtype = torch.promote_types(movie_dtype, mesh.dtype)
    potentials = potentials.to(dtype)
    times = torch.as_tensor(times, device=mesh.device).to(dtype)
    if potentials.ndim != 2 or potentials.shape[1] != mesh.n_vertices:
        raise ValueError(
            f"potentials must be (T, N={mesh.n_vertices}); got {tuple(potentials.shape)}")
    if times.shape != (potentials.shape[0],):
        raise ValueError(
            f"times must be ({potentials.shape[0]},) to match the movie; "
            f"got {tuple(times.shape)}")
    if potentials.shape[0] < 2:
        raise ValueError("need at least 2 frames to form a velocity field")
    if method == "refined" and movie_dtype != torch.float64:
        raise ValueError(
            f"method='refined' needs float64 potentials; got {movie_dtype}")
    return potentials, times


def _chunked_velocity_fields(mesh: TriMesh, potentials: torch.Tensor,
                             times: torch.Tensor, chunk: int,
                             kwargs: dict) -> VelocityResult:
    """A long movie solved as contiguous windows of chunk + 1 potentials,
    each by the unchunked solve, one after the other on the host (the JAX
    package sequences the same windows with one lax.map program).

    The last window shifts back to end at the movie's end; its overlap
    re-solves frames whose first solutions are kept. Frame k comes from
    window min(k // chunk, n - 1) at offset k - start. Each window runs its
    own convergence loop, so `iterations` reports the largest count.
    """
    t_v = potentials.shape[0] - 1
    n_chunks = -(-t_v // chunk)
    parts = []
    for j in range(n_chunks):
        start = min(j * chunk, t_v - chunk)
        res = compute_velocity_fields(
            mesh, potentials[start: start + chunk + 1],
            times[start: start + chunk + 1], frame_chunk=None, **kwargs)
        # The frames k this window supplies, as offsets k - start.
        keep = slice(j * chunk - start, min((j + 1) * chunk, t_v) - start)
        parts.append((res.v_k[keep], res.iterations, res.residual[keep],
                      res.converged[keep], res.coarse_zeroed))
    v_k, iters, resid, conv, zeroed = zip(*parts)
    with profiling.span("solve.concat"):
        return VelocityResult(torch.cat(v_k), mesh.basis, max(iters),
                              torch.cat(resid), torch.cat(conv), sum(zeroed))


def compute_velocity_fields(
    mesh: TriMesh,
    potentials,
    times,
    lambda_: float = 0.01,
    method: str = "cg",
    tol: float = 1e-10,
    max_iter: int = 2000,
    precise_dots: bool = False,
    refine_steps: int = 2,
    potentials_next=None,
    precond: str = "auto",
    coarse_passes: int | None = None,
    coarse_a1: str = "full",
    inner_tol=DEFAULT_INNER_TOL,
    anchor_stride: int = 1,
    frame_chunk="auto",
) -> VelocityResult:
    """Solve (a1_k + lambda a2) V_k = f_k for every frame k.

    Args:
      mesh: TriMesh; the solve runs on its device.
      potentials: (T, N) scalar field movie (tensor or array).
      times: (T,) frame times in seconds.
      lambda_: regularization weight (config.yaml:3, default 0.01).
      method: 'cg' (batched PCG in the movie's dtype), 'refined' (f32 inner
        PCG with f64 residuals; needs float64 inputs), 'cholesky' (batched
        dense Cholesky with refinement, solve.cholesky), or 'auto'
        ('refined' for float64 movies on CUDA, else 'cg').
      precise_dots: ('cg') form every per-frame dot of a float32 solve in
        float64 and round it to float32 once (solve.cg.solve_cg); nothing
        changes in float64. 'refined' and 'cholesky' ignore it, as in JAX.
      refine_steps: ('cholesky') refinement steps. The JAX package's
        `batch_size` is not taken: the port factors one frame at a time.
      precond: ('cg', 'refined') 'jacobi', 'two_level' (block-Jacobi plus
        the aggregation coarse correction, solve.coarse), or 'auto':
        two_level from TWO_LEVEL_MIN_VERTICES vertices up, else jacobi.
      coarse_passes: aggregation passes of the coarse space; None deepens
        until it has at most solve.coarse.MAX_COARSE_SIZE aggregates.
      coarse_a1: the coarse matrices' data term, 'full' (per frame) or
        'mean' (averaged over frames: one shared matrix).
      inner_tol: ('refined') tolerance of each f32 inner solve; a sequence
        gives per-outer-step tolerances (the last entry repeats).
      anchor_stride: ('refined') the temporal warm start: with s > 1, every
        s-th frame and the last are refined first and the whole movie
        starts from their interpolant (solve.refine.solve_refined); 1
        starts from zero. A stride below 1 or a non-integer raises
        ValueError, where the JAX package treats it as 1.
      frame_chunk: 'auto' solves movies of more than FRAME_CHUNK_AUTO_MIN
        velocity frames in windows of FRAME_CHUNK_SIZE frames; an int >= 1
        sets the window; None solves the whole movie at once. No window is
        used when `potentials_next` is given. Frames are independent
        systems, so each window converges to the same tolerance.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method: {method!r} (want one of {METHODS})")
    use_two_level = resolve_precond(mesh, precond) == "two_level"
    coarse.check_a1_mode(coarse_a1)
    anchor_stride = check_anchor_stride(anchor_stride)
    if method == "auto":
        method = ("refined" if mesh.device.type == "cuda"
                  and torch.as_tensor(potentials).dtype == torch.float64 else "cg")
    potentials, times = check_movie(mesh, potentials, times, method)
    if potentials_next is not None:
        potentials_next = torch.as_tensor(potentials_next, device=mesh.device).to(
            potentials.dtype)
        if potentials_next.shape != potentials.shape:
            raise ValueError(
                f"potentials_next must match potentials {tuple(potentials.shape)}; "
                f"got {tuple(potentials_next.shape)}")

    t_v = potentials.shape[0] - 1
    if frame_chunk == "auto":
        chunk = FRAME_CHUNK_SIZE if t_v > FRAME_CHUNK_AUTO_MIN else None
    elif frame_chunk is None:
        chunk = None
    else:
        chunk = int(frame_chunk)
        if chunk < 1:
            raise ValueError(f"frame_chunk must be >= 1; got {frame_chunk!r}")
    if chunk is not None and t_v > chunk and potentials_next is None:
        return _chunked_velocity_fields(mesh, potentials, times, chunk, dict(
            lambda_=lambda_, method=method, tol=tol, max_iter=max_iter,
            precise_dots=precise_dots, refine_steps=refine_steps, precond=precond,
            coarse_passes=coarse_passes, coarse_a1=coarse_a1,
            inner_tol=inner_tol, anchor_stride=anchor_stride))

    with profiling.span("solve.window"):
        with profiling.span("solve.setup"):
            tables = None
            if method in ("cg", "refined") and use_two_level:
                tables = coarse.build_tables(mesh, passes=coarse_passes)
            g, f = build_rhs(mesh, potentials, times, potentials_next)
        if method == "refined":
            res = solve_refined(mesh, g, f, lambda_=lambda_, tol=tol,
                                inner_tol=inner_tol, max_iter=max_iter,
                                coarse_tables=tables, coarse_a1=coarse_a1,
                                anchor_stride=anchor_stride)
            return VelocityResult(res.x, mesh.basis, res.iterations, res.residual,
                                  res.converged, res.coarse_zeroed)
        if method == "cg":
            with profiling.span("solve.setup"):
                op = make_operator(mesh, g, lambda_)
                if tables is None:
                    pre, zeroed = block_jacobi_inverse(mesh, g, lambda_), 0
                else:
                    pre = coarse.make_two_level(mesh, g, lambda_, tables,
                                                a1_mode=coarse_a1)
                    with profiling.wait("sync.solve.zeroed"):
                        zeroed = int(pre.zeroed.sum())
            res = solve_cg(op, f, pre, tol=tol, max_iter=max_iter,
                           precise_dots=precise_dots)
            return VelocityResult(res.x, mesh.basis, res.iterations, res.residual,
                                  res.converged, zeroed)
        op = make_operator(mesh, g, lambda_)
        x = solve_cholesky(mesh, op, f, refine_steps=refine_steps)
        r = op.residual(f, x)
        rn = torch.sqrt(kfem.pcg_dot(r, r))
        fn = torch.sqrt(kfem.pcg_dot(f, f))
        target = tol * torch.clamp_min(fn, torch.finfo(f.dtype).tiny)
        return VelocityResult(x, mesh.basis, 0, rn, rn <= target)
