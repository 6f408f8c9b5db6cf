"""The ('frames', 'mesh') device mesh and the distributed velocity solve.

Counterpart of manifold_flow_tpu/parallel/partition.py. The JAX package runs
one controller over a `jax.sharding.Mesh` and `shard_map`s the solve over
it. The port runs one process per rank (SPMD): every rank calls the same
function with the same full inputs, runs its own part, and gets back the
global result, gathered over the axis groups.

  * 'frames' (data parallel): frames are independent systems. Each frames
    rank runs the single-device solve on its slice of the frame axis, with
    no collective until the results are gathered, each slice padded with
    zero rows to ceil(T / nf) (JAX pads the movie with zero frames instead;
    the halo solve does so too).
  * 'mesh' (halo vertex blocks, parallel.halo): the DOF space splits into
    owned vertex blocks; one boundary all-gather per matvec and all-reduced
    dots.

Ranks are laid out frames-major, rank = frame_index * n_mesh + mesh_index,
as JAX reshapes its device list.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from manifold_flow_tpu_torch.geometry.mesh import TriMesh
from manifold_flow_tpu_torch.parallel.comm import AxisComm
from manifold_flow_tpu_torch.parallel.multihost import TORCHRUN_HINT
from manifold_flow_tpu_torch.solve.api import (
    VelocityResult,
    check_movie,
    compute_velocity_fields,
    resolve_precond,
)
from manifold_flow_tpu_torch.solve.refine import DEFAULT_INNER_TOL

AXES = ("frames", "mesh")


class DeviceMesh:
    """This rank's view of a ('frames', 'mesh') grid of ranks.

      shape        {"frames": nf, "mesh": nm}
      coordinate   (frame index, mesh index) of this rank
      device       the torch device of this rank's work
      comm(axis)   the AxisComm over the ranks that share the other index

    torch.distributed's `init_device_mesh` builds its groups with one
    backend per device type: it cannot give gloo groups to ranks whose
    tensors live on CUDA (ranks that share one GPU), so the two axis groups
    are made here with `new_group`, in the default group's backend.
    """

    def __init__(self, shape: dict, coordinate: tuple, device: torch.device,
                 comms: dict):
        self.shape = dict(shape)
        self.coordinate = tuple(coordinate)
        self.device = device
        self._comms = comms

    def comm(self, axis: str) -> AxisComm:
        return self._comms[axis]

    def __repr__(self) -> str:
        return (f"DeviceMesh(frames={self.shape['frames']}, mesh={self.shape['mesh']}, "
                f"coordinate={self.coordinate}, device={self.device})")


def _rank_device(device) -> torch.device:
    """`device`, with a CUDA device without an index resolved to this
    process's GPU (LOCAL_RANK modulo the visible GPUs, as torchrun lays
    ranks out) and made current."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(device)
    return device


def make_device_mesh(n_frame_shards: int | None = None, n_mesh_shards: int = 1,
                     device="cuda") -> DeviceMesh:
    """Device mesh with axes ('frames', 'mesh') over the process group.

    Defaults to every rank on the frame axis (the zero-communication
    direction). Every rank must call it, in the same order as its other
    group-making calls. nf * nm must be the group's size: a rank outside
    the grid would have nothing to run the collectives with. Without a
    process group only a 1 x 1 mesh exists (no collective runs); anything
    larger raises ValueError naming torchrun.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    nm = int(n_mesh_shards)
    nf = world // nm if n_frame_shards is None else int(n_frame_shards)
    if nf < 1 or nm < 1:
        raise ValueError(f"shard counts must be >= 1; got frames={nf}, mesh={nm}")
    if nf * nm != world:
        none = "" if dist.is_initialized() else f" (none is set up): {TORCHRUN_HINT}"
        raise ValueError(f"a ({nf}, {nm}) device mesh needs {nf * nm} ranks; the "
                         f"process group has {world}{none}")
    if not dist.is_initialized():
        comms = {axis: AxisComm() for axis in AXES}
        return DeviceMesh({"frames": 1, "mesh": 1}, (0, 0), _rank_device(device), comms)
    rank = dist.get_rank()
    fi, mi = divmod(rank, nm)
    mesh_group = frames_group = None
    for f in range(nf):  # every rank makes every group, in one order
        g = dist.new_group([f * nm + m for m in range(nm)])
        if f == fi:
            mesh_group = g
    for m in range(nm):
        g = dist.new_group([f * nm + m for f in range(nf)])
        if m == mi:
            frames_group = g
    comms = {"mesh": AxisComm(mesh_group, nm, mi),
             "frames": AxisComm(frames_group, nf, fi)}
    return DeviceMesh({"frames": nf, "mesh": nm}, (fi, mi), _rank_device(device), comms)


def frame_block(t: int, nf: int, index: int) -> tuple[int, int, int]:
    """(lo, hi, tl): frames rank `index` holds frames [lo, hi) of the t, in
    a block of tl = ceil(t / nf) rows padded with zero frames."""
    tl = -(-t // nf)
    lo = min(index * tl, t)
    return lo, min(lo + tl, t), tl


def pad_frames(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x with zero rows appended along axis 0 up to `rows`."""
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def gather_frames(comm: AxisComm, x: torch.Tensor, t: int) -> torch.Tensor:
    """Every frames rank's (tl, ...) block, concatenated in rank order and
    cut to the t real frames."""
    out = comm.all_gather(x)
    return out.reshape(-1, *x.shape[1:])[:t]


def sharded_compute_velocity_fields(
    mesh: TriMesh,
    potentials,
    times,
    device_mesh: DeviceMesh,
    lambda_: float = 0.01,
    tol: float = 1e-10,
    max_iter: int = 2000,
    method: str = "cg",
    precond: str = "auto",
    inner_tol=DEFAULT_INNER_TOL,
) -> VelocityResult:
    """Distributed counterpart of solve.api.compute_velocity_fields.

    With a mesh axis above 1 both methods go to the halo vertex-block
    partition (parallel.halo). Otherwise each frames rank calls
    solve.api.compute_velocity_fields on its slice of frames ('cg' on K1-K4,
    K8-K11 under two-level, or 'refined': f32 inner PCG, native f64
    residual on K1 `<double>`), windowing a long slice as that function
    does, and the slices are gathered, padded to ceil(T / nf) rows. Every
    rank returns the whole result; `iterations` is the largest over the
    ranks.
    """
    resolve_precond(mesh, precond)
    if method not in ("cg", "refined"):
        raise ValueError(f"unknown sharded method {method!r} (want 'cg' or 'refined')")
    if device_mesh.shape["mesh"] > 1:
        from manifold_flow_tpu_torch.parallel import halo

        if method == "cg":
            return halo.halo_compute_velocity_fields(
                mesh, potentials, times, device_mesh, lambda_=lambda_, tol=tol,
                max_iter=max_iter, precond=precond)
        return halo.halo_refined_velocity_fields(
            mesh, potentials, times, device_mesh, lambda_=lambda_, tol=tol,
            max_iter=max_iter, precond=precond, inner_tol=inner_tol)
    # Every rank checks the movie, so that bad inputs raise on every rank
    # (a rank with no frames would otherwise wait in the gather).
    potentials, times = check_movie(mesh, potentials, times, method)
    comm = device_mesh.comm("frames")
    t = potentials.shape[0] - 1
    lo, hi, tl = frame_block(t, device_mesh.shape["frames"], device_mesh.coordinate[0])
    if hi > lo:
        res = compute_velocity_fields(
            mesh, potentials[lo: hi + 1], times[lo: hi + 1], lambda_=lambda_,
            method=method, tol=tol, max_iter=max_iter, precond=precond,
            inner_tol=inner_tol)
    else:  # a rank past the movie's end: no frames, no iteration
        res = VelocityResult(potentials.new_zeros((0, mesh.n_dof)), mesh.basis, 0,
                             potentials.new_zeros((0,)),
                             torch.zeros(0, dtype=torch.bool, device=mesh.device))
    return VelocityResult(
        v_k=gather_frames(comm, pad_frames(res.v_k, tl), t), e=mesh.basis,
        iterations=comm.max_int(res.iterations),
        residual=gather_frames(comm, pad_frames(res.residual, tl), t),
        converged=gather_frames(comm, pad_frames(res.converged, tl), t),
        coarse_zeroed=comm.sum_int(res.coarse_zeroed))
