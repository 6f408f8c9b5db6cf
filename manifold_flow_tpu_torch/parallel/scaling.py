"""Multi-GPU scaling accounting: a bytes model of the halo traffic, and a
measured throughput retention.

Counterpart of manifold_flow_tpu/parallel/scaling.py. The two axes scale
differently:

  * 'frames' (data parallel): frames are independent systems; the only
    collectives gather the results. `measure_scaling` measures weak and
    strong throughput retention over frames ranks.
  * 'mesh' (halo vertex blocks, parallel.halo): one all-gather of block
    boundary values per matvec. Its cost is a bytes question, predictable
    from the partition tables: `halo_comm_stats` and `predicted_efficiency`.

The default rates are the NVIDIA H100 SXM data sheet's: 3.35 TB/s of HBM3
and NVLink 4 at 900 GB/s per GPU in total, 450 GB/s each way. They are
data-sheet figures, not measurements; pass measured rates where there are
any. The model is overlap-free (compute plus communication), a lower bound
on the efficiency.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and NVLink 4 bandwidth per
# GPU in one direction (900 GB/s total).
H100_HBM_GBPS = 3350.0
H100_NVLINK_GBPS = 450.0


@dataclass(frozen=True)
class HaloCommStats:
    """Per-matvec communication and computation of one mesh-axis partition
    (per frame, float32, worst shard)."""

    n_shards: int
    v_owned: int            # owned vertices (max over shards)
    v_halo: int             # halo vertices (max over shards)
    b_send: int             # boundary vertices published (max over shards)
    halo_fraction: float    # b_send / v_owned
    allgather_bytes: float  # bytes of the gathered (S, 2B) buffer
    link_bytes: float       # bytes crossing each GPU's link per matvec
                            # (ring all-gather: (S-1)/S of the buffer)
    compute_bytes: float    # streaming bytes of one local f32 CG iteration


def halo_comm_stats(mesh, n_shards: int, dtype_bytes: int = 4) -> HaloCommStats:
    """Build (or reuse) the halo partition and account one CG iteration, as
    the JAX package does: per frame and iteration the matvec streams
    3*Ml*6 (gathered x, g tables, local products) + 2*Vo*C (the two
    reduction gathers) elements and the vector recurrences 16*(2*Vo)."""
    from manifold_flow_tpu_torch.parallel.halo import build_partition

    part = build_partition(mesh, n_shards)
    vo, vh, b = part.v_owned, part.v_halo, part.b_send
    ml = part.m_local
    c = int(part.base6.shape[2])
    buffer_elems = n_shards * 2 * b
    link_elems = (n_shards - 1) * 2 * b
    compute_elems = 3 * ml * 6 + 2 * vo * c + 16 * (2 * vo)
    return HaloCommStats(
        n_shards=n_shards, v_owned=vo, v_halo=vh, b_send=b,
        halo_fraction=b / max(vo, 1),
        allgather_bytes=float(buffer_elems * dtype_bytes),
        link_bytes=float(link_elems * dtype_bytes),
        compute_bytes=float(compute_elems * dtype_bytes))


def predicted_efficiency(stats: HaloCommStats, hbm_gbps: float = H100_HBM_GBPS,
                         link_gbps: float = H100_NVLINK_GBPS) -> float:
    """Per-GPU efficiency of the mesh-sharded solve, overlap-free:
    t = compute_bytes / HBM + link_bytes / link, efficiency the compute
    share. Latencies are left out: a bandwidth argument, not a
    measurement."""
    t_comp = stats.compute_bytes / (hbm_gbps * 1e9)
    t_comm = stats.link_bytes / (link_gbps * 1e9)
    return t_comp / (t_comp + t_comm)


def _problem(nx: int, n_frames: int, device):
    from manifold_flow_tpu_torch.geometry import synthetic

    mesh = synthetic.plane_patch(
        nx=nx, ny=nx, lx=10.0, ly=10.0,
        height=lambda x, y: 0.3 * np.sin(0.8 * x) * np.cos(0.6 * y),
        dtype=np.float64, device=device)
    pot, times, _ = synthetic.two_source_movie(mesh, n_frames=n_frames, dtype=np.float64)
    return mesh, pot, times


def _scaling_rank(rank: int, world: int, device: str, frames_per_device: int,
                  n_max: int, nx: int, tol: float) -> list:
    """One rank of `measure_scaling` (a spawned process): frames per second of
    the weak and the strong movie on a (world, 1) mesh, best of 2 after a
    warm-up each."""
    import torch

    from manifold_flow_tpu_torch.parallel.partition import (
        make_device_mesh,
        sharded_compute_velocity_fields,
    )

    dev = f"cuda:{rank}" if device == "cuda" else "cpu"
    dm = make_device_mesh(world, 1, device=dev)
    fps = []
    for n_frames in (frames_per_device * world + 1, frames_per_device * n_max + 1):
        mesh, pot, times = _problem(nx, n_frames, dev)

        def run():
            res = sharded_compute_velocity_fields(mesh, pot, times, dm, lambda_=0.01,
                                                  tol=tol, max_iter=2000)
            if res.v_k.is_cuda:
                torch.cuda.synchronize(res.v_k.device)

        run()
        best = np.inf
        for _ in range(2):
            dm.comm("frames").barrier()
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        fps.append((n_frames - 1) / best)
    return fps


def measure_scaling(n_devices=(1, 2, 4, 8), frames_per_device: int = 8, nx: int = 24,
                    tol: float = 1e-5, device: str = "cuda") -> dict:
    """Frame-sharded throughput retention: for each n, n ranks (spawned
    processes) solve the same problem as JAX's on a (n, 1) mesh.

    device='cuda' runs one GPU a rank over NCCL (n may not exceed the GPUs);
    device='cpu' runs gloo CPU ranks. Weak scaling fixes the frames a rank,
    strong scaling the total at frames_per_device * max(n); retention is
    (fps(n) / n) / (fps(n0) / n0) at the smallest n0. On CPU ranks the
    numbers check the mechanism, bounded by the host's cores."""
    import torch

    from manifold_flow_tpu_torch.parallel.multihost import spawn

    if device == "cuda":
        backend = "nccl"
        if max(n_devices) > torch.cuda.device_count():
            raise ValueError(f"measure_scaling(device='cuda') needs {max(n_devices)} GPUs; "
                             f"{torch.cuda.device_count()} are visible")
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
    mesh, _, _ = _problem(nx, 2, "cpu")
    out = {"physical_cores": os.cpu_count(), "n_vertices": mesh.n_vertices,
           "frames_per_device": frames_per_device, "device": device}
    n_max = max(n_devices)
    weak_fps, strong_fps = {}, {}
    for n in sorted(n_devices):
        weak_fps[n], strong_fps[n] = spawn(
            _scaling_rank, n, (device, frames_per_device, n_max, nx, tol),
            backend=backend)[0]
    n0 = min(n_devices)
    base_w, base_s = weak_fps[n0] / n0, strong_fps[n0] / n0
    out["weak_fps"] = {str(n): round(v, 2) for n, v in weak_fps.items()}
    out["strong_fps"] = {str(n): round(v, 2) for n, v in strong_fps.items()}
    out["weak_eff"] = {str(n): round(weak_fps[n] / n / base_w, 3) for n in weak_fps}
    out["strong_eff"] = {str(n): round(strong_fps[n] / n / base_s, 3) for n in strong_fps}
    return out
