"""Multi-device parallelism over a ('frames', 'mesh') grid of ranks.

Counterpart of manifold_flow_tpu/parallel. One process per rank
(torch.distributed, launched by torchrun or spawned), every rank calling the
same functions with the same inputs and getting back the global result:

  * 'frames' axis: pure data parallelism; frames are independent systems.
  * 'mesh' axis: vertices split into owned blocks with a halo exchange
    (parallel.halo); each rank holds its block's rows (~2N / n_mesh + halo)
    and the collective of a matvec is an all-gather of block-boundary
    values. Both the 'cg' and the 'refined' solve take it.

`parallel.comm` is the one collective layer: NCCL for CUDA tensors with one
GPU a rank, gloo for CPU tensors (or ranks that share one GPU, staged
through pinned host buffers). No new kernel: each rank runs K1-K17 on its
block or its frames.
"""

from manifold_flow_tpu_torch.parallel.analysis import (
    sharded_detect,
    sharded_detect_with_counts,
    sharded_wave_velocity,
    sharded_winding_movie,
)
from manifold_flow_tpu_torch.parallel.halo import (
    build_partition,
    halo_compute_velocity_fields,
    halo_refined_velocity_fields,
)
from manifold_flow_tpu_torch.parallel.partition import (
    DeviceMesh,
    make_device_mesh,
    sharded_compute_velocity_fields,
)
from manifold_flow_tpu_torch.parallel.scaling import (
    halo_comm_stats,
    measure_scaling,
    predicted_efficiency,
)

__all__ = [
    "DeviceMesh",
    "build_partition",
    "halo_comm_stats",
    "halo_compute_velocity_fields",
    "halo_refined_velocity_fields",
    "make_device_mesh",
    "measure_scaling",
    "predicted_efficiency",
    "sharded_compute_velocity_fields",
    "sharded_detect",
    "sharded_detect_with_counts",
    "sharded_wave_velocity",
    "sharded_winding_movie",
]
