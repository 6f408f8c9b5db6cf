"""Velocity DOF recombination: (T, 2N) -> world vectors / complex form.

Counterpart of manifold_flow_tpu/ops/recombine.py. `velocity_to_world` and
the speed map are one call of the K5 kernel (`kernels.analysis`) on CUDA
tensors, which also gives the per-frame maximum speed that detection
normalises by; `velocity_to_world_and_speed` returns all three.
`world_speed` of world vectors has no kernel and runs on CPU tensors only.
"""

from __future__ import annotations

import torch

from manifold_flow_tpu_torch.kernels import analysis as kan


def split_components(v_k: torch.Tensor) -> torch.Tensor:
    """(..., 2N) DOFs -> (..., N, 2) per-vertex tangent coefficients."""
    n = v_k.shape[-1] // 2
    return torch.stack([v_k[..., :n], v_k[..., n:]], dim=-1)


def velocity_to_world_and_speed(v_k: torch.Tensor, e: torch.Tensor):
    """(T, 2N) DOFs + bases e (N, 2, 3) -> (v_world (T, N, 3), speed (T, N),
    v_max (T,)), in the promoted dtype of the two."""
    dtype = torch.promote_types(v_k.dtype, e.dtype)
    return kan.recombine_speed(v_k.to(dtype).contiguous(),
                               e.to(dtype).contiguous())


def velocity_to_world(v_k: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(..., 2N) DOFs + bases e (N, 2, 3) -> world vectors (..., N, 3)."""
    lead, n_dof = v_k.shape[:-1], v_k.shape[-1]
    v_world, _, _ = velocity_to_world_and_speed(v_k.reshape(-1, n_dof), e)
    return v_world.reshape(*lead, n_dof // 2, 3)


def velocity_to_complex(v_k: torch.Tensor) -> torch.Tensor:
    """(..., 2N) DOFs -> complex (..., N) = V1 + i V2 (S4 complex form)."""
    n = v_k.shape[-1] // 2
    return torch.complex(v_k[..., :n], v_k[..., n:])


SPEED_NEEDS_K5 = (
    "no kernel forms the speed map from world vectors alone: on CUDA tensors "
    "take speed and v_max from velocity_to_world_and_speed (kernel K5), which "
    "forms them together with the world vectors")


def world_speed(v_world: torch.Tensor) -> torch.Tensor:
    """Per-vertex speed magnitude: the optical-flow wave-speed map (C12,
    S3_compute_v_and_detection_singularity.py:127-137).

    CPU tensors only; on CUDA the map comes from `velocity_to_world_and_speed`
    (K5), so this raises there.
    """
    if v_world.device.type != "cpu":
        raise ValueError(SPEED_NEEDS_K5)
    return kan.plain_speed(v_world)
