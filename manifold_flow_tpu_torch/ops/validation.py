"""Simulated-data validation: match detected against true singularities by
geodesic distance, on the host.

Counterpart of manifold_flow_tpu/ops/validation.py, a faithful
reimplementation of compute_displacement_difference /
compute_err_for_all_Vk (utils/find_singularity_point.py:607-720) with the
reference's reporting quirks, so scores compare with the original.
Geodesics are the edge-graph Dijkstra distances of
`geometry.topology.geodesic_distance_matrix` in place of VTK's
`geodesic_distance`.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple, Sequence

import numpy as np

from manifold_flow_tpu_torch.geometry import topology
from manifold_flow_tpu_torch.geometry.mesh import TriMesh


class MatchStats(NamedTuple):
    err: float
    err_list: list
    matched: int
    spare: int
    missed: int


def frame_displacement_difference(mesh: TriMesh, threshold: float,
                                  detected: np.ndarray, truth: np.ndarray,
                                  frame: int, turning_point: int) -> MatchStats:
    """Score one frame (compute_displacement_difference, :607-672).

    Quirks kept from the reference: `matched = count(True) + 1` (:665),
    `spare = max(n_detected - matched - 1, 0)` (:666-667), and frames at or
    beyond `turning_point` score missed=2 / matched=1 (:668-671).
    """
    n_detected = len(detected)
    n_true = len(truth)
    if n_detected == 0:
        return MatchStats(0.0, [], 0, 0, n_true)
    if frame >= turning_point:
        return MatchStats(0.0, [], 1, 0, 2)

    pts = mesh.points.cpu().numpy()

    def nearest_vertex(p):
        return int(np.argmin(np.linalg.norm(pts - p, axis=-1)))

    true_v = [nearest_vertex(p) for p in np.asarray(truth)]
    det_v = [nearest_vertex(p) for p in np.asarray(detected)]
    dist = topology.geodesic_distance_matrix(mesh, np.asarray(true_v))
    flags = [False] * n_detected

    err = 0.0
    err_list: list[float] = []
    missed = 0
    for r in range(len(true_v)):
        d = [dist[r, dv] for dv in det_v]
        min_diff = min(d)
        min_idx = d.index(min_diff)
        if min_diff <= threshold and flags[min_idx] is False:
            err_list.append(min_diff)
            err += min_diff
            flags[min_idx] = True
        else:
            missed += 1
    matched = flags.count(True) + 1
    spare = max(n_detected - matched - 1, 0)
    return MatchStats(err, err_list, matched, spare, missed)


class ValidationReport(NamedTuple):
    err: float
    err_max: float
    err_min: float
    err_stdev: float
    spare: int
    missed: int
    matched: int


def score_all_frames(mesh: TriMesh, detected_per_frame: Sequence[np.ndarray],
                     truth_per_frame: Sequence[np.ndarray], threshold: float,
                     turning_point: int) -> ValidationReport:
    """Aggregate scoring (compute_err_for_all_Vk, :675-720)."""
    err = 0.0
    err_list: list[float] = []
    matched = spare = missed = 0
    for i, (det, tru) in enumerate(zip(detected_per_frame, truth_per_frame)):
        s = frame_displacement_difference(mesh, threshold, det, tru, i,
                                          turning_point)
        err += s.err
        err_list.extend(s.err_list)
        matched += s.matched
        spare += s.spare
        missed += s.missed
    return ValidationReport(
        err=err,
        err_max=max(err_list) if err_list else 0.0,
        err_min=min(err_list) if err_list else 0.0,
        err_stdev=statistics.stdev(err_list) if len(err_list) > 1 else 0.0,
        spare=spare,
        missed=missed,
        matched=matched,
    )
