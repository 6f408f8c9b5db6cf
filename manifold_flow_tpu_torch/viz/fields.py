"""Velocity-field visualization.

Counterpart of manifold_flow_tpu/viz/fields.py: matplotlib equivalents of
the reference's PyVista plots (utils/draw_optical_flow_field.py): static
glyph (arrow) plots of a velocity frame over the surface with the scalar
field as a colormap and singularities as red markers (:75-128), GIF
animation across frames with time-stamped titles (:132-255), and the
true-vs-detected comparison variant (:258-319). Arrow scaling matches the
reference's 'Raw' and 'Scaled' modes (:93-116): 'raw' draws v as-is;
'scaled' normalizes each arrow and scales it by the mesh diagonal. With
PyVista installed, `pyvista_plotter` returns an interactive glyph plot like
the original.

The functions take the port's TriMesh and SVDModes, and tensors on either
device or numpy arrays. Tensors reach the host once a call, through
`utils.io.to_numpy`; the drawing is the JAX package's, line for line, so the
same arrays give the same pixels. matplotlib and PyVista are imported
inside the functions: importing this module needs neither.
`plot_spatial_modes` recombines the modes into world vectors on the modes'
device (K5 on the GPU) before the copy.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from manifold_flow_tpu_torch.utils.io import to_numpy


class HostMesh(NamedTuple):
    """The two mesh arrays a plot draws, on the host."""

    points: np.ndarray      # (N, 3)
    triangles: np.ndarray   # (M, 3)


def _host(*items):
    """numpy versions of `items`: the tensors among them copied in one wait
    (utils.io.to_numpy), None kept, anything else through np.asarray."""
    tensors = [x for x in items if isinstance(x, torch.Tensor)]
    copies = iter(to_numpy(*tensors))
    return [next(copies) if isinstance(x, torch.Tensor)
            else None if x is None else np.asarray(x) for x in items]


def _host_list(items):
    """A list of per-frame arrays or tensors (or None) on the host, the
    tensors in one copy."""
    return None if items is None else _host(*items)


def host_mesh(mesh) -> HostMesh:
    """`mesh`'s points and triangles on the host (a HostMesh as it is)."""
    if isinstance(mesh, HostMesh):
        return mesh
    return HostMesh(*_host(mesh.points, mesh.triangles))


def _axes3d(figsize=(9, 8)):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    return fig, ax


def _arrow_lengths(v, points, mode):
    v = np.asarray(v, dtype=float)
    if mode == "raw":
        return v
    if mode == "scaled":
        diag = np.linalg.norm(points.max(0) - points.min(0))
        norms = np.linalg.norm(v, axis=-1, keepdims=True)
        unit = np.where(norms > 0, v / np.where(norms > 0, norms, 1.0), 0.0)
        return unit * (0.02 * diag)
    raise ValueError(f"arrow scaling must be 'raw' or 'scaled'; got {mode!r}")


def plot_velocity_frame(mesh, v_frame, scalars=None, singularities=None,
                        true_singularities=None, scaling: str = "scaled",
                        stride: int = 1, title: str | None = None,
                        elev: float = 40.0, azim: float = -60.0, ax=None,
                        underlay=None):
    """One frame: surface + velocity arrows (+ singularities).

    Args:
      mesh: TriMesh (or HostMesh).
      v_frame: (N, 3) world-frame velocities.
      scalars: optional (N,) field (potentials/phases) colored on the surface.
      singularities: optional (S, 3) detected singularity coordinates (red).
      true_singularities: optional (S2, 3) ground-truth markers (blue), the
        reference's true-vs-detected overlay (draw_optical_flow_field.py:258-319).
      scaling: 'raw' | 'scaled' arrow mode (:93-116).
      stride: draw every stride-th vertex arrow.
      underlay: optional list of (verts, faces) translucent context meshes,
        the reference's pial-surface underlay (plot_pial_surfaces,
        S4_...ConcatMatrices .py:147-158); load with `load_pial_surfaces`.
    Returns the matplotlib Figure.
    """
    hm = host_mesh(mesh)
    points, tris = hm.points, hm.triangles
    v_frame, scalars, singularities, true_singularities = _host(
        v_frame, scalars, singularities, true_singularities)
    if ax is None:
        fig, ax = _axes3d()
    else:
        fig = ax.figure

    for uverts, ufaces in (underlay or ()):
        uverts = np.asarray(uverts)
        ax.plot_trisurf(uverts[:, 0], uverts[:, 1], uverts[:, 2],
                        triangles=np.asarray(ufaces), color="grey",
                        alpha=0.1, linewidth=0, shade=True)

    surf = ax.plot_trisurf(points[:, 0], points[:, 1], points[:, 2],
                           triangles=tris, cmap="viridis", alpha=0.55,
                           linewidth=0.1, edgecolor="gray")
    if scalars is not None:
        # Face colors = mean of corner values (matplotlib trisurf is per-face).
        surf.set_array(scalars[tris].mean(axis=1))

    arrows = _arrow_lengths(v_frame, points, scaling)[::stride]
    base = points[::stride]
    ax.quiver(base[:, 0], base[:, 1], base[:, 2],
              arrows[:, 0], arrows[:, 1], arrows[:, 2],
              color="black", linewidth=0.6, arrow_length_ratio=0.35)

    for pts, style in ((singularities, dict(color="red", label="detected")),
                       (true_singularities, dict(color="blue", marker="^", label="true"))):
        if pts is not None and len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=60, depthshade=False, **style)
    if (singularities is not None or true_singularities is not None):
        ax.legend(loc="upper right")
    if title:
        ax.set_title(title)
    ax.view_init(elev=elev, azim=azim)
    lo, hi = points.min(0), points.max(0)
    for uverts, _ in (underlay or ()):
        uverts = np.asarray(uverts)
        lo = np.minimum(lo, uverts.min(0))
        hi = np.maximum(hi, uverts.max(0))
    ax.set_box_aspect(hi - lo + 1e-9)
    return fig


def animate_velocity_fields(mesh, v_world, save_path, scalars=None,
                            singularities_per_frame=None,
                            true_singularities_per_frame=None, times=None,
                            scaling: str = "scaled", stride: int = 1,
                            fps: int = 10, dpi: int = 80, underlay=None):
    """GIF across frames (plot_velocity_fields_and_singularity_points_gif,
    draw_optical_flow_field.py:132-255). `times` adds the reference's
    time-stamped titles (:194-255). Passing `true_singularities_per_frame`
    gives the simulated-data true-vs-detected validation animation
    (plot_velocity_fields_and_singularity_points_and_true_singularity_points
    _gif, draw_optical_flow_field.py:258-319): detected points in red, ground
    truth as blue triangles, per frame. Every tensor (the movie, the scalars,
    the per-frame points) is copied to the host once, before the first
    frame is drawn."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    hm = host_mesh(mesh)
    v_world, scalars, times = _host(v_world, scalars, times)
    singularities_per_frame = _host_list(singularities_per_frame)
    true_singularities_per_frame = _host_list(true_singularities_per_frame)
    fig, ax = _axes3d()

    def draw(k):
        ax.clear()
        title = (f"t = {times[k]:.4f} s" if times is not None
                 else f"frame {k}")
        sing = (singularities_per_frame[k]
                if singularities_per_frame is not None else None)
        true = (true_singularities_per_frame[k]
                if true_singularities_per_frame is not None else None)
        sc = scalars[k] if scalars is not None else None
        plot_velocity_frame(hm, v_world[k], scalars=sc, singularities=sing,
                            true_singularities=true,
                            scaling=scaling, stride=stride, title=title,
                            ax=ax, underlay=underlay)

    anim = FuncAnimation(fig, draw, frames=v_world.shape[0], interval=1000 / fps)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    anim.save(str(save_path), writer=PillowWriter(fps=fps), dpi=dpi)
    plt.close(fig)
    return save_path


def mode_world_vectors(mesh, modes, n_modes: int) -> torch.Tensor:
    """sigma_i * VT_i of the first min(n_modes, K) spatial modes as world
    vectors (k, N, 3), on the modes' device (calculate_V_k_from_complex,
    S4_spatiotemporal_decomposition_ComplexMatrices .py:49-69): the
    complex (K, N) rows, or the concatenated-real (K, 2N) ones (taken as
    [Re | Im], ConcatMatrices :194-197), through ops.recombine.
    velocity_to_world (K5 on the GPU)."""
    from manifold_flow_tpu_torch.ops.recombine import velocity_to_world

    basis = mesh.basis
    vt = torch.as_tensor(modes.vt, device=basis.device)
    sigma = torch.as_tensor(modes.sigma, device=vt.device)
    k = min(n_modes, vt.shape[0])
    rows = vt[:k]
    if rows.is_complex():
        rows = torch.cat([rows.real, rows.imag], dim=-1)
    rows = sigma[:k, None].to(rows.dtype) * rows
    return velocity_to_world(rows.contiguous(), basis)


def plot_spatial_modes(mesh, modes, n_modes: int = 4, scaling: str = "scaled",
                       stride: int = 1, underlay=None, save_path_fmt=None,
                       elev: float = 40.0, azim: float = -60.0):
    """Render the leading spatial SVD modes as glyph plots (extract_modes +
    calculate_V_k_from_complex, S4_spatiotemporal_decomposition_
    ComplexMatrices .py:49-69,145-162): mode i draws sigma_i * VT_i
    recombined into world vectors over the surface, titled with its energy
    percentage.

    Takes modes from either decomposition (ops.svd): complex (K, N) spatial
    rows or the concatenated-real (K, 2N) form. The world vectors are formed
    on the modes' device (`mode_world_vectors`) and copied to the host with
    sigma and the mesh in one wait. `underlay` threads through to the
    pial-surface context plot. Returns the list of figures; `save_path_fmt`
    (with a `{mode}` field) also writes one PNG per mode.
    """
    world = mode_world_vectors(mesh, modes, n_modes)
    world, sigma, points, tris = _host(world, modes.sigma, mesh.points, mesh.triangles)
    hm = HostMesh(points, tris)
    energy = 100.0 * sigma**2 / np.sum(sigma ** 2)
    figs = []
    for i in range(world.shape[0]):
        fig = plot_velocity_frame(
            hm, world[i], scaling=scaling, stride=stride,
            title=f"mode {i + 1} ({energy[i]:.1f}%)",
            elev=elev, azim=azim, underlay=underlay)
        if save_path_fmt is not None:
            path = Path(str(save_path_fmt).format(mode=i + 1))
            path.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(path, dpi=120)
        figs.append(fig)
    return figs


def load_pial_surfaces(*paths):
    """Load FreeSurfer pial surfaces for the translucent context underlay
    (plot_pial_surfaces, S4_...ConcatMatrices .py:147-158, which uses
    mne.read_surface). Uses MNE when available, else the FreeSurfer-binary
    reader utils.io.read_freesurfer_surface. Returns a list of (verts,
    faces) numpy pairs for `underlay=`."""
    out = []
    for p in paths:
        try:
            import mne

            verts, faces = mne.read_surface(str(p))
        except ImportError:
            from manifold_flow_tpu_torch.utils.io import read_freesurfer_surface

            verts, faces = read_freesurfer_surface(p)
        out.append((np.asarray(verts), np.asarray(faces)))
    return out


def plot_temporal_modes(times, vt, sigma, n_modes: int = 4, save_path=None):
    """Temporal SVD modes sigma_i * VT_i(t) with energy percentages
    (S4_...ConcatMatrices .py:91-145)."""
    import matplotlib.pyplot as plt

    times, vt, sigma = _host(times, vt, sigma)
    energy = 100.0 * sigma**2 / np.sum(sigma**2)
    fig, axes = plt.subplots(n_modes, 1, figsize=(8, 2.2 * n_modes),
                             sharex=True)
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes[:n_modes]):
        ax.plot(times[: vt.shape[1]], sigma[i] * vt[i])
        ax.set_ylabel(f"mode {i + 1}\n{energy[i]:.1f}%")
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("time (s)")
    fig.tight_layout()
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=120)
    return fig


def plot_streamlines(mesh, streamlines, save_path=None, elev=40.0, azim=-60.0):
    """Render S6 streamline polylines over the surface."""
    points, tris, *lines = _host(mesh.points, mesh.triangles, *streamlines)
    fig, ax = _axes3d()
    ax.plot_trisurf(points[:, 0], points[:, 1], points[:, 2],
                    triangles=tris, color="lightgray",
                    alpha=0.35, linewidth=0)
    for line in lines:
        ax.plot(line[:, 0], line[:, 1], line[:, 2], linewidth=1.2)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect(points.max(0) - points.min(0) + 1e-9)
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=120)
    return fig


def pyvista_plotter(mesh, v_frame, scalars=None, singularities=None,
                    factor: float = 1.0):
    """Interactive PyVista glyph plot like the reference's
    (draw_optical_flow_field.py:75-128). Requires pyvista."""
    try:
        import pyvista as pv
    except ImportError as e:
        raise ImportError("pyvista_plotter requires PyVista; use "
                          "plot_velocity_frame for the matplotlib path") from e
    points, tris, v_frame, scalars, singularities = _host(
        mesh.points, mesh.triangles, v_frame, scalars, singularities)
    faces = np.concatenate(
        [np.full((len(tris), 1), 3, dtype=np.int64), tris], axis=1).ravel()
    surf = pv.PolyData(points, faces)
    if scalars is not None:
        surf["field"] = scalars
    surf["vectors"] = v_frame
    plotter = pv.Plotter()
    plotter.add_mesh(surf, scalars="field" if scalars is not None else None,
                     opacity=0.8)
    plotter.add_mesh(surf.glyph(orient="vectors", scale="vectors",
                                factor=factor), color="black")
    if singularities is not None and len(singularities):
        plotter.add_points(singularities, color="red", point_size=12)
    return plotter
