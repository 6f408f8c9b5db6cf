"""Visualization: matplotlib field, streamline and mode plots, GIF
animation, and an optional interactive PyVista plot (viz.fields).
Counterpart of manifold_flow_tpu.viz; importing it needs neither matplotlib
nor PyVista, which the functions import when they draw."""

from manifold_flow_tpu_torch.viz.fields import (
    animate_velocity_fields,
    load_pial_surfaces,
    plot_spatial_modes,
    plot_streamlines,
    plot_temporal_modes,
    plot_velocity_frame,
    pyvista_plotter,
)

__all__ = ["animate_velocity_fields", "load_pial_surfaces",
           "plot_spatial_modes", "plot_streamlines",
           "plot_temporal_modes", "plot_velocity_frame", "pyvista_plotter"]
