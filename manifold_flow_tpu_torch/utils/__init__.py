"""Host utilities: reference-format artifact IO (utils.io), the geometry
cache (utils.cache) and tracing, timing and metrics (utils.profiling).
Counterpart of manifold_flow_tpu.utils."""

from manifold_flow_tpu_torch.utils import cache, io, profiling

__all__ = ["cache", "io", "profiling"]
