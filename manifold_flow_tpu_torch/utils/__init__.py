"""Host utilities: reference-format artifact IO (utils.io) and the
geometry cache (utils.cache). Counterpart of manifold_flow_tpu.utils;
profiling is ROADMAP Queue A2."""

from manifold_flow_tpu_torch.utils import cache, io

__all__ = ["cache", "io"]
