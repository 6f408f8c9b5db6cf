"""Host utilities: reference-format artifact IO (utils.io). Counterpart of
manifold_flow_tpu.utils; profiling is not ported yet."""

from manifold_flow_tpu_torch.utils import io

__all__ = ["io"]
