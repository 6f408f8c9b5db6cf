"""The port's one collective layer: all-gather, all-reduce and a barrier over
one axis of a device mesh.

The JAX package runs one controller over a ('frames', 'mesh') device mesh and
names an axis in `jax.lax.all_gather` / `psum`. The port runs one process per
rank (SPMD, `torch.distributed`), and an `AxisComm` holds the process group of
one axis as this rank sees it.

The group's backend decides the transport, and the caller chooses that
backend when the process group is made:

  * NCCL: CUDA tensors, one GPU a rank. A CPU tensor raises.
  * gloo: CPU tensors directly. CUDA tensors (ranks that share one GPU, as
    on a one-card machine) are staged through pinned host buffers, explicitly:
    the device-to-host and host-to-device bytes are counted in
    `STAGED_BYTES`.

No transport changes in silence. Only `all_gather` into a list of tensors and
`all_reduce` are used: both exist in every torch build (the tensor forms of
all-gather are deprecated in some).

An axis of size 1 with no process group (a single process) runs no
collective: `all_gather` returns the tensor with a leading axis of 1 and
`all_reduce_` leaves it as it is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# Bytes copied between the device and pinned host buffers for gloo
# collectives on CUDA tensors, since the last `reset_staged()`.
STAGED_BYTES = {"to_host": 0, "to_device": 0}

_OPS = {"sum": "SUM", "max": "MAX"}


def reset_staged() -> None:
    STAGED_BYTES["to_host"] = 0
    STAGED_BYTES["to_device"] = 0


class AxisComm:
    """Collectives over one axis of a device mesh.

      group    the axis's process group (None: no collective; size 1 only)
      size     ranks on the axis
      rank     this rank's index on the axis
      backend  "nccl" or "gloo" (None without a group)
    """

    def __init__(self, group=None, size: int = 1, rank: int = 0):
        if group is None and size != 1:
            raise ValueError(f"an axis of {size} ranks needs a process group")
        self.group = group
        self.size = int(size)
        self.rank = int(rank)
        self.backend = None if group is None else str(dist.get_backend(group))
        self._pinned: dict = {}

    def __repr__(self) -> str:
        return f"AxisComm(size={self.size}, rank={self.rank}, backend={self.backend})"

    # ---------------------------------------------------------------- transport
    def _staged(self, x: torch.Tensor) -> bool:
        """Whether x goes through host buffers (gloo and a CUDA tensor); an
        NCCL group given a CPU tensor raises."""
        if self.backend == "nccl":
            if not x.is_cuda:
                raise ValueError("an NCCL group takes CUDA tensors; got a tensor on "
                                 f"{x.device} (use a gloo group for CPU tensors)")
            return False
        return x.is_cuda

    def _host(self, key: str, shape, dtype) -> torch.Tensor:
        """A pinned host buffer, kept per (key, shape, dtype) for the repeated
        collectives of a solve."""
        k = (key, tuple(shape), dtype)
        buf = self._pinned.get(k)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[k] = buf
        return buf

    def _to_host(self, x: torch.Tensor, key: str) -> torch.Tensor:
        buf = self._host(key, x.shape, x.dtype)
        buf.copy_(x)
        STAGED_BYTES["to_host"] += x.numel() * x.element_size()
        return buf

    @staticmethod
    def _to_device(buf: torch.Tensor, out: torch.Tensor) -> None:
        out.copy_(buf)
        STAGED_BYTES["to_device"] += buf.numel() * buf.element_size()

    # ---------------------------------------------------------------- collectives
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's x, in axis order, on x's device."""
        x = x.contiguous()
        if self.group is None:
            return x[None].clone()
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        staged = self._staged(wire)
        src = self._to_host(wire, "gather_in") if staged else wire
        out = (self._host("gather_out", (self.size, *wire.shape), wire.dtype) if staged
               else torch.empty((self.size, *wire.shape), dtype=wire.dtype,
                                device=wire.device))
        dist.all_gather(list(out.unbind(0)), src, group=self.group)
        if staged:
            dev = torch.empty(out.shape, dtype=out.dtype, device=x.device)
            self._to_device(out, dev)
            out = dev
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def all_reduce_(self, *xs: torch.Tensor, op: str = "sum") -> None:
        """Reduce each tensor over the axis in place (op 'sum' or 'max').
        Tensors of one dtype and device travel as one buffer."""
        if self.group is None or not xs:
            return
        if len({(x.dtype, x.device) for x in xs}) != 1:
            for x in xs:
                self.all_reduce_(x, op=op)
            return
        flat = torch.cat([x.reshape(-1) for x in xs]) if len(xs) > 1 else xs[0].reshape(-1)
        staged = self._staged(flat)
        buf = self._to_host(flat, "reduce") if staged else flat.contiguous()
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, _OPS[op]), group=self.group)
        if staged:
            dev = torch.empty(flat.shape, dtype=flat.dtype, device=flat.device)
            self._to_device(buf, dev)
            buf = dev
        if len(xs) == 1 and buf.data_ptr() == xs[0].data_ptr():
            return
        pos = 0
        for x in xs:
            x.copy_(buf[pos: pos + x.numel()].view(x.shape))
            pos += x.numel()

    def _reduce_int(self, value: int, op: str) -> int:
        t = torch.tensor([int(value)], dtype=torch.int64)
        if self.backend == "nccl":
            t = t.cuda()
        self.all_reduce_(t, op=op)
        return int(t.item())

    def max_int(self, value: int) -> int:
        """The largest of the ranks' Python ints (on the host)."""
        return self._reduce_int(value, "max")

    def sum_int(self, value: int) -> int:
        """The sum of the ranks' Python ints (on the host)."""
        return self._reduce_int(value, "sum")

    def barrier(self) -> None:
        """Wait until every rank of the axis arrives (a one-int all-reduce,
        which takes the group's own transport)."""
        self.sum_int(0)
