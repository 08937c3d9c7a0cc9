"""The parallel learners' collectives over a ``torch.distributed`` group.

The JAX learners run inside ``shard_map`` and reduce with ``lax.psum``,
``lax.psum_scatter``, ``lax.all_gather`` (lightgbmv1_tpu/parallel/
trainer.py :151-175, :771-1200) and gather host values with
``multihost_utils.process_allgather`` (parallel/dist_data.py :43-112).
Here every rank is a process of one ``torch.distributed`` group and a
:class:`Group` offers the same four operations:

* ``all_reduce(t)``: the sum over the ranks, on every rank (``psum``);
* ``reduce_scatter(t, dim)``: the sum, each rank keeping its 1/D slice
  of ``dim`` (``psum_scatter(..., tiled=True)``), rank r slice r;
* ``all_gather(t)``: the ranks' tensors stacked in rank order on a new
  leading axis (``all_gather``);
* ``all_gather_object(obj)``: the ranks' picklable objects in rank
  order (``process_allgather`` of host values).

A group of one rank is the identity: each operation returns its input
(``all_gather`` with a leading axis of 1) and moves nothing.

The backend is chosen once, when the group is made (``backend_for``):
``nccl`` where every rank trains on a card of its own (``rank %
device_count`` distinct over the ranks), ``gloo`` otherwise: on the CPU,
and for ranks that share a card, where NCCL refuses a duplicate device.
The ``torch.distributed`` backend table lists gloo's CUDA support as
``broadcast`` and ``all_reduce`` only, but torch 2.11 (CUDA 12.8) runs
``all_gather`` and ``reduce_scatter`` on CUDA tensors under gloo too
(``chip_smoke.py`` phase 56 gates that every call's tensor stayed on the
card), and the data learner with those two staged through pinned host
memory was slower an iteration on an H100 (PERF.md §6); so every
collective hands gloo its CUDA tensors and none is staged.

Each operation adds its payload to ``counts[op]``: calls, bytes and the
calls made on CUDA tensors, and with ``part=`` to ``part_bytes[part]``.
The bytes are
the output payload a collective materializes on each rank, the
convention of the analytic tables (``obs/metrics.comm_table_per_round``,
JAX cluster.py :247-262): an all-reduce of n elements n, a
reduce-scatter n / D, an all-gather n D (times the element size).
``call_log``, when a list, receives ``(op, part, shape, bytes)`` for
every call, so a run can hold each round's payload to the table.
"""

from __future__ import annotations

import pickle
import threading
from typing import Dict, List, Optional

import torch

OPS = ("all_reduce", "reduce_scatter", "all_gather", "all_gather_object")

counts: Dict[str, Dict[str, int]] = {
    op: {"calls": 0, "bytes": 0, "cuda": 0} for op in OPS}
part_bytes: Dict[str, int] = {}
# None, or a list receiving (op, part, shape, bytes) for every call
call_log: Optional[List[tuple]] = None
_lock = threading.Lock()


def reset_counts() -> None:
    with _lock:
        for c in counts.values():
            for k in c:
                c[k] = 0
        part_bytes.clear()
        if call_log is not None:
            call_log.clear()


def backend_for(world: int, device_count: int, on_cuda: bool) -> str:
    """The group's backend: ``nccl`` where each of the ``world`` ranks
    trains on a card of its own (rank r on card ``r % device_count``, the
    cards distinct), else ``gloo``."""
    if on_cuda and device_count > 0 and \
            len({r % device_count for r in range(world)}) == world:
        return "nccl"
    return "gloo"


def _note(op: str, part: Optional[str], shape, nbytes: int,
          cuda: bool) -> None:
    with _lock:
        c = counts[op]
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        c["cuda"] += int(cuda)
        if part is not None:
            part_bytes[part] = part_bytes.get(part, 0) + int(nbytes)
        if call_log is not None:
            call_log.append((op, part, tuple(shape), int(nbytes)))


class Group:
    """The ranks of the default ``torch.distributed`` process group, or of
    none (``solo()``: one rank)."""

    def __init__(self, *, solo: bool = False):
        import torch.distributed as dist

        if solo:
            self.rank, self.world, self.backend = 0, 1, None
        else:
            self.rank = dist.get_rank()
            self.world = dist.get_world_size()
            self.backend = str(dist.get_backend())

    @classmethod
    def solo(cls) -> "Group":
        return cls(solo=True)

    def all_reduce(self, t: torch.Tensor, part: Optional[str] = None
                   ) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor on every rank)."""
        if self.world == 1:
            return t
        import torch.distributed as dist

        out = t.contiguous().clone()
        dist.all_reduce(out)
        _note("all_reduce", part, t.shape, out.numel() * out.element_size(),
              out.is_cuda)
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0,
                       part: Optional[str] = None) -> torch.Tensor:
        """The sum of ``t`` over the ranks, this rank keeping slice
        ``rank`` of ``dim`` cut in ``world`` equal parts (``t.shape[dim]``
        a multiple of the world)."""
        if self.world == 1:
            return t
        import torch.distributed as dist

        n = t.shape[dim]
        if n % self.world:
            raise ValueError(f"reduce_scatter: dim {dim} of {n} does not "
                             f"split over {self.world} ranks")
        x = t.movedim(dim, 0).contiguous()
        chunks = list(x.chunk(self.world))
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks)
        _note("reduce_scatter", part, t.shape,
              out.numel() * out.element_size(), out.is_cuda)
        return out.movedim(0, dim)

    def all_gather(self, t: torch.Tensor, part: Optional[str] = None
                   ) -> torch.Tensor:
        """(world, *t.shape): every rank's ``t`` in rank order."""
        if self.world == 1:
            return t[None]
        import torch.distributed as dist

        x = t.contiguous()
        outs = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(outs, x)
        out = torch.stack(outs)
        _note("all_gather", part, t.shape, out.numel() * out.element_size(),
              out.is_cuda)
        return out

    def all_gather_object(self, obj, part: Optional[str] = None) -> list:
        """Every rank's ``obj`` in rank order (pickled; the bytes counted
        are the pickles' received)."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        outs = [None] * self.world
        dist.all_gather_object(outs, obj)
        nbytes = sum(len(pickle.dumps(o)) for o in outs)
        _note("all_gather_object", part, (), nbytes, False)
        return outs

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()


def current_group() -> Group:
    """The default ``torch.distributed`` group when one is initialized
    (``cluster.init_cluster`` or the caller's ``init_process_group``),
    else a group of one rank."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return Group()
    return Group.solo()
