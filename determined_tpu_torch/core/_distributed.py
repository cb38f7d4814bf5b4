"""DistributedContext: the gang's control plane, python objects only.

Port of ``determined_tpu/core/_distributed.py``: ``rank``, ``size``,
``is_chief`` and the object collectives ``gather`` (the chief receives the
ranks' objects in rank order), ``broadcast`` (the chief's object on every
rank), ``allgather`` and ``barrier``, each on a ``channel``. Tensor
collectives belong to the step (the Trainer's groups of the device mesh),
never here.

The reference moves its objects over a ZMQ star that the chief's address
and port (``chief_ip``, ``chief_port``) set up; the card's machine has no
pyzmq, so the port's transport is ``torch.distributed``'s object
collectives on gloo groups of its own, one group per channel, made from
the gang's default group once it is joined (``core.init()`` joins it:
NCCL on the card, gloo on the CPU) and apart from the device mesh's
compute groups. A
channel isolates concurrent streams: the async checkpoint writer runs its
collectives on ``"checkpoint"`` while the step loop uses ``"main"``; calls
on one channel stay single-threaded per process and in the same order on
every rank. Every collective times out after the group's timeout; a
failure raises, and ``close()`` destroys the groups (and the default
group when the context owns it), so a failing rank does not leave its
peers waiting.

``DummyDistributedContext`` is the gang of one: the collectives return at
once.
"""
from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

CHANNEL_MAIN = "main"
#: the async checkpoint writer's channel (core/_checkpoint.py).
CHANNEL_CHECKPOINT = "checkpoint"
CHANNELS = (CHANNEL_MAIN, CHANNEL_CHECKPOINT)

#: how long a collective of the gang may wait (seconds) before it raises.
DEFAULT_TIMEOUT_S = 600.0


class DistributedContext:
    def __init__(self, *, rank: int, size: int,
                 own_default_group: bool = False) -> None:
        """Rank `rank` of a gang of `size` processes that
        ``torch.distributed`` has joined; `own_default_group`: ``close()``
        leaves the default group too (``core.init()`` hands it over)."""
        self.rank = rank
        self.size = size
        self._closed = False
        self._owns_default = own_default_group
        self._groups: Dict[str, Any] = {}
        if size <= 1:
            return
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                f"rank {rank} of a gang of {size}: join torch.distributed "
                "first (core.init() does, from the rendezvous table)"
            )
        if (dist.get_rank(), dist.get_world_size()) != (rank, size):
            raise ValueError(
                f"rank {rank} of {size} does not match torch.distributed's "
                f"rank {dist.get_rank()} of {dist.get_world_size()}"
            )
        try:
            for channel in CHANNELS:
                self._groups[channel] = dist.new_group(
                    backend="gloo",
                    timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        except BaseException:
            self.close()
            raise

    # -- identity ----------------------------------------------------------
    def get_rank(self) -> int:
        return self.rank

    def get_size(self) -> int:
        return self.size

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    # -- collectives (control-plane objects only) --------------------------
    def _group(self, channel: str) -> Any:
        if self._closed:
            raise RuntimeError("the distributed context is closed")
        try:
            return self._groups[channel]
        except KeyError:
            raise ValueError(
                f"unknown channel {channel!r} (one of {CHANNELS})") from None

    def gather(self, obj: Any,
               channel: str = CHANNEL_MAIN) -> Optional[List[Any]]:
        """Every process sends; the chief receives the list in rank
        order, the others None."""
        if self.size == 1:
            return [obj]
        import torch.distributed as dist

        out: Optional[List[Any]] = [None] * self.size if self.is_chief else None
        dist.gather_object(obj, out, dst=0, group=self._group(channel))
        return out

    def broadcast(self, obj: Any, channel: str = CHANNEL_MAIN) -> Any:
        """The chief's object, returned on every process."""
        if self.size == 1:
            return obj
        import torch.distributed as dist

        box = [obj if self.is_chief else None]
        dist.broadcast_object_list(box, src=0, group=self._group(channel))
        return box[0]

    def allgather(self, obj: Any, channel: str = CHANNEL_MAIN) -> List[Any]:
        gathered = self.gather(obj, channel=channel)
        return self.broadcast(gathered, channel=channel)

    def barrier(self, channel: str = CHANNEL_MAIN) -> None:
        self.allgather(None, channel=channel)

    def close(self) -> None:
        """Destroy the channel groups, and the default group when this
        context joined it. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if not self._groups and not self._owns_default:
            return
        import torch.distributed as dist

        if not dist.is_initialized():
            return
        for group in self._groups.values():
            dist.destroy_process_group(group)
        self._groups.clear()
        if self._owns_default:
            dist.destroy_process_group()


class DummyDistributedContext(DistributedContext):
    """The chief of a gang of one."""

    def __init__(self) -> None:
        super().__init__(rank=0, size=1)
