"""One front door over the SPMD ranks of a sharded ``AnalyticsService``.

The reference serves a sharded engine from one process. The port runs one
process per rank (``distributed.ranks``), and every rank builds the same
service on its rank of the mesh, so every rank must issue the same
collectives in the same order. Rank 0 of the mesh (its first slot in mesh
order) is the only front door: ``submit``, admission and planning happen
there. Each service operation that issues a collective (a scheduler tick,
``warmup``, ``packed_result``) first broadcasts an op record: the op, its
arguments, and the ``RequestRecord``s rank 0 admitted since the last op, in
admission order, as admitted (ids, submit layers, admission outcomes and
plans). The other ranks run ``AnalyticsService.follow()``: they apply the
records, run the same op, and return at the stop op.

The ops travel over a gloo group of the mesh's ranks, apart from the
mesh's own group: a control op then never lines up against a collective
of the engines' group (an op sent while a follower is inside an engine
collective waits; it is never read as engine data), and on the GPU a
control op costs no device copy or sync. While the worker thread idles,
rank 0 sends a heartbeat op every ``HEARTBEAT_S`` seconds, so a follower
waiting for its next op never meets the group's timeout (30 minutes for
gloo). Heartbeats do not tick the layer clock.

When rank 0's side fails, ``abandon`` sends the error op from a daemon
thread: followers waiting for their next op raise with rank 0's traceback
at once, and a follower inside an engine collective is released when rank
0's process exits (``run_ranks`` then stops every rank).
"""
from __future__ import annotations

import threading

import torch.distributed as dist

__all__ = ["OpChannel"]

# the service ops, each issuing the engines' collectives on every rank
STEP, WARMUP, PACKED_RESULT = "step", "warmup", "packed_result"
# ops without a collective: release, fail, keep the group alive
STOP, ERROR, HEARTBEAT = "stop", "error", "heartbeat"
HEARTBEAT_S = 5.0

# one gloo group per set of ranks, shared by the services built on it
_GROUPS: dict[tuple, object] = {}


def _control_group(ranks: tuple):
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks), backend="gloo",
                                        use_local_synchronization=True)
    return _GROUPS[ranks]


class OpChannel:
    """The op broadcast of one sharded service, from the mesh's first rank
    to the others. ``members`` are the global ranks in mesh order and
    ``index`` this rank's slot among them."""

    def __init__(self, members: list[int], index: int):
        self.src = members[0]
        self.front = index == 0
        self.closed = False
        self._group = _control_group(tuple(sorted(members)))

    def send(self, op: str, args: tuple = (), records: list = ()) -> None:
        """Broadcast one op record (rank 0 only)."""
        if self.closed:
            raise RuntimeError(
                "the service's followers were released (close()); build a "
                "new service on the ranks to go on serving")
        dist.broadcast_object_list([(op, tuple(args), list(records))],
                                   src=self.src, group=self._group)
        if op == STOP:
            self.closed = True

    def recv(self) -> tuple:
        """The next op record, as rank 0 sent it (followers)."""
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self._group)
        return box[0]

    def abandon(self, error: str) -> None:
        """Send the error op without waiting for it (rank 0): a follower
        inside an engine collective does not take it until rank 0's
        process is gone."""
        if self.closed:
            return
        self.closed = True
        threading.Thread(
            target=dist.broadcast_object_list,
            args=([(ERROR, (error,), [])],),
            kwargs=dict(src=self.src, group=self._group),
            name="service-abandon", daemon=True).start()
