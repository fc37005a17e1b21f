"""The query service's command stream over a process backend.

Over :class:`repro_torch.core.ranks.ProcessRanks` every solve is
collective: each rank process must run the same ``solve_batch``,
``resolve`` and ``solve`` calls in the same order.  Rank 0 runs the
service (admits queries, times them, decides when to flush) and
records each public call of the service's objects (``Router.submit``
and ``flush``, ``UpdateFeed.apply``, ``LandmarkIndex.refresh``) in
order.  Before it runs a collective it broadcasts what it recorded
since the last broadcast, as one object; every other rank replays the
calls on its own objects (:meth:`CommandStream.follow`), which then
run the same solves.  A call made inside another (a size-triggered
flush inside ``submit``, the landmark refresh inside ``apply``) is not
recorded: its replay repeats it.

So the answers, the cache, the landmark matrix and every counter are
the same on every rank, except the latencies, which each rank clocks
itself.  Every rank must build the service's objects in the same order
before rank 0 drives them; then rank 0 calls ``Router.close`` when it
is done and the others ``Router.follow``, which returns at that close.

On stacked ranks (one process) the stream records nothing.
"""

from __future__ import annotations

import contextlib
import functools
import weakref

#: ranks object -> its stream (one stream a process group)
_STREAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

STOP = "stop"


class CommandStream:
    """Rank 0's recorded calls and their replay on the other ranks."""

    def __init__(self, ranks=None):
        self.ranks = ranks
        self.distributed = (ranks is not None and ranks.rank is not None
                            and ranks.world > 1)
        self.leader = not self.distributed or ranks.rank == 0
        self.broadcasts = 0
        self._objects: list = []
        self._log: list = []
        self._depth = 0

    def register(self, obj) -> int:
        """Give ``obj`` the next id (the same on every rank, since every
        rank builds its objects in the same order); -1 where nothing is
        recorded."""
        if not self.distributed:
            return -1
        self._objects.append(obj)
        return len(self._objects) - 1

    @contextlib.contextmanager
    def command(self, oid: int, name: str, args: tuple, kwargs: dict):
        """Record the call ``objects[oid].name(*args, **kwargs)`` on rank
        0 when it is not nested in another recorded call."""
        if self.distributed and self.leader and self._depth == 0:
            self._log.append((oid, name, args, kwargs))
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def sync(self) -> None:
        """On rank 0, broadcast the calls recorded since the last
        broadcast; call before any collective.  Elsewhere a no-op: the
        other ranks receive in :meth:`follow`."""
        if self.distributed and self.leader and self._log:
            log, self._log = self._log, []
            self.ranks.broadcast_object(log, src=0)
            self.broadcasts += 1

    def close(self) -> None:
        """On rank 0, send what is left and the stop that ends every
        other rank's :meth:`follow`."""
        if self.distributed and self.leader:
            self._log.append((None, STOP, (), {}))
            self.sync()

    def follow(self) -> list:
        """On a rank other than 0, replay rank 0's calls until its
        :meth:`close`; returns ``(name, result)`` of every call replayed."""
        if not self.distributed or self.leader:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a process backend")
        done = []
        while True:
            log = self.ranks.broadcast_object(None, src=0)
            self.broadcasts += 1
            for oid, name, args, kwargs in log:
                if name == STOP:
                    return done
                done.append((name, getattr(self._objects[oid], name)(
                    *args, **kwargs)))


#: the stream of every solver whose ranks share one process
_LOCAL = CommandStream()


def stream_for(solver) -> CommandStream:
    """The command stream of ``solver``'s process group (its ranks)."""
    ranks = solver.ranks
    if ranks.rank is None or ranks.world == 1:
        return _LOCAL
    stream = _STREAMS.get(ranks)
    if stream is None:
        stream = _STREAMS[ranks] = CommandStream(ranks)
    return stream


def recorded(method):
    """Record calls of a service method in its object's command stream
    (``self._stream``, ``self._oid``)."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with self._stream.command(self._oid, method.__name__, args, kwargs):
            return method(self, *args, **kwargs)
    return call
