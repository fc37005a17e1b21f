"""The rank-axis collectives of the superstep engine.

The JAX package runs its ranks as ``shard_map`` over mesh axes and
reduces across them with ``lax.pmin``, ``lax.psum`` and
``lax.all_to_all`` (``repro/core/engine.py:238``, ``:287-291``,
``:413-446``, ``:480-500``, ``:535-562``).  The engine here calls the
same operations on one of two objects:

* :class:`StackedRanks` — every rank of the mesh on one device, stacked
  on dim 1 of the engine's ``(B, P, ...)`` tensors: a min or sum over
  ranks is an ``amin`` or ``sum`` over that axis, an all-to-all a
  transpose.
* :class:`ProcessRanks` — one rank a process of a ``torch.distributed``
  group (gloo or NCCL); the rank axis of the local tensors has length
  1, and each operation is one collective.

Every operation takes local tensors whose dim 1 is the local rank axis
(length ``local``) and returns what every rank of the scope agrees on.
A tensor's bytes pass through unchanged, so integer payloads bitcast to
float32 arrive bit for bit.  ``broadcast_object`` carries host objects
from one rank to all in call order (the query service's commands,
:mod:`repro_torch.serve.stream`).  Gloo takes CUDA tensors for every
operation used here and stages them through host memory itself.
"""

from __future__ import annotations

import collections
import pickle
from typing import Optional

import torch

from repro_torch.launch.mesh import RankMesh, make_rank_mesh

INF = float("inf")

#: the scopes of :meth:`min_over`
SCOPES = ("global", "pod")


class StackedRanks:
    """All ranks of ``mesh`` on one device (the default engine)."""

    rank: Optional[int] = None  # every rank is local

    def __init__(self, mesh: "RankMesh | int"):
        self.mesh = mesh if isinstance(mesh, RankMesh) else make_rank_mesh(mesh)
        self.world = self.local = self.mesh.size

    def local_ranks(self, x):
        """The local ranks' rows of a ``(..., P, n)`` array: all of them."""
        return x

    def min_over(self, key: torch.Tensor, scope: str) -> torch.Tensor:
        """The min of ``key`` (B, P, n) over ``scope``, broadcastable
        against it: (B, 1, 1) for ``global``, (B, P, 1) for ``pod``
        (each rank's pod's min; on a mesh without pods the global
        min)."""
        m = key.amin(dim=(1, 2), keepdim=True)
        if scope == "global" or self.mesh.pods == 1:
            return m
        B = key.shape[0]
        pods, per = self.mesh.pods, self.mesh.per_pod
        m = key.reshape(B, pods, per, -1).amin(dim=(2, 3), keepdim=True)
        return m.expand(B, pods, per, 1).reshape(B, self.world, 1)

    def reduce(self, C: torch.Tensor, is_min: bool,
               CL: Optional[torch.Tensor] = None):
        """The ``pmin`` exchange: (B, P, n_pad) candidates reduced over
        every rank with min (or max), each rank keeping its own n_local
        slice; with ``CL``, also the min level among the candidates
        that equal the winner.  Returns (mine, mineL) of (B, P, n_local)."""
        B = C.shape[0]
        Cg = C.amin(1) if is_min else C.amax(1)
        mine = Cg.reshape(B, self.world, -1)
        if CL is None:
            return mine, None
        CLg = torch.where(C == Cg[:, None], CL, INF).amin(1)
        return mine, CLg.reshape(B, self.world, -1)

    def all_to_all(self, X: torch.Tensor) -> torch.Tensor:
        """(B, P_src, P_dst, K) -> (B, P_dst, P_src, K): what each rank
        sent each destination, as the destination receives it."""
        return X.transpose(1, 2)

    def vote(self, flags: torch.Tensor) -> torch.Tensor:
        """The min over ranks of (k, B, P) integer flags: (k, B)."""
        return flags.amin(dim=2)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """A local sum over the local ranks, summed over every rank."""
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The local ranks' rows along ``dim``, gathered from every rank."""
        return x

    def broadcast_object(self, obj, src: int = 0):
        """``src``'s picklable object on every rank, in call order: here
        the object itself."""
        return obj


class ProcessRanks:
    """One rank of ``mesh`` in this process, the others in the processes
    of the default ``torch.distributed`` group; ``pod_group`` holds the
    ranks of this rank's pod (None on a mesh without pods).  Made by
    :func:`repro_torch.launch.mesh.init_ranks`.

    ``counts`` tallies the collectives by operation and the bytes this
    rank sent through them, which on gloo pass through host memory."""

    local = 1

    def __init__(self, mesh: RankMesh, rank: int, pod_group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessRanks needs an initialized process "
                               "group (repro_torch.launch.mesh.init_ranks)")
        if dist.get_world_size() != mesh.size or dist.get_rank() != rank:
            raise ValueError(
                f"process group (rank {dist.get_rank()} of "
                f"{dist.get_world_size()}) does not match rank {rank} of "
                f"mesh {mesh.shape}")
        if (pod_group is None) != (mesh.pods == 1):
            raise ValueError("a pod group is needed exactly when the mesh "
                             "has pods")
        self._dist = dist
        self.mesh = mesh
        self.rank = int(rank)
        self.world = mesh.size
        self.pod_group = pod_group
        self.backend = dist.get_backend()
        self.counts: collections.Counter = collections.Counter()

    def local_ranks(self, x):
        return x[..., self.rank:self.rank + 1, :]

    def _tally(self, op: str, x: torch.Tensor) -> None:
        self.counts[op] += 1
        self.counts["bytes"] += x.numel() * x.element_size()

    def _all_reduce(self, x, op, group=None, tag="all_reduce"):
        x = x.clone(memory_format=torch.contiguous_format)
        self._tally(tag, x)
        self._dist.all_reduce(x, op=op, group=group)
        return x

    def min_over(self, key, scope):
        m = key.amin(dim=(1, 2), keepdim=True)
        group = self.pod_group if scope == "pod" else None
        return self._all_reduce(m, self._dist.ReduceOp.MIN, group)

    def reduce(self, C, is_min, CL=None):
        ReduceOp = self._dist.ReduceOp
        Cg = self._all_reduce(C, ReduceOp.MIN if is_min else ReduceOp.MAX)
        n_local = C.shape[-1] // self.world
        lo = self.rank * n_local
        mine = Cg[..., lo:lo + n_local]
        if CL is None:
            return mine, None
        CLg = self._all_reduce(torch.where(C == Cg, CL, INF), ReduceOp.MIN)
        return mine, CLg[..., lo:lo + n_local]

    def all_to_all(self, X):
        send = X[:, 0].transpose(0, 1).contiguous()  # (P_dst, B, K)
        recv = torch.empty_like(send)
        self._tally("all_to_all", send)
        self._dist.all_to_all_single(recv, send)
        return recv.transpose(0, 1)[:, None]  # (B, 1, P_src, K)

    def vote(self, flags):
        return self._all_reduce(flags.amin(dim=2), self._dist.ReduceOp.MIN)

    def sum(self, x):
        return self._all_reduce(x, self._dist.ReduceOp.SUM)

    def gather(self, x, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        self._tally("all_gather", x)
        self._dist.all_gather(parts, x)
        return torch.cat(parts, dim=dim)

    def broadcast_object(self, obj, src: int = 0):
        """``src``'s object, pickled, on every rank: its length, then its
        bytes, as two broadcasts of one group in call order.  Gloo sends
        host tensors; NCCL a tensor on this process's current card.
        Counted as one ``broadcast`` of the pickled bytes."""
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.backend == "nccl" else torch.device("cpu"))
        if self.rank == src:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                    dtype=torch.uint8).to(dev)
            size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
        else:
            size = torch.zeros(1, dtype=torch.int64, device=dev)
        self._dist.broadcast(size, src)
        if self.rank != src:
            data = torch.empty(int(size), dtype=torch.uint8, device=dev)
        self.counts["broadcast"] += 1
        self.counts["bytes"] += data.numel() if self.rank == src else 0
        self._dist.broadcast(data, src)
        return obj if self.rank == src else pickle.loads(data.cpu().numpy().tobytes())
