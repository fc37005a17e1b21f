"""Rank meshes and process groups: the SSSP engine's, and the model
topologies of sharded LM serving.

A :class:`RankMesh` names the axes of the engine's ranks, as the JAX
package's ``jax.make_mesh`` does for its devices: ``RankMesh((2, 4),
("pod", "data"))`` is 8 ranks in 2 pods.  Its flat rank is row-major
over the axes (``repro/core/engine.py::_flat_rank``), and a ``pod``
axis, where there is one, leads, so the ranks of a pod are contiguous.
The ``pod`` scope of an ordering hierarchy reduces over the ranks of
one pod; on a mesh without a ``pod`` axis it is every rank.

:func:`init_ranks` joins a ``torch.distributed`` process group as one
rank of a mesh and returns the collectives the engine runs
(:class:`repro_torch.core.ranks.ProcessRanks`).  :func:`spawn_ranks`
starts one process a rank and waits for them, each with a deadline.

    mesh = make_rank_mesh(4, pods=2)
    ranks = init_ranks("gloo", rank, 4, mesh, f"file://{path}")
    Solver(spec, n_parts=4, device="cpu", ranks=ranks).solve(problem)

A model's grid is a :class:`repro_torch.models.common.Topology`: the
JAX package's production meshes (:func:`make_production_mesh`,
:func:`make_topology`: 16 x 16 over ``("data", "model")``, or 2 x 16 x 16
with pods) and its CPU meshes (:func:`make_cpu_topology`) as grids that
need no devices and only plan, and :func:`init_topology`, which joins a
process group as one rank of such a grid and makes its ``dp`` and ``tp``
groups:

    topo = init_topology("gloo", rank, 4, make_cpu_topology(4, tp=2),
                         f"file://{path}", "cpu")
    cache, logits = lm.prefill_step(model, tokens, cfg, max_len, topo=topo)
"""

from __future__ import annotations

import dataclasses
import math
import time
from multiprocessing.connection import wait
from typing import Callable

import torch

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The shape and axis names of the engine's ranks."""

    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        names = tuple(str(a) for a in self.axis_names)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", names)
        if len(shape) != len(names) or not shape:
            raise ValueError(
                f"a mesh needs one name per axis: {shape} {names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes must be positive: {shape}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        if "pod" in names and names[0] != "pod":
            raise ValueError(
                f"the 'pod' axis must lead, so a pod's ranks are "
                f"contiguous: {names}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def pods(self) -> int:
        """The pod count: the ``pod`` axis's size, 1 without one."""
        return self.shape[0] if self.axis_names[0] == "pod" else 1

    @property
    def per_pod(self) -> int:
        return self.size // self.pods

    def pod_of(self, rank: int) -> int:
        """The pod of a flat rank: its index on the leading ``pod`` axis."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside [0, {self.size})")
        return rank // self.per_pod

    def pod_ranks(self, pod: int) -> list:
        """The flat ranks of one pod, in order."""
        return list(range(pod * self.per_pod, (pod + 1) * self.per_pod))


def make_rank_mesh(n: int, pods: int = 1) -> RankMesh:
    """``n`` ranks: one ``data`` axis, or ``(pods, n // pods)`` over
    ``("pod", "data")``."""
    if n < 1 or pods < 1 or n % pods:
        raise ValueError(f"{n} ranks do not split into {pods} pods")
    if pods == 1:
        return RankMesh((n,), ("data",))
    return RankMesh((pods, n // pods), ("pod", "data"))


def check_backend(backend: str, world: int, device) -> None:
    """Refuse a backend the processes cannot run on their devices, before
    any process group starts: NCCL takes CUDA tensors only, and refuses
    two ranks on one card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("the nccl backend runs on CUDA devices only")
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(
            f"nccl needs one card a process: {world} processes, "
            f"{cards} card(s) visible")


def init_ranks(backend: str, rank: int, world: int, mesh: RankMesh,
               init_method: str):
    """Join the process group as ``rank`` of ``world`` and create one
    subgroup a pod (every rank creates every subgroup, in pod order, as
    ``new_group`` requires).  Returns the engine's collectives."""
    import torch.distributed as dist

    from repro_torch.core.ranks import ProcessRanks  # core imports this module

    if mesh.size != world:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} ranks, the "
                         f"process group {world}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    pod_group = None
    if mesh.pods > 1:
        for pod in range(mesh.pods):
            group = dist.new_group(mesh.pod_ranks(pod))
            if pod == mesh.pod_of(rank):
                pod_group = group
    return ProcessRanks(mesh, rank, pod_group=pod_group)


def spawn_ranks(fn: Callable, world: int, args: tuple = (),
                timeout: float = 600.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes and
    wait for all of them.  Raises if a process exits non-zero (the
    others are stopped at once: they would wait for it in a collective)
    or if any is still running at the deadline."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, *args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        live = list(procs)
        while live:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"rank processes still running after {timeout:g} s: "
                    f"{[procs.index(p) for p in live]}")
            wait([p.sentinel for p in live], timeout=left)
            for p in [p for p in live if not p.is_alive()]:
                p.join()
                live.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(
                        f"rank process {procs.index(p)} exited with code "
                        f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


# ------------------------------------------------------------------ #
# model topologies (the JAX package's launch/mesh.py)


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """The JAX package's production mesh as a grid of ranks: 16 x 16 over
    ``("data", "model")``, or 2 x 16 x 16 over ``("pod", "data",
    "model")``."""
    if multi_pod:
        return RankMesh((2, 16, 16), ("pod", "data", "model"))
    return RankMesh((16, 16), ("data", "model"))


def make_topology(*, multi_pod: bool = False):
    """The production topology: dp over ``data`` (and ``pod``), tp over
    ``model``.  It plans; no process runs it."""
    from repro_torch.models.common import Topology

    dp = ("pod", "data") if multi_pod else ("data",)
    return Topology(grid=make_production_mesh(multi_pod=multi_pod), dp_axes=dp,
                    tp_axis="model")


def make_cpu_topology(n: int, tp: int = 1):
    """The JAX package's small mesh of ``n`` ranks: ``(n // tp, tp)``
    over ``("data", "model")``, or ``(n,)`` over ``("data",)`` without
    tensor parallelism."""
    from repro_torch.models.common import Topology

    if n < 1 or tp < 1 or n % tp:
        raise ValueError(f"{n} ranks do not split into tp groups of {tp}")
    if tp > 1:
        return Topology(grid=RankMesh((n // tp, tp), ("data", "model")),
                        dp_axes=("data",), tp_axis="model")
    return Topology(grid=RankMesh((n,), ("data",)), dp_axes=("data",), tp_axis=None)


def lm_grid(ranks: int):
    """The grid an LM cell is planned on at ``ranks`` ranks: tp =
    min(ranks, 16), dp = ranks / tp (the production mesh at 256)."""
    tp = min(ranks, 16)
    if ranks % tp:
        raise ValueError(f"{ranks} ranks do not split into tp groups of {tp}")
    return make_cpu_topology(ranks, tp)


def _members(topo, fixed: tuple) -> list:
    """The flat ranks whose coordinates on the axes not in ``fixed``
    equal this grid's rank ``r``'s, for each r: the group of ``r``."""
    from repro_torch.models.common import Topology

    groups = {}
    for r in range(topo.n_devices):
        c = Topology(grid=topo.grid, dp_axes=topo.dp_axes, tp_axis=topo.tp_axis,
                     rank=r).coords
        key = tuple(c[a] for a in topo.axis_names if a not in fixed)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


def init_topology(backend: str, rank: int, world: int, grid, init_method: str,
                  device) -> "Topology":
    """Join the process group as ``rank`` of ``world`` on the grid of
    ``grid`` (a Topology that plans) and make the ``dp`` and ``tp``
    groups (every rank makes every group, in one order, as ``new_group``
    requires; a group of one rank is None).  ``device`` is where this
    rank's tensors live: NCCL needs a card a rank (``check_backend``);
    gloo passes a card's tensors through host memory."""
    import torch.distributed as dist

    if grid.n_devices != world:
        raise ValueError(f"grid {grid.grid.shape} has {grid.n_devices} ranks, the "
                         f"process group {world}")
    check_backend(backend, world, device)
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return topology_groups(grid)


def topology_groups(grid) -> "Topology":
    """This process's rank of ``grid`` (a Topology that plans, of the
    joined process group's size) with its ``dp`` and ``tp`` groups, made
    now: one process group serves several grids, each rank making the
    same grids in the same order."""
    import torch.distributed as dist

    from repro_torch.models.common import Groups, Topology

    rank, backend = dist.get_rank(), dist.get_backend()
    if grid.n_devices != dist.get_world_size():
        raise ValueError(f"grid {grid.grid.shape} has {grid.n_devices} ranks, the "
                         f"process group {dist.get_world_size()}")
    mine = {}
    for scope, fixed in (("dp", grid.dp_axes), ("tp", (grid.tp_axis,))):
        for members in _members(grid, fixed):
            group = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                mine[scope] = group
    return Topology(grid=grid.grid, dp_axes=grid.dp_axes, tp_axis=grid.tp_axis, rank=rank,
                    groups=Groups(dp=mine["dp"], tp=mine["tp"], backend=backend))
