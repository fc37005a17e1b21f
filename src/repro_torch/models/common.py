"""Shared model building blocks: the rank topology, norms, RoPE,
activations, init.

A :class:`Topology` is the JAX package's (``repro/models/common.py``):
a grid of ranks whose axes have roles, data parallelism over ``dp_axes``
(``("data",)``, or ``("pod", "data")``) and tensor/expert parallelism
over ``tp_axis`` (``"model"``, or None).  Where the JAX package's grid
is a device mesh and its models pin layouts with
``with_sharding_constraint`` (``constrain``, which the port does not
need: it places every tensor itself), the port's is one process a rank
over ``torch.distributed``: the topology names this process's rank and
holds the ``dp`` and ``tp`` process groups, and its collectives tally
what they send (:attr:`Topology.counts`).  ``spec(*roles)`` resolves the
roles ``"dp"``, ``"tp"`` and ``"all"`` to axis names as the reference's
does (a ``PartitionSpec``'s entries: None, an axis name, or a tuple of
names), and :func:`shard_shape`/:func:`shard_slices` read such a spec.
A topology without process groups only plans (``launch/mesh.py``'s
production and CPU grids); :func:`single_device_topology` has one rank.

Training differentiates through the collectives (Megatron's regions):
:func:`copy_to` (identity forward, a sum over the group backward) where a
replicated tensor enters per-rank work whose gradients are partial,
:func:`reduce_from` (a sum forward, identity backward) where partial sums
leave it, :func:`gather_from` (all_gather forward; backward a
reduce-scatter, or this rank's block where the consumers' gradients are
already whole on every rank) for the FSDP gathers over ``dp`` and the
sequence-parallel residual over ``tp``, and :func:`reduce_scatter_to`
(reduce-scatter forward, all_gather backward).  The convention: a
replicated activation carries its whole gradient on every rank of the
group, a rank's share of the batch only its rows' part.  :func:`max_over`
is the group's maximum, with no gradient (a log-sum-exp's shift).

Initialisers draw from an explicit ``torch.Generator``, whose device is
where the tensor is made (so a full-size model is initialised on the
card, never on the host).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import RankMesh

#: a spec's entries name the axes a dimension is split over
Spec = tuple


@dataclasses.dataclass(frozen=True)
class Groups:
    """This rank's process groups: ``dp`` (the ranks that differ only in
    their ``dp_axes`` coordinates) and ``tp`` (only in ``tp_axis``); the
    default group holds every rank (scope ``"world"``).  A group of one
    rank is None: its collectives are the identity."""
    dp: object = None
    tp: object = None
    backend: str = "gloo"


@dataclasses.dataclass(eq=False)
class Topology:
    """A grid of ranks and its axes' roles (the JAX package's
    ``Topology``).  ``rank`` is this process's flat rank, row-major over
    ``grid`` (so a ``pod`` axis leads); ``groups`` holds its process
    groups, None for a grid that only plans."""

    grid: RankMesh
    dp_axes: tuple = ("data",)
    tp_axis: Optional[str] = "model"
    rank: int = 0
    groups: Optional[Groups] = None
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    #: prefixed to the keys the collectives tally (:meth:`tagged`)
    tag: str = ""

    def __post_init__(self):
        names = self.grid.axis_names
        for a in self.dp_axes:
            if a not in names:
                raise ValueError(f"dp axis {a!r} is not an axis of {names}")
        if self.tp_axis is not None and self.tp_axis in self.dp_axes:
            raise ValueError(f"axis {self.tp_axis!r} cannot be both dp and tp")
        if not 0 <= self.rank < self.grid.size:
            raise ValueError(f"rank {self.rank} outside the grid's {self.grid.size}")

    @property
    def axis_names(self) -> tuple:
        return self.grid.axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.grid.axis_names, self.grid.shape))

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def tp_size(self) -> int:
        if self.tp_axis is None or self.tp_axis not in self.axis_names:
            return 1
        return self.shape[self.tp_axis]

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.dp_axes)

    @property
    def n_devices(self) -> int:
        return self.grid.size

    def spec(self, *roles) -> Spec:
        """A spec's entries, dropping roles the grid lacks: ``"dp"`` the
        dp axes, ``"tp"`` the tp axis (None at tp 1), ``"all"`` every
        axis; None and axis names pass through."""
        out = []
        for r in roles:
            if r == "dp":
                out.append(self.dp)
            elif r == "tp":
                out.append(self.tp_axis if self.tp_size > 1 else None)
            elif r == "all":
                out.append(self.axis_names)
            else:
                out.append(r)
        return tuple(out)

    # -- this rank's place in the grid --

    @property
    def coords(self) -> dict:
        """This rank's index on each axis."""
        out, r = {}, self.rank
        for name, size in reversed(list(self.shape.items())):
            r, out[name] = divmod(r, size)
        return {a: out[a] for a in self.axis_names}

    def index(self, entry) -> int:
        """This rank's block along a dimension split over ``entry`` (an
        axis name or a tuple of them, row-major in the tuple's order)."""
        axes = _axes(entry)
        idx, c = 0, self.coords
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def factor(self, entry) -> int:
        """The blocks a dimension split over ``entry`` has."""
        return math.prod(self.shape[a] for a in _axes(entry))

    @property
    def tp_rank(self) -> int:
        return self.index(self.tp_axis) if self.tp_size > 1 else 0

    @property
    def dp_rank(self) -> int:
        return self.index(self.dp_axes)

    # -- collectives, tallied in ``counts`` as ProcessRanks tallies them --

    def _group(self, scope: str):
        if self.groups is None:
            if self.n_devices > 1:
                raise RuntimeError("this topology only plans: it has no process groups "
                                   "(launch/mesh.py::init_topology makes them)")
            return None, 1
        if scope == "world":
            return None, self.n_devices  # the default group
        size = {"dp": self.dp_size, "tp": self.tp_size}[scope]
        return getattr(self.groups, scope), size

    def _tally(self, op: str, x: torch.Tensor) -> None:
        self.counts[self.tag + op] += 1
        self.counts[self.tag + "bytes"] += x.numel() * x.element_size()

    @contextlib.contextmanager
    def tagged(self, tag: str):
        """Tally the block's collectives under keys prefixed by ``tag``
        (a checkpointed layer's forward run again in the backward)."""
        before, self.tag = self.tag, tag
        try:
            yield
        finally:
            self.tag = before

    def all_reduce(self, x: torch.Tensor, scope: str, op: str = "sum") -> torch.Tensor:
        """The sum (or, ``op="max"``, the maximum) of ``x`` over the
        ``scope`` group, a new tensor on every rank of it."""
        group, size = self._group(scope)
        if size == 1:
            return x
        import torch.distributed as dist

        x = x.clone(memory_format=torch.contiguous_format)
        self._tally("all_reduce", x)
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=group)
        return x

    def reduce_scatter(self, x: torch.Tensor, dim: int, scope: str) -> torch.Tensor:
        """The sum of ``x`` over the ``scope`` group, cut along ``dim``
        into a block a rank of it: this rank's block (the group's ranks in
        order, as :meth:`all_gather` concatenates them).  Gloo takes a
        card's tensors here (it stages them through host memory itself)."""
        group, size = self._group(scope)
        if size == 1:
            return x
        import torch.distributed as dist

        if x.shape[dim] % size:
            raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not split over "
                             f"{size} ranks")
        blocks = [b.contiguous() for b in x.chunk(size, dim)]
        out = torch.empty_like(blocks[0])
        self._tally("reduce_scatter", x)
        dist.reduce_scatter(out, blocks, group=group)
        return out

    def all_gather(self, x: torch.Tensor, dim: int, scope: str) -> torch.Tensor:
        """The group's ``x`` concatenated along ``dim`` in rank order."""
        group, size = self._group(scope)
        if size == 1:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        self._tally("all_gather", x)
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def all_to_all(self, chunks: list, scope: str) -> list:
        """``chunks[j]`` (equal shapes) to the group's rank j; returns
        what each rank of the group sent this one, in rank order.  Gloo
        takes host tensors for this collective, so a card's chunks pass
        through host memory there."""
        group, size = self._group(scope)
        if size == 1:
            return list(chunks)
        import torch.distributed as dist

        send = torch.stack(chunks).contiguous()
        dev = send.device
        if self.groups.backend == "gloo" and dev.type != "cpu":
            send = send.cpu()
        recv = torch.empty_like(send)
        self._tally("all_to_all", send)
        dist.all_to_all_single(recv, send, group=group)
        return list(recv.to(dev).unbind(0))


# -- the collectives as autograd functions (training) --


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, topo, scope):
        ctx.topo, ctx.scope = topo, scope
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.topo.all_reduce(g, ctx.scope), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, topo, scope):
        return topo.all_reduce(x, scope)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, topo, dim, scope, grad_sum):
        ctx.topo, ctx.dim, ctx.scope, ctx.grad_sum = topo, dim, scope, grad_sum
        return topo.all_gather(x, dim, scope)

    @staticmethod
    def backward(ctx, g):
        topo, dim, scope = ctx.topo, ctx.dim, ctx.scope
        if ctx.grad_sum:
            return topo.reduce_scatter(g, dim, scope), None, None, None, None
        size = topo.dp_size if scope == "dp" else topo.tp_size
        i = topo.dp_rank if scope == "dp" else topo.tp_rank
        return g.chunk(size, dim)[i].contiguous(), None, None, None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, topo, dim, scope):
        ctx.topo, ctx.dim, ctx.scope = topo, dim, scope
        return topo.reduce_scatter(x, dim, scope)

    @staticmethod
    def backward(ctx, g):
        return ctx.topo.all_gather(g, ctx.dim, ctx.scope), None, None, None


def _one(topo: Optional[Topology], scope: str) -> bool:
    return topo is None or (topo.dp_size if scope == "dp" else topo.tp_size) == 1


def copy_to(x, topo: Optional[Topology], scope: str):
    """``x`` as it is; its gradient summed over the ``scope`` group (a
    replicated tensor entering per-rank work)."""
    return x if _one(topo, scope) else _CopyTo.apply(x, topo, scope)


def reduce_from(x, topo: Optional[Topology], scope: str):
    """``x`` summed over the ``scope`` group; its gradient passed to
    every rank as it is (the ranks' partial sums leaving their work)."""
    return x if _one(topo, scope) else _ReduceFrom.apply(x, topo, scope)


def gather_from(x, topo: Optional[Topology], dim: int, scope: str, grad_sum: bool = True):
    """The group's blocks of ``x`` concatenated along ``dim``.  Backward:
    the gradient's sum over the group, this rank's block (a
    reduce-scatter: the consumers' gradients are partial), or, with
    ``grad_sum=False`` (consumers whose gradients are already whole on
    every rank), this rank's block of its own."""
    if _one(topo, scope):
        return x
    return _GatherFrom.apply(x, topo, dim, scope, grad_sum)


def reduce_scatter_to(x, topo: Optional[Topology], dim: int, scope: str):
    """``x`` summed over the ``scope`` group, this rank's block along
    ``dim``; its gradient all-gathered."""
    return x if _one(topo, scope) else _ReduceScatterTo.apply(x, topo, dim, scope)


def max_over(x, topo: Optional[Topology], scope: str):
    """The group's elementwise maximum of ``x``, without a gradient."""
    return x.detach() if _one(topo, scope) else topo.all_reduce(x.detach(), scope, op="max")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec: Spec) -> set:
    """The axes a spec splits any dimension over."""
    return {a for entry in spec for a in _axes(entry)}


def single_device_topology() -> Topology:
    """One rank, no tensor parallelism, no process groups."""
    return Topology(grid=RankMesh((1,), ("data",)), dp_axes=("data",), tp_axis=None)


def sharded(topo: Optional[Topology]) -> Optional[Topology]:
    """``topo`` where it has more than one rank, else None: one card or a
    topology of one rank runs the one-card code."""
    return None if topo is None or topo.n_devices == 1 else topo


def shard_shape(shape, spec: Spec, topo: Topology) -> tuple:
    """A rank's block of an array of ``shape`` laid out by ``spec``: each
    split dimension ceil(dim / blocks), as XLA pads an uneven split."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // topo.factor(e)) for n, e in zip(shape, spec))


def shard_slices(shape, spec: Spec, topo: Topology) -> tuple:
    """This rank's block of an array of ``shape`` laid out by ``spec``,
    as one slice a dimension; a split dimension must be a multiple of
    its blocks."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, (n, e) in enumerate(zip(shape, spec)):
        f = topo.factor(e)
        if n % f:
            raise ValueError(f"dimension {dim} ({n}) does not split into {f} blocks "
                             f"over {e!r}")
        size = n // f
        lo = topo.index(e) * size
        out.append(slice(lo, lo + size))
    return tuple(out)


def generator(seed: int, device=None) -> torch.Generator:
    """A seeded generator on ``device`` (``None`` means the card)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ----------------------------------------------------------------- #
# numerics


def rms_norm(x, scale, eps: float = 1e-5):
    """Computed in f32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rope_angles(positions, dim: int, theta: float = 10000.0):
    """(..., dim/2) cos/sin tables for rotary embedding."""
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device)
        / dim
    )
    ang = positions.float()[..., None] * freqs  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (S, D/2) or broadcastable.  Rotates
    the two halves (non-interleaved); a bf16 x times the f32 tables
    computes in f32 and casts back to x's dtype."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    while cos.dim() < x1.dim():  # broadcast over the head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def swiglu(gate, up):
    return F.silu(gate) * up


def relu2(x):
    r = F.relu(x)
    return r * r


# ----------------------------------------------------------------- #
# initialization


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal draw in f32, cast to dtype."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def fan_in_init(gen: torch.Generator, shape, fan_in: Optional[int] = None,
                dtype=torch.float32) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) > 1 else shape[-1]
    return normal_init(gen, shape, 1.0 / math.sqrt(fan), dtype)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
