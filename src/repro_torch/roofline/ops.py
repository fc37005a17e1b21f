"""Recorded-op analysis: what an eager torch program moves and runs.

The JAX package reads a compiled HLO module's text (``roofline/hlo.py``
there).  The port compiles nothing: each torch op runs as its own
kernel.  So the port records the program as it runs:

* :class:`OpRecorder` — a ``TorchDispatchMode`` that notes every aten
  op with its operand and result bytes, result dtypes and operations,
  and the storages it writes; and a ``TorchFunctionMode`` that counts
  host reads (``tolist``, ``item``, ``bool(t)``, ...: each one waits
  for the device).
  A frontier kernel's call (``kernels/_lib.py::kernel_call``) is one
  opaque record, ``kernel.<name>``, charged its closed form
  (``roofline/kernels.py``) on either route: the card's launch is no
  aten op, and the plain version a CPU tensor takes is not what the
  card runs.
* :class:`RecordingRanks` — the stacked ranks of ``core/ranks.py``
  that note each rank-axis collective the engine calls, by the
  ``torch.distributed`` operation a process backend runs for it, with
  the bytes one rank sends.

:func:`op_traffic` charges every recorded op its operand and result
bytes, grouped by op; views and metadata ops cost nothing.  An eager op
reads its operands from device memory and writes its results back, so
this is the traffic with no reuse between ops: the bar that L2 hits can
only lower.  :func:`collective_bytes` sums a recording ranks object's
calls, :func:`flops_and_bytes` counts operations (matmul-like ops as
2·m·n·k, every other op one an output element) beside the bytes.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.ranks import StackedRanks
from repro_torch.kernels import _lib
from repro_torch.roofline.kernels import frontier_call_traffic

#: Tensor methods that copy a value to the host (and so wait for the
#: device)
HOST_READS = frozenset({
    "tolist", "item", "__bool__", "__int__", "__float__", "__index__",
    "__complex__", "numpy", "__array__",
})

#: aten ops that move no data: allocations and metadata (view ops are
#: recognised by their schema)
FREE_OPS = frozenset({
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.lift_fresh",
    "aten.detach", "aten.alias", "aten._unsafe_view", "aten.sym_size",
    "aten.sym_stride", "aten.sym_numel", "aten.sym_storage_offset",
})

#: matmul-like aten ops, counted as 2·m·n·k
MATMUL_OPS = frozenset({
    "aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.matmul",
    "aten.linear",
})


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a kernel touches reading or writing ``t``: its elements,
    or its storage where that is smaller (an expanded view)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op as it ran."""

    op: str             # the overload packet, e.g. "aten.scatter_reduce_"
    in_bytes: int       # operand tensors' bytes
    out_bytes: int      # result tensors' bytes
    out_dtypes: tuple   # result dtypes
    flops: int          # operations (see flops_and_bytes)
    free: bool          # a view or metadata op: no traffic


def _matmul_flops(name: str, args) -> int:
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("aten.addmm", "aten.baddbmm"):
        ts = ts[1:]
    if len(ts) < 2:
        return 0
    a, b = ts[0], ts[1]
    if name == "aten.linear":  # x (..., k) @ w (n, k)^T
        return 2 * a.numel() * b.shape[0]
    k = a.shape[-1]
    return 2 * (a.numel() // k) * k * b.shape[-1]


class _FunctionTap(TorchFunctionMode):
    def __init__(self, rec: "OpRecorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name not in HOST_READS:
            return func(*args, **(kwargs or {}))
        self.rec.host_reads.append(name)
        self.rec._reading += 1
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.rec._reading -= 1


class _DispatchTap(TorchDispatchMode):
    def __init__(self, rec: "OpRecorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rec._note(func, args, kwargs, out)
        return out


class OpRecorder:
    """Records the aten ops and host reads of the code run inside it::

        with OpRecorder() as rec:
            fn()
        rec.records, rec.host_reads, rec.writes
    """

    def __init__(self):
        self.records: list[OpRecord] = []
        self.host_reads: list[str] = []
        self.writes: set = set()  # storage pointers written in place
        self.kernel_calls: collections.Counter = collections.Counter()
        self._reading = 0
        self._opaque = 0
        self._modes = ()

    def __enter__(self) -> "OpRecorder":
        self._modes = (_FunctionTap(self), _DispatchTap(self))
        for m in self._modes:
            m.__enter__()
        _lib.add_listener(self)
        return self

    def __exit__(self, *exc) -> None:
        _lib.remove_listener(self)
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self._modes = ()

    # the kernels' listener interface (kernels/_lib.py::kernel_call)
    def enter(self, kernel: str, route: str, shape: dict) -> None:
        self.kernel_calls[kernel, route] += 1
        if not self._opaque:
            nbytes, ops = frontier_call_traffic(kernel, shape)
            self.records.append(OpRecord(
                f"kernel.{kernel}", 0, nbytes, (torch.float32,), ops, False))
        self._opaque += 1

    def exit(self) -> None:
        self._opaque -= 1

    def _note(self, func, args, kwargs, out) -> None:
        if self._opaque:
            return  # inside a kernel's op: its closed form stands for it
        name = str(func.overloadpacket)
        if name == "aten._local_scalar_dense" and not self._reading:
            self.host_reads.append(name)  # a read no Tensor method made
        schema = func._schema
        if schema.is_mutable:
            for i, a in enumerate(schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in tree_leaves(v):
                    if isinstance(t, torch.Tensor):
                        self.writes.add(t.untyped_storage().data_ptr())
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        # a copy to the host (a host read of a card's tensor) is a host
        # transfer, not device-memory traffic: charged nothing, as on
        # the CPU, where the same read copies nothing
        to_host = any(t.device.type == "cpu" for t in outs) and any(
            t.device.type not in ("cpu", "meta") for t in ins)
        if func.is_view or name in FREE_OPS or to_host:
            self.records.append(OpRecord(
                name, 0, 0, tuple(t.dtype for t in outs), 0, True))
            return
        flops = (_matmul_flops(name, args) if name in MATMUL_OPS
                 else sum(t.numel() for t in outs))
        self.records.append(OpRecord(
            name, sum(map(tensor_bytes, ins)), sum(map(tensor_bytes, outs)),
            tuple(t.dtype for t in outs), flops, False))

    @property
    def dtypes(self) -> set:
        """Every result dtype of the recorded ops."""
        return {dt for r in self.records for dt in r.out_dtypes}


def op_traffic(records: Iterable[OpRecord], top: Optional[int] = 8) -> dict:
    """Device-memory bytes of recorded ops: each op's operand and result
    bytes, views and metadata free.  Returns ``{"total_bytes": B,
    "by_op": {op: B}}``, the ``top`` largest ops first (None: all)."""
    per_op: dict = collections.defaultdict(int)
    for r in records:
        if not r.free:
            per_op[r.op] += r.in_bytes + r.out_bytes
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])
    return {
        "total_bytes": int(sum(per_op.values())),
        "by_op": dict(ranked if top is None else ranked[:top]),
    }


def flops_and_bytes(records: Iterable[OpRecord]) -> tuple[float, float]:
    """(operations, device-memory bytes) of recorded ops: matmul-like
    ops count 2·m·n·k, every other op one an output element; views and
    metadata ops count nothing."""
    flops = byts = 0
    for r in records:
        if not r.free:
            flops += r.flops
            byts += r.in_bytes + r.out_bytes
    return float(flops), float(byts)


class RecordingRanks(StackedRanks):
    """:class:`StackedRanks` that notes every collective it stands for:
    ``calls`` holds ``(op, bytes one rank sends, dtype, shape)`` with
    ``op`` the ``torch.distributed`` operation :class:`ProcessRanks`
    runs (``all_reduce``, ``all_to_all``, ``all_gather``).  An
    all-to-all counts the bytes a rank sends the other ranks; an
    all-reduce the rank's contribution, as ``ProcessRanks.counts``
    tallies it."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.calls: list = []

    def _note(self, op: str, nbytes: int, x: torch.Tensor) -> None:
        self.calls.append((op, int(nbytes), x.dtype, tuple(x.shape)))

    def min_over(self, key, scope):
        self._note("all_reduce", key.shape[0] * key.element_size(), key)
        return super().min_over(key, scope)

    def reduce(self, C, is_min, CL=None):
        per_rank = C.numel() // self.world * C.element_size()
        self._note("all_reduce", per_rank, C)
        if CL is not None:
            self._note("all_reduce", per_rank, CL)
        return super().reduce(C, is_min, CL)

    def all_to_all(self, X):
        B, P, _, K = X.shape
        self._note("all_to_all", B * (P - 1) * K * X.element_size(), X)
        return super().all_to_all(X)

    def vote(self, flags):
        self._note("all_reduce", flags.numel() // self.world
                   * flags.element_size(), flags)
        return super().vote(flags)

    def sum(self, x):
        self._note("all_reduce", x.numel() * x.element_size(), x)
        return super().sum(x)

    def gather(self, x, dim):
        self._note("all_gather", x.numel() // self.world * x.element_size(), x)
        return super().gather(x, dim)


def collective_bytes(ranks_or_calls) -> dict:
    """Per-rank collective traffic of a :class:`RecordingRanks` (or its
    ``calls``): ``{"bytes": {op: B}, "counts": {op: n},
    "total_bytes": B}``."""
    calls = getattr(ranks_or_calls, "calls", ranks_or_calls)
    out: dict = collections.defaultdict(int)
    counts: dict = collections.defaultdict(int)
    for op, nbytes, _, _ in calls:
        out[op] += nbytes
        counts[op] += 1
    return {
        "bytes": dict(out),
        "counts": dict(counts),
        "total_bytes": int(sum(out.values())),
    }
