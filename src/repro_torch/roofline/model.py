"""Three-term roofline model for one NVIDIA H100 SXM (the port's card).

    compute term    = operations / peak rate of their type   (per card)
    memory term     = bytes / device-memory rate             (per card)
    collective term = collective bytes / NVLink rate         (per card)

The rates are the data sheet's for the H100 SXM5 at its 700 W limit
(NVIDIA H100 Tensor Core GPU data sheet): 3.35 TB/s of HBM3, 989 TFLOP/s
of dense bf16 on the tensor cores, 67 TFLOP/s of float32 outside them
(495 TFLOP/s of TF32 in them, so 165 of float32 as 3xTF32), and NVLink 4 at 900 GB/s in total, 450 GB/s each way.  A card set below
700 W runs slower under load, so a measured time is read beside the
card's name and power limit.

The dominant term is the bottleneck; ``model_flops / flops`` says how
much of the executed compute is useful.  :func:`bound` is the least
time one kernel could take for its must-move bytes and operations.
"""

from __future__ import annotations

import dataclasses

#: device-memory rate, bytes/s (HBM3)
MEM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, operations/s
F32_OPS_PER_S = 67e12
#: bf16 on the tensor cores, dense, operations/s
BF16_OPS_PER_S = 989e12
#: float32 as 3xTF32 on the tensor cores (495 TFLOP/s dense TF32, three
#: TF32 products a float32 product): the floor of an f32 kernel that
#: runs there, operations/s
TF32X3_OPS_PER_S = 495e12 / 3
#: NVLink 4, one direction, bytes/s
LINK_BYTES_PER_S = 450e9

HBM_BW = MEM_BYTES_PER_S
LINK_BW = LINK_BYTES_PER_S
#: peak operations/s by the operands' type
PEAK_FLOPS = {
    "bfloat16": BF16_OPS_PER_S, "bf16": BF16_OPS_PER_S,
    "float32": F32_OPS_PER_S, "f32": F32_OPS_PER_S,
}


def peak_for(dtype) -> float:
    """The peak rate for operands of ``dtype`` (a name or a torch dtype)."""
    name = str(dtype).replace("torch.", "")
    try:
        return PEAK_FLOPS[name]
    except KeyError:
        raise ValueError(
            f"no peak rate for {dtype!r}; known: {sorted(PEAK_FLOPS)}"
        ) from None


def bound(nbytes: int, ops: int,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time, in ms, for moving ``nbytes`` through device memory
    and doing ``ops`` operations at ``ops_per_s``: the larger term, with
    ``"bytes"`` or ``"operations"`` naming it."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    chips: int
    hlo_flops: float          # executed operations, per card
    hlo_bytes: float          # device-memory bytes, per card
    coll_bytes: float         # collective bytes, per card
    model_flops: float        # useful operations of the whole step (global)
    dtype: str = "bfloat16"   # picks the peak rate

    @property
    def peak(self) -> float:
        return peak_for(self.dtype)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.peak

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=lambda k: terms[k])

    @property
    def t_bound(self) -> float:
        """Roofline-limited step time (no overlap assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """model_flops / (chips · executed operations)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful operations over what the cards could do in the bound
        time."""
        if self.t_bound <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.peak * self.t_bound)

    def row(self) -> dict:
        return {
            "arch": self.arch, "cell": self.cell, "mesh": self.mesh,
            "chips": self.chips, "dtype": self.dtype,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_record(rec: dict) -> Roofline:
    """A :class:`Roofline` from a dry-run record (the JAX package's
    record layout: ``cost``, optional ``traffic``, ``collectives``,
    optional layer ``probes``), with the peak of ``rec["dtype"]``
    (default bf16)."""
    flops = rec["cost"].get("flops", 0.0)
    if rec.get("traffic"):
        byts = rec["traffic"]["total_bytes"]
        bkey = "traffic_bytes"
    else:
        byts = rec["cost"].get("bytes accessed", 0.0)
        bkey = "bytes"
    coll = rec["collectives"]["total_bytes"]
    probes = rec.get("probes")
    if probes:
        # a layer-scan body counted once: the totals from the depth-1
        # and depth-2 probes
        L = probes["n_layers"]
        p1, p2 = probes["L1"], probes["L2"]
        if bkey not in p1:
            bkey = "bytes"
        flops = p1["flops"] + (L - 1) * (p2["flops"] - p1["flops"])
        byts = p1[bkey] + (L - 1) * (p2[bkey] - p1[bkey])
        coll = p1["collective_bytes"] + (L - 1) * (
            p2["collective_bytes"] - p1["collective_bytes"]
        )
    return Roofline(
        arch=rec["arch"], cell=rec["cell"], mesh=rec["mesh"],
        chips=rec["chips"], hlo_flops=flops, hlo_bytes=byts,
        coll_bytes=coll, model_flops=rec["model_flops"],
        dtype=rec.get("dtype", "bfloat16"),
    )
