"""Frontier compaction and the sparse candidate exchange.

* :func:`compact_rows` — the eligible virtual-row mask of every rank
  compacted into a fixed-capacity index list (cap F) with an overflow
  flag for the dense fallback.  ``torch.nonzero`` has no static size,
  so this is a running count and a scatter into the cap: no host sync.
* :func:`bucket_slots` / :func:`scatter_plane` — per-destination-rank
  slotting of candidates into fixed-capacity (idx, val) buffers.
* :func:`sparse_payload` / :func:`unpack_combine` — the payload of one
  all-to-all and the owner-side combine back into a dense array.  The
  exact payload is ``[f32 values | bitcast-i32 indices | (f32 levels)]``
  per destination; the quantized ones (:data:`PAYLOAD_MODES` ``bf16``,
  ``u16``) move 32-bit words ``[indices | packed 16-bit value-delta
  codes | segment lower bound (+ scale) | (bitcast levels)]``.  Their
  codes round up only, so every decoded candidate is >= the exact one
  and the self-stabilizing kernel repairs the error.

Every function takes a leading rank axis: the local ranks, all P of
them when the engine stacks its ranks on one device, one in a process
of the process backend (the payload still has P destinations).
Capacities are static Python ints.

The codecs keep u32 words in int64 tensors (torch has few uint32
ops) and do their shifts, masks and carries there; a float's bits come
from ``Tensor.view(torch.int32)``.  Constants that divide or bound a
float32 tensor are float32 tensors on its device: CUDA's ``div`` by a
host scalar multiplies by the reciprocal, which rounds differently from
the JAX package's IEEE division.

Spill columns: each scatter here sends every element that is to be
dropped to a spill column of its own, dropped after, not all of them
to one column: a scatter on the card serialises the writes that share
an address, an atomic one (``scatter_reduce_``) by a compare-and-swap
loop each.  No result changes, since a spill column is never read.
"""

from __future__ import annotations

import math

import torch

INF = float("inf")

#: sparse-exchange payload encodings: "exact" (f32 values, bit-identical
#: to the dense exchange), "bf16" / "u16" (round-up 16-bit value deltas)
PAYLOAD_MODES = ("exact", "bf16", "u16")

_U32 = 0xFFFFFFFF
_BF16_INF = 0x7F80    # the bf16 code of +inf (a fixed point of round-up)
_U16_INF = 65535      # the u16 code of +inf


def payload_plane_words(
    slot_cap: int, use_level: bool, payload: str = "exact"
) -> int:
    """Width, in 32-bit words, of one destination segment of the sparse
    payload: exact ``[values | indices | (levels)]``, quantized
    ``[indices | packed u16 pairs | lo | (scale, u16 only) | (levels)]``."""
    S = slot_cap
    if payload == "exact":
        return (3 if use_level else 2) * S
    if payload not in PAYLOAD_MODES:
        raise ValueError(f"unknown payload mode {payload!r}")
    head = 1 if payload == "bf16" else 2
    return S + (S + 1) // 2 + head + (S if use_level else 0)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """The bits of a float32 tensor as u32 values in int64."""
    return x.view(torch.int32).to(torch.int64) & _U32


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 (taken mod 2^32) as the int32 of the same bits."""
    u = u & _U32
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32)


def _f32_of(u: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 reinterpreted as float32."""
    return _as_i32(u).view(torch.float32)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _decode_bf16(q: torch.Tensor, lo_fin: torch.Tensor) -> torch.Tensor:
    """The receiver's bf16 decode, ``lo + bitcast(q << 16)``; the +inf
    code decodes to +inf."""
    return lo_fin[..., None] + _f32_of(q << 16)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` of float32 tensors rounded once to float32 (a fused
    multiply-add), the same on every device: the product is exact in
    float64, TwoSum gives the float64 sum ``s`` and its error ``e``
    exactly, and the one rounding of ``s`` to float32 that can differ
    from the exact sum's, a tie at the midpoint of two float32 values,
    is broken by the sign of ``e``."""
    p = a.double() * b.double()
    c = c.double()
    s = c + p
    bb = s - c
    e = (c - (s - bb)) + (p - bb)
    r = s.float()
    d = s - r.double()
    inf = torch.full((), INF, dtype=torch.float32, device=r.device)
    other = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & (s == (r.double() + other.double()) * 0.5) & (e != 0)
    return torch.where(tie & ((e > 0) == (d > 0)), other, r)


def _decode_u16(q: torch.Tensor, lo_fin: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """The receiver's u16 decode before its +inf test, ``lo + q·scale``,
    as one fused multiply-add: the JAX package writes a product and a
    sum, and XLA on the CPU contracts them into an FMA, which rounds
    once where the two ops round twice."""
    return _fma_f32(q.to(torch.float32), scale[..., None], lo_fin[..., None])


def _quantize_bf16(val_buf: torch.Tensor, lo_fin: torch.Tensor) -> torch.Tensor:
    """Round-up bf16 codes of ``val_buf - lo_fin`` (int64, u16 values).

    The code is the high half of the delta's f32 bits, bumped by one
    when any low bit is set (the carry into the exponent is IEEE
    round-toward-+inf, and +inf's code is a fixed point).  The sender
    then verifies its code with the receiver's decode: a code that
    would decode below the exact value (the f32 subtraction itself can
    round down) becomes the +inf code, a dropped candidate the repair
    restores."""
    delta = val_buf - lo_fin[..., None]
    bits = _u32_bits(delta)
    q = (bits >> 16) + ((bits & 0xFFFF) != 0).to(torch.int64)
    recon = _decode_bf16(q, lo_fin)
    return torch.where(recon < val_buf, _BF16_INF, q)


def _quantize_u16(val_buf: torch.Tensor, lo_fin: torch.Tensor):
    """Round-up linear u16 codes and the per-segment scale (65535 is
    +inf).  Code 0 is pinned to slots equal to the segment's lower
    bound (they decode to it exactly, so the segment minimum survives);
    the rest are ceil-scaled with a +1 guard, then verified against the
    receiver's decode as in bf16.  Returns (codes int64, scale f32).

    The scale is ``dmax`` times the float32 reciprocal of 65534: the
    JAX package writes ``dmax / 65534``, and XLA's algebraic simplifier
    compiles a division by a constant into that product, which differs
    from the quotient by an ulp for some ``dmax``."""
    fin = torch.isfinite(val_buf)
    delta = val_buf - lo_fin[..., None]
    dmax = torch.where(fin, delta, _f32(0.0, delta)).amax(dim=-1)
    scale = torch.maximum(dmax * _f32(1.0 / 65534.0, dmax), _f32(1e-30, dmax))
    qf = torch.ceil(delta / scale[..., None]) + _f32(1.0, delta)
    q = qf.clamp(0.0, 65534.0).to(torch.int64)
    exact0 = val_buf == lo_fin[..., None]
    q = torch.where(exact0, 0, q)
    recon = _decode_u16(q, lo_fin, scale)
    good = exact0 | (fin & (recon >= val_buf))
    return torch.where(good, q, _U16_INF), scale


def _pack_u16_pairs(q: torch.Tensor, slot_cap: int) -> torch.Tensor:
    """Pack (..., S) u16 codes into (..., ceil(S/2)) u32 words (int64),
    the low code in the low half."""
    H = (slot_cap + 1) // 2
    qp = torch.nn.functional.pad(q, (0, 2 * H - slot_cap))
    return (qp[..., 0::2] | (qp[..., 1::2] << 16)) & _U32


def _unpack_u16_pairs(pairs: torch.Tensor, slot_cap: int) -> torch.Tensor:
    """Inverse of :func:`_pack_u16_pairs`: (..., ceil(S/2)) u32 words
    (int64) -> (..., S) codes."""
    pairs = pairs & _U32
    both = torch.stack([pairs & 0xFFFF, pairs >> 16], dim=-1)
    return both.reshape(pairs.shape[:-1] + (-1,))[..., :slot_cap]


def frontier_caps(
    rows: int,
    width: int,
    n_local: int,
    n_parts: int,
    frontier_cap: int | None = None,
) -> tuple[int, int]:
    """Static (row_cap, slot_cap) for the sparse path: ``row_cap`` (the
    knob F; default R/8) eligible virtual rows compacted per rank per
    superstep, ``slot_cap`` candidate slots per destination rank,
    sized for F·W/(2P) and capped at n_local/2 (beyond that the sparse
    payload never moves fewer words than the dense exchange)."""
    if frontier_cap is None:
        row_cap = max(8, rows // 8)
    else:
        row_cap = max(1, int(frontier_cap))
    row_cap = min(rows, row_cap)
    slot_cap = max(
        1,
        min(n_local // 2, (row_cap * width) // (2 * max(1, n_parts))),
    )
    return row_cap, slot_cap


def grow_frontier_cap(rows: int, cap: int) -> int:
    """Double the row capacity, clamped to the per-rank row count."""
    return min(int(rows), max(1, int(cap)) * 2)


def running_count(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive count of the set entries along the last (non-empty)
    axis, int64, as one scan over the flattened mask less each row's
    start: the card scans a last axis one block a row, which leaves it
    idle for a few long rows (a batch of lanes of a large graph)."""
    flat = torch.cumsum(mask.reshape(-1), 0, dtype=torch.int64)
    flat = flat.reshape(math.prod(mask.shape[:-1]), mask.shape[-1])
    start = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return (flat - start[:, None]).reshape(mask.shape)


def compact_rows(mask: torch.Tensor, cap: int):
    """Compact a (P, R) bool mask into (P, cap) index lists.

    Returns ``(idx, count, overflow)``: ``idx`` (P, cap) int32 holds
    each rank's first ``cap`` set positions in order, padded with the
    sentinel R; ``count`` (P,) the true population; ``overflow`` (P,)
    True where the mask does not fit.
    """
    P_, R = mask.shape
    pos = running_count(mask) - 1
    count = mask.sum(dim=1)
    # set positions past the cap and unset ones land in spill columns,
    # cap + their row (module docstring)
    target = torch.where(mask & (pos < cap), pos,
                         torch.arange(cap, cap + R, device=mask.device))
    rows = torch.arange(R, dtype=torch.int32, device=mask.device)
    idx = torch.full((P_, cap + R), R, dtype=torch.int32, device=mask.device)
    idx.scatter_(1, target, rows.expand(P_, R))
    return idx[:, :cap], count.to(torch.int32), count > cap


def bucket_slots(mask: torch.Tensor, slot_cap: int):
    """Per-destination slot of every candidate.

    ``mask`` (..., P, n_local) marks real candidates per destination
    rank.  Returns ``(slot, overflow)``: ``slot`` int64 gives each
    candidate its position in destination p's buffer, and a
    non-candidate or a candidate past the cap a spill position of its
    own, ``slot_cap`` + its index (module docstring); ``overflow`` (...,)
    is True where some destination holds more than ``slot_cap``
    candidates.
    """
    n = mask.shape[-1]
    pos = running_count(mask) - 1
    overflow = (pos[..., -1] + 1).amax(dim=-1) > slot_cap
    slot = torch.where(mask & (pos < slot_cap), pos,
                       torch.arange(slot_cap, slot_cap + n, device=mask.device))
    return slot, overflow


def scatter_plane(vals: torch.Tensor, slot: torch.Tensor, slot_cap: int, fill):
    """Scatter (..., n_local) values into their (..., slot_cap) buffer
    positions; the spill positions of :func:`bucket_slots` are dropped."""
    buf = torch.full(vals.shape[:-1] + (slot_cap + vals.shape[-1],), fill,
                     dtype=vals.dtype, device=vals.device)
    buf.scatter_(-1, slot, vals)
    return buf[..., :slot_cap]


def sparse_payload(C: torch.Tensor, extra_planes, n_parts: int,
                   slot_cap: int, worst: float, payload: str = "exact"):
    """The all-to-all payload of every source rank.

    ``C`` (P_src, n_pad) holds each rank's candidates for all padded
    vertices; ``extra_planes`` is a list of ``(array, fill)`` pairs of
    (P_src, n_pad) f32 attributes riding along (the KLA level).
    Returns ``(payload, overflow)``: ``payload`` (P_src, P_dst, K) and
    ``overflow`` (P_src,) bool.  Empty slots carry ``worst`` and the
    index sentinel n_local.

    ``payload="exact"``: f32 ``[values | bitcast-i32 indices |
    extra...]``, bit-identical to the dense exchange.  ``"bf16"`` /
    ``"u16"``: int32 words ``[indices | packed 16-bit codes of value -
    lo | lo (+ scale) | bitcast extra...]`` with ``lo`` each segment's
    least value; indices stay full width.  Min-reduce semirings with
    ``worst`` = +inf only (the engine enforces it).
    """
    P_src = C.shape[0]
    n_local = C.shape[1] // n_parts
    C3 = C.reshape(P_src, n_parts, n_local)
    slot, overflow = bucket_slots(C3 != worst, slot_cap)
    lidx = torch.arange(n_local, dtype=torch.int32, device=C.device)
    idx_buf = scatter_plane(lidx.expand_as(slot), slot, slot_cap, n_local)
    val_buf = scatter_plane(C3, slot, slot_cap, worst)
    extra = [
        scatter_plane(arr.reshape(P_src, n_parts, n_local), slot, slot_cap,
                      fill)
        for arr, fill in extra_planes
    ]
    if payload == "exact":
        planes = [val_buf, idx_buf.view(torch.float32)] + extra
        return torch.cat(planes, dim=-1), overflow
    if payload not in PAYLOAD_MODES:
        raise ValueError(f"unknown payload mode {payload!r}")
    lo = val_buf.amin(dim=-1)  # each destination segment's lower bound
    lo_fin = torch.where(torch.isfinite(lo), lo, _f32(0.0, lo))
    if payload == "bf16":
        q = _quantize_bf16(val_buf, lo_fin)
        head = [lo]
    else:
        q, scale = _quantize_u16(val_buf, lo_fin)
        head = [lo, scale]
    words = [
        idx_buf,
        _as_i32(_pack_u16_pairs(q, slot_cap)),
        torch.stack(head, dim=-1).view(torch.int32),
    ] + [plane.view(torch.int32) for plane in extra]
    return torch.cat(words, dim=-1), overflow


def unpack_combine(recv: torch.Tensor, n_local: int, slot_cap: int,
                   is_min: bool, worst: float, has_level: bool,
                   payload: str = "exact"):
    """Owner-side combine of received payloads.

    ``recv`` (P_dst, P_src, K): what every source rank sent each
    destination.  Returns ``(mine, mineL)``: (P_dst, n_local) combined
    candidates and, when ``has_level``, the minimum level among the
    candidates matching the winning value; ``mineL`` is None otherwise.
    Quantized codes decode with the expression the sender verified
    them against, so each decoded value is the sender's reconstruction:
    >= the exact candidate, equal at each segment's lower bound.
    """
    S = slot_cap
    P_dst = recv.shape[0]
    if payload == "exact":
        val = recv[..., :S]
        idx = recv[..., S : 2 * S].contiguous().view(torch.int32)
        lvl_base = 2 * S
    else:
        if payload not in PAYLOAD_MODES:
            raise ValueError(f"unknown payload mode {payload!r}")
        H = (S + 1) // 2
        idx = recv[..., :S]
        q = _unpack_u16_pairs(recv[..., S : S + H].to(torch.int64), S)
        lo = recv[..., S + H].contiguous().view(torch.float32)
        lo_fin = torch.where(torch.isfinite(lo), lo, _f32(0.0, lo))
        if payload == "bf16":
            val = _decode_bf16(q, lo_fin)
            lvl_base = S + H + 1
        else:
            scale = recv[..., S + H + 1].contiguous().view(torch.float32)
            val = torch.where(q == _U16_INF, INF, _decode_u16(q, lo_fin, scale))
            lvl_base = S + H + 2
    val = val.reshape(P_dst, -1)
    idx = idx.reshape(P_dst, -1).to(torch.int64)
    # every empty slot (index n_local, value worst) takes a spill column
    # of its own, n_local + its position (module docstring)
    N = idx.shape[1]
    spill = torch.arange(n_local, n_local + N, device=recv.device)
    idx = torch.where(idx == n_local, spill, idx)
    buf = torch.full((P_dst, n_local + N), worst, dtype=torch.float32,
                     device=recv.device)
    buf.scatter_reduce_(1, idx, val, "amin" if is_min else "amax")
    mine = buf[:, :n_local]
    if not has_level:
        return mine, None
    lvl = recv[..., lvl_base : lvl_base + S]
    if payload != "exact":
        lvl = lvl.contiguous().view(torch.float32)
    lvl = lvl.reshape(P_dst, -1)
    win = val == torch.gather(buf, 1, idx)  # empty slots: worst == worst, lvl inf
    lbuf = torch.full((P_dst, n_local + N), INF, dtype=torch.float32,
                      device=recv.device)
    lbuf.scatter_reduce_(1, idx, torch.where(win, lvl, INF), "amin")
    return mine, lbuf[:, :n_local]
