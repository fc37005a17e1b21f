"""Frontier compaction and the sparse candidate exchange, exact payload.

* :func:`compact_rows` — the eligible virtual-row mask of every rank
  compacted into a fixed-capacity index list (cap F) with an overflow
  flag for the dense fallback.  ``torch.nonzero`` has no static size,
  so this is a running count and a scatter into the cap: no host sync.
* :func:`bucket_slots` / :func:`scatter_plane` — per-destination-rank
  slotting of candidates into fixed-capacity (idx, val) buffers.
* :func:`sparse_payload` / :func:`unpack_combine` — the payload of one
  all-to-all, ``[f32 values | bitcast-i32 indices | (f32 levels)]``
  per destination, and the owner-side combine back into a dense array.

Every function takes a leading rank axis: the engine stacks its P
ranks on one device.  Capacities are static Python ints.

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

#: sparse-exchange payload encodings; only "exact" is ported
PAYLOAD_MODES = ("exact", "bf16", "u16")


def payload_plane_words(
    slot_cap: int, use_level: bool, payload: str = "exact"
) -> int:
    """Width, in 32-bit words, of one destination segment of the sparse
    payload (the quantized layouts are counted for byte accounting of
    parsed specs, as the JAX package counts them)."""
    S = slot_cap
    if payload == "exact":
        return (3 if use_level else 2) * S
    if payload not in PAYLOAD_MODES:
        raise ValueError(f"unknown payload mode {payload!r}")
    head = 1 if payload == "bf16" else 2
    return S + (S + 1) // 2 + head + (S if use_level else 0)


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
                   slot_cap: int, worst: float):
    """The all-to-all payload of every source rank.

    ``C`` (P_src, n_pad) holds each rank's candidates for all padded
    vertices; ``extra_planes`` is a list of ``(array, fill)`` pairs of
    (P_src, n_pad) f32 attributes riding along (the KLA level).
    Returns ``(payload, overflow)``: ``payload`` (P_src, P_dst, K·S)
    f32 laid out ``[values | bitcast-i32 indices | extra...]`` with
    empty slots carrying ``worst`` and the index sentinel n_local;
    ``overflow`` (P_src,) bool.
    """
    P_src = C.shape[0]
    n_local = C.shape[1] // n_parts
    C3 = C.reshape(P_src, n_parts, n_local)
    slot, overflow = bucket_slots(C3 != worst, slot_cap)
    lidx = torch.arange(n_local, dtype=torch.int32, device=C.device)
    idx_buf = scatter_plane(lidx.expand_as(slot), slot, slot_cap, n_local)
    planes = [
        scatter_plane(C3, slot, slot_cap, worst),
        idx_buf.view(torch.float32),
    ]
    for arr, fill in extra_planes:
        planes.append(
            scatter_plane(arr.reshape(P_src, n_parts, n_local), slot,
                          slot_cap, fill)
        )
    return torch.cat(planes, dim=-1), overflow


def unpack_combine(recv: torch.Tensor, n_local: int, slot_cap: int,
                   is_min: bool, worst: float, has_level: bool):
    """Owner-side combine of received payloads.

    ``recv`` (P_dst, P_src, K·S): what every source rank sent each
    destination.  Returns ``(mine, mineL)``: (P_dst, n_local) combined
    candidates and, when ``has_level``, the minimum level among the
    candidates matching the winning value; ``mineL`` is None otherwise.
    """
    S = slot_cap
    P_dst = recv.shape[0]
    val = recv[..., :S].reshape(P_dst, -1)
    idx = recv[..., S : 2 * S].contiguous().view(torch.int32)
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
    lvl = recv[..., 2 * S : 3 * S].reshape(P_dst, -1)
    win = val == torch.gather(buf, 1, idx)  # empty slots: worst == worst, lvl inf
    lbuf = torch.full((P_dst, n_local + N), INF, dtype=torch.float32,
                      device=recv.device)
    lbuf.scatter_reduce_(1, idx, torch.where(win, lvl, INF), "amin")
    return mine, lbuf[:, :n_local]
