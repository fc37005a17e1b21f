"""The self-stabilizing SSSP kernel itself (paper Algorithm 1, Huang &
Lin 2002) under a synchronous demon:

    R0:  d(r) ≠ 0                     → d(r) := 0
    R1:  d(i) ≠ min_j (d(j) + w(i,j)) → d(i) := min_j (d(j) + w(i,j))

R1 *replaces* the state (it can raise d(i)), which is what lets the
rule converge from an arbitrary corrupted state.  The engine is the
paper's stabilizing derivation of this kernel; this sweep is its
semantic ground truth, and its hot loop is the ``relax_ell`` kernel
(pull-mode min-plus over in-edges).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.formats import Graph, coo_to_csr, graph_fingerprint
from repro_torch.graph.partition import chunk_fat_rows
from repro_torch.kernels import relax_rows

# transpose-ELL memo keyed by graph identity + content fingerprint (in-
# place edge mutation invalidates) + width; bounded LRU
_IN_ELL_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_IN_ELL_CACHE_SIZE = 8


def in_ell(g: Graph, width: int | None = None, *, cache: bool = True):
    """ELL over *in*-edges (transpose), fat rows chunked: numpy
    (row_dst, col, wgt), where row_dst maps virtual rows to vertices
    and padding is ``col = n``, ``wgt = +inf``.  Memoized per (graph
    content, width); ``cache=False`` forces a rebuild."""
    key = (id(g), graph_fingerprint(g), width)
    if cache:
        hit = _IN_ELL_CACHE.get(key)
        if hit is not None:
            _IN_ELL_CACHE.move_to_end(key)
            return hit
    csr = coo_to_csr(Graph(g.n, g.dst, g.src, g.weight, name=g.name + "^T"))
    w = width or max(1, min(64, csr.max_degree()))
    ell = chunk_fat_rows(csr, w, pad_col=g.n)
    if cache:
        _IN_ELL_CACHE[key] = ell
        if len(_IN_ELL_CACHE) > _IN_ELL_CACHE_SIZE:
            _IN_ELL_CACHE.popitem(last=False)
    return ell


def sweep_step(d: torch.Tensor, row_dst: torch.Tensor, col: torch.Tensor,
               wgt: torch.Tensor, source: int) -> torch.Tensor:
    """One synchronous R0/R1 application to the (n,) state ``d``;
    ``row_dst`` is int64 on ``d``'s device."""
    n = d.shape[0]
    inf = torch.full((1,), float("inf"), dtype=torch.float32, device=d.device)
    row_min = relax_rows(torch.cat([d, inf]), col, wgt)  # (R,)
    # combine the virtual rows of one vertex (fat-row chunking)
    new = torch.full((n + 1,), float("inf"), dtype=torch.float32,
                     device=d.device)
    new = new.scatter_reduce_(0, row_dst, row_min, "amin")[:n]
    new[source] = 0.0  # rule R0
    return new


def synchronous_sweep(
    g: Graph,
    source: int,
    d0: np.ndarray,
    iters: int,
    *,
    ell: tuple | None = None,
    device=None,
) -> np.ndarray:
    """Run up to ``iters`` synchronous applications of R0/R1 from state
    ``d0``, stopping when the state is stable.  ``ell`` accepts a
    precomputed ``in_ell(g)`` triple; ``device=None`` means the card."""
    dev = resolve_device(device)
    row_dst, col, wgt = ell if ell is not None else in_ell(g)
    row_dst = torch.as_tensor(row_dst, device=dev).to(torch.int64)
    col = torch.as_tensor(col, device=dev)
    wgt = torch.as_tensor(wgt, device=dev)
    d = torch.as_tensor(np.asarray(d0, np.float32), device=dev)
    for _ in range(iters):
        d_next = sweep_step(d, row_dst, col, wgt, int(source))
        if torch.equal(d_next, d):
            break
        d = d_next
    return d.cpu().numpy()
