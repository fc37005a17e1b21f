"""Must-move bytes and operations of the port's kernels, one function an
entry, each returning ``(bytes, operations)`` for one call at the sizes
its data gives.  Each input is read once, each output written once;
where the work depends on the data (the live rows of a frontier, the
rows of x a sparse product reads), the caller counts what its data
needs.  :func:`repro_torch.roofline.model.bound` turns a pair into the
least time the card could take; a kernel and any other implementation
of the same function are held to the same pair.
"""

from __future__ import annotations


def fused_superstep_traffic(live: int, width: int, n_src: int,
                            n_out: int) -> tuple[int, int]:
    """``fused_superstep``: the listed row ids and their sources, the
    col+wgt strips of ``live`` rows, ``n_src`` distinct source
    distances, one write of the (n_out+1,) output, the count."""
    nbytes = 4 * (2 * live + 2 * live * width + n_src + n_out + 1) + 4
    return nbytes, live * width


def relax_push_gather_traffic(live: int, width: int, n_src: int,
                              row_cap: int) -> tuple[int, int]:
    """``relax_push_gather``: the listed row ids and their sources, the
    wgt strips of ``live`` rows, the source distances, the (row_cap, W)
    output, the count."""
    nbytes = 4 * (2 * live + live * width + n_src + row_cap * width) + 4
    return nbytes, live * width


def fused_superstep_batch_traffic(live: int, rows_read: int, width: int,
                                  n_src: int, lanes: int,
                                  n_out: int) -> tuple[int, int]:
    """The batched ``fused_superstep`` entry: ``live`` listed row ids
    over all lanes, the ``rows_read`` distinct rows' sources and col+wgt
    strips (a row two lanes of one rank list is read once), ``n_src``
    source distances summed over the lanes, one write of each lane's
    output, the counts."""
    nbytes = 4 * (live + rows_read * (1 + 2 * width) + n_src
                  + lanes * (n_out + 1) + lanes)
    return nbytes, live * width


def relax_push_gather_batch_traffic(live: int, rows_read: int, width: int,
                                    n_src: int, lanes: int,
                                    row_cap: int) -> tuple[int, int]:
    """The batched ``relax_push_gather`` entry: as the fused batch, with
    wgt strips only and the (lanes, row_cap, W) output."""
    nbytes = 4 * (live + rows_read * (1 + width) + n_src
                  + lanes * row_cap * width + lanes)
    return nbytes, live * width


def relax_ell_traffic(rows: int, width: int, n: int) -> tuple[int, int]:
    """``relax_ell``: the in-ELL's col+wgt, the (n+1,) distances, the
    (rows,) row minima; an add and a min a slot."""
    return 4 * (2 * rows * width + n + 1 + rows), 2 * rows * width


def attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs the attention visits: each causal row i sees
    keys up to i + Sk - Sq."""
    return Sq * (Sk - Sq) + Sq * (Sq + 1) // 2 if causal else Sq * Sk


def flash_attention_traffic(B: int, Hq: int, Hkv: int, Sq: int, Sk: int,
                            D: int, causal: bool,
                            itemsize: int) -> tuple[int, int]:
    """``flash_attention``: q and out (B, Hq, Sq, D), k and v (B, Hkv,
    Sk, D); 4·D operations a visited pair (two products)."""
    nbytes = itemsize * 2 * (B * Hq * Sq * D + B * Hkv * Sk * D)
    return nbytes, 4 * B * Hq * D * attention_pairs(Sq, Sk, causal)


def flash_attention_bwd_traffic(B: int, Hq: int, Hkv: int, Sq: int, Sk: int,
                                D: int, causal: bool,
                                itemsize: int) -> tuple[int, int]:
    """``flash_attention_bwd``: q, out, dout and dq (B, Hq, Sq, D), k, v,
    dk and dv (B, Hkv, Sk, D), lse (B, Hq, Sq) f32; 10·D operations a
    visited pair (S and dP recomputed, dV, dK and dQ: five products)."""
    nbytes = itemsize * 4 * (B * Hq * Sq * D + B * Hkv * Sk * D) + 4 * B * Hq * Sq
    return nbytes, 10 * B * Hq * D * attention_pairs(Sq, Sk, causal)


def embedding_bag_traffic(rows_touched: int, B: int, L: int,
                          d: int) -> tuple[int, int]:
    """``embedding_bag``: the table rows a nonzero weight touches, the
    (B, L) indices and weights, the (B, d) output; a multiply-add a
    slot and feature."""
    return 4 * (rows_touched * d + 2 * B * L + B * d), 2 * B * L * d


def spmm_ell_traffic(rows: int, width: int, rows_read: int, d: int,
                     nnz: int, op: str) -> tuple[int, int]:
    """``spmm_ell``'s row entry: col+wgt, the rows of x the op reads,
    the (rows, d) output; a multiply-add (sum) or a compare (max) a
    nonzero weight and feature."""
    nbytes = 4 * (2 * rows * width + rows_read * d + rows * d)
    return nbytes, (2 if op == "sum" else 1) * nnz * d


def spmm_ell_vertex_traffic(m: int, rows_read: int, n: int, d: int,
                            nnz: int | None = None) -> tuple[int, int]:
    """``spmm_ell``'s vertex sum: the wgt of the ``m`` live slots, the
    col of the ``nnz`` (default m) of nonzero weight and the
    ``rows_read`` rows of x these name, once each, row_ptr (int64) and
    deg, the (n, d) output; a multiply-add a slot of nonzero weight and
    feature (a slot of weight 0 adds nothing, so the function needs
    neither its col nor its row)."""
    nnz = m if nnz is None else nnz
    nbytes = 4 * m + 4 * nnz + 4 * rows_read * d + 8 * (n + 1) + 4 * n + 4 * n * d
    return nbytes, 2 * nnz * d


def fused_kernel_bytes(row_cap: int, width: int, n_local: int,
                       n_pad: int) -> int:
    """Closed-form bytes of one ``fused_superstep`` call at its static
    capacities (the JAX package's formula): every tile crosses device
    memory once: col + wgt strips of ``row_cap`` rows, one row_src word
    a row, the (n_local+1,) distances read once, the (n_pad+1,) output
    written once, the row list and the count."""
    words = (
        row_cap * width * 2   # col + wgt strips
        + row_cap             # row_src gathers
        + (n_local + 1)       # distances, read once
        + (n_pad + 1)         # output, one write
        + row_cap + 1         # row list + count
    )
    return 4 * words


def push_gather_bytes(row_cap: int, width: int, n_local: int) -> int:
    """Closed-form bytes of one ``relax_push_gather`` call at its static
    capacities, as :func:`fused_kernel_bytes`: wgt strips of ``row_cap``
    rows, one row_src word a row, the distances read once, the
    (row_cap, W) candidates written once, the row list and the count."""
    words = (
        row_cap * width       # wgt strips
        + row_cap             # row_src gathers
        + (n_local + 1)       # distances, read once
        + row_cap * width     # candidates, one write
        + row_cap + 1         # row list + count
    )
    return 4 * words


def frontier_call_traffic(kernel: str, shape: dict) -> tuple[int, int]:
    """(bytes, operations) of one frontier-op call from the sizes its
    ``kernels/_lib.py::kernel_call`` names: ``lanes`` × the closed form
    of one lane; one operation a slot of the row capacity."""
    lanes, F, W = shape["lanes"], shape["rows"], shape["width"]
    if kernel.startswith("fused_superstep"):
        one = fused_kernel_bytes(F, W, shape["n_local"], shape["n_out"])
    else:
        one = push_gather_bytes(F, W, shape["n_local"])
    return lanes * one, lanes * F * W
