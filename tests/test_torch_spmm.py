"""The port's ELL SpMM op and neighbour ELL against the JAX package.

``aggregate_neighbors`` on CPU tensors (the plain torch version, what a
CPU tensor takes) against the reference Pallas kernel in interpret mode
on the same numpy inputs, at the reference kernel test's shapes plus
the GIN cell widths d = 100 (ogb_products) and d = 1433 (full_graph_sm):
``max`` bit-identical (max does not depend on order), ``sum`` within
1e-5 of max |ref| (f32 sums of W products in another order).  The
vertex sum's plain version (``neighbor_sum`` on the CPU) against the
reference kernel's rows combined in row order, and against the
reference's segment sum, within the same 1e-5; and bit for bit against
its stated order written out in numpy.  The CUDA kernels are held
against the same plain versions on the card in test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm_ell import aggregate_neighbors as ref_aggregate
from repro.models.gnn import layers as ref_layers
from repro_torch.core.selfstab import in_ell
from repro_torch.graph import Graph, rmat1, small_world_graph
from repro_torch.kernels import (
    aggregate_neighbors,
    spmm_ell_cuda,
    spmm_ell_ref,
    spmm_ell_vertex_cuda,
    spmm_ell_vertex_ref,
)
from repro_torch.kernels.spmm_ell.kernel import (
    _index_range,
    check_spmm_args,
    check_vertex_args,
    vertex_plan,
)
from repro_torch.models.gnn import (
    build_neighbor_ell,
    gather_src,
    neighbor_ell,
    neighbor_sum,
    scatter_sum,
)

SUM_REL_TOL = 1e-5


def spmm_case(n_x, R, W, d, seed):
    """The reference kernel test's inputs: normal x with a zero last row,
    uniform columns, weights 0 on ~30% of the slots."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_x, d)).astype(np.float32)
    x[n_x - 1] = 0
    col = rng.integers(0, n_x, (R, W)).astype(np.int32)
    wgt = ((rng.random((R, W)) > 0.3) * rng.random((R, W))).astype(np.float32)
    return x, col, wgt


def port(x, col, wgt, op, impl="pallas_interpret"):
    return aggregate_neighbors(torch.tensor(x), torch.tensor(col), torch.tensor(wgt),
                               op=op, impl=impl).numpy()


def reference(x, col, wgt, op):
    return np.asarray(ref_aggregate(jnp.asarray(x), jnp.asarray(col), jnp.asarray(wgt),
                                    op=op, impl="pallas_interpret"))


def assert_matches(out, ref, op):
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.float32
    if op == "max":  # bit for bit, NaN where NaN (its payload aside)
        nan = np.isnan(ref)
        assert np.array_equal(np.isnan(out), nan)
        assert np.array_equal(np.where(nan, 0, out).view(np.int32),
                              np.where(nan, 0, ref).view(np.int32))
    else:
        err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
        assert err <= SUM_REL_TOL * scale, (err, scale)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n_x,R,W,d", [
    (100, 64, 4, 32),
    (257, 300, 12, 96),     # non-aligned everything
    (64, 128, 8, 128),
    (500, 200, 16, 100),    # ogb_products width
    (300, 40, 8, 1433),     # full_graph_sm width
])
def test_aggregate_matches_reference_kernel(op, n_x, R, W, d):
    x, col, wgt = spmm_case(n_x, R, W, d, seed=n_x + R + W + d)
    ref = reference(x, col, wgt, op)
    assert_matches(port(x, col, wgt, op), ref, op)
    assert_matches(port(x, col, wgt, op, impl="ref"), ref, op)


def test_max_nan_row_and_all_padding_row():
    """A NaN in a gathered row wins (jnp.max propagates it; fmaxf would
    drop it); a NaN behind weight 0 is masked; a row whose weights are
    all 0 gives -inf."""
    x, col, wgt = spmm_case(64, 32, 8, 40, seed=3)
    x[5, [0, 7, 39]] = np.nan
    col[0, :] = 5                # row 0 reads the NaN row, weights > 0
    wgt[0, :] = 0.5
    col[1, :] = 5                # row 1 reads it behind weight 0 only
    wgt[1, :] = 0.0
    wgt[1, 3] = 1.0
    col[1, 3] = 9
    wgt[2, :] = 0.0              # row 2: all padding
    col[2, :] = 63
    col[3, 4] = 5                # row 3: the NaN row among others
    wgt[3, 4] = 0.25
    ref = reference(x, col, wgt, "max")
    out = port(x, col, wgt, "max")
    assert_matches(out, ref, "max")
    assert np.isnan(out[0, [0, 7, 39]]).all() and not np.isnan(out[0, 1:7]).any()
    assert not np.isnan(out[1]).any() and np.array_equal(out[1], x[9])
    assert np.all(out[2] == -np.inf)
    assert np.isnan(out[3, [0, 7, 39]]).all()
    # the sum keeps x * 0 for a NaN behind weight 0, as the reference does
    s = port(x, col, wgt, "sum")
    np.testing.assert_array_equal(np.isnan(s), np.isnan(reference(x, col, wgt, "sum")))


def test_impl_and_op_values():
    x, col, wgt = spmm_case(50, 20, 4, 8, seed=1)
    tx, tc, tw = torch.tensor(x), torch.tensor(col), torch.tensor(wgt)
    for impl in ("ref", "pallas", "pallas_interpret"):
        assert torch.equal(aggregate_neighbors(tx, tc, tw, op="max", impl=impl),
                           spmm_ell_ref(tx, tc, tw, "max"))
    with pytest.raises(ValueError, match="impl"):
        aggregate_neighbors(tx, tc, tw, impl="triton")
    with pytest.raises(ValueError, match="op"):
        aggregate_neighbors(tx, tc, tw, op="mean")


def test_cuda_wrapper_checks_before_launching():
    """The wrapper's argument checks run before any CUDA call: wrong
    dtypes, shapes and ops raise here, and a CPU tensor is refused (the
    wrapper never falls back to the plain version)."""
    x, col, wgt = (torch.tensor(a) for a in spmm_case(50, 20, 4, 8, seed=2))
    with pytest.raises(ValueError, match="op"):
        check_spmm_args(x, col, wgt, "mean")
    with pytest.raises(ValueError, match="x must be 2-D float32"):
        check_spmm_args(x.double(), col, wgt, "sum")
    with pytest.raises(ValueError, match="col must be 2-D int32"):
        check_spmm_args(x, col.long(), wgt, "sum")
    with pytest.raises(ValueError, match="wgt must be float32 of col's shape"):
        check_spmm_args(x, col, wgt[:, :3].contiguous(), "sum")
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_ell_cuda(x, col, wgt)


def test_index_range_is_read_again_after_a_write():
    """The wrapper's (min, max) of col is remembered for one tensor only
    while that tensor is unwritten: an in-place write, another tensor or
    a view reads it again."""
    col = torch.tensor(spmm_case(50, 20, 4, 8, seed=3)[1])
    lo, hi = int(col.min()), int(col.max())
    assert _index_range(col) == (lo, hi)
    col[0, 0] = 77
    assert _index_range(col) == (lo, 77)
    col[1, 0] = -1
    assert _index_range(col) == (-1, 77)
    other = col.clone()
    other[0, 0] = other[1, 0] = 5
    assert _index_range(other) == (int(other.min()), int(other.max()))
    assert _index_range(col[2:]) == (int(col[2:].min()), int(col[2:].max()))


# ---------------------------------------------------------------- #
# the neighbour ELL


def rows_of(ell):
    """The vertex of each ELL row, as the in-ELL lists it (row_dst)."""
    row_ptr = ell.row_ptr.numpy()
    return np.repeat(np.arange(row_ptr.shape[0] - 1), np.diff(row_ptr))


def edges_of(g, mask_seed=None):
    src, dst = torch.tensor(g.src), torch.tensor(g.dst)
    mask = np.ones(g.m, bool)
    if mask_seed is not None:
        mask = np.random.default_rng(mask_seed).random(g.m) > 0.25
    return src, dst, torch.tensor(mask)


@pytest.mark.parametrize("g", [rmat1(8, seed=3), small_world_graph(300, seed=2)],
                         ids=["rmat1_s8", "smallworld_300"])
def test_neighbor_ell_is_the_in_ell(g):
    """Slots, chunking and row order equal the SSSP in-ELL's; the
    weights are the edge mask, padding 0."""
    src, dst, mask = edges_of(g)
    ell = build_neighbor_ell(src, dst, mask, g.n)
    row_dst, col, wgt = in_ell(g, cache=False)
    assert np.array_equal(rows_of(ell), row_dst)
    assert np.array_equal(ell.col.numpy(), col)
    assert np.array_equal(ell.wgt.numpy(), np.isfinite(wgt).astype(np.float32))
    assert ell.col.dtype == torch.int32 and ell.wgt.dtype == torch.float32
    # the vertex sum's view of it: each vertex's first row and live slots
    assert np.array_equal(ell.row_ptr.numpy(), np.searchsorted(row_dst, np.arange(g.n + 1)))
    live = np.isfinite(wgt).sum(axis=1)
    assert np.array_equal(ell.deg.numpy(), np.bincount(row_dst, weights=live, minlength=g.n))
    assert ell.row_ptr.dtype == torch.int64 and ell.deg.dtype == torch.int32


def test_neighbor_sum_splits_fat_vertices():
    """A vertex of in-degree 150 takes three rows of W = 64; with W = 4
    every vertex of degree > 4 is split.  The sum over the ELL rows
    equals the segment sum, masked edges counting 0."""
    rng = np.random.default_rng(0)
    n = 40
    src = rng.integers(0, n, 400).astype(np.int32)
    dst = rng.integers(0, n, 400).astype(np.int32)
    dst[:150] = 7
    g = Graph(n, src, dst, np.ones(400, np.float32))
    s, d, mask = edges_of(g, mask_seed=1)
    x = torch.tensor(rng.normal(size=(n, 6)).astype(np.float32))
    ref = scatter_sum(gather_src(x, s) * mask.float()[:, None], d, n)
    for width, fat_rows in ((None, 3), (4, None)):
        ell = build_neighbor_ell(s, d, mask, n, width)
        R, W = ell.col.shape
        assert W == (width or 64) and R > n
        if fat_rows:
            assert int(ell.row_ptr[8] - ell.row_ptr[7]) == fat_rows
        torch.testing.assert_close(neighbor_sum(ell, x), ref, rtol=1e-6, atol=1e-5)


def test_neighbor_ell_memo_and_checks():
    g = rmat1(7, seed=1)
    src, dst, mask = edges_of(g)
    a = neighbor_ell(src, dst, mask, g.n)
    assert neighbor_ell(src, dst, mask, g.n) is a
    mask[0] = False  # an in-place update bumps the version: rebuilt
    b = neighbor_ell(src, dst, mask, g.n)
    assert b is not a and float(b.wgt.sum()) == float(a.wgt.sum()) - 1
    with pytest.raises(ValueError, match="lie in"):
        build_neighbor_ell(src, dst, mask, int(dst.max()))


def test_neighbor_ell_memo_keeps_only_the_last_graph():
    g1, g2 = rmat1(7, seed=1), rmat1(6, seed=2)
    first, second = edges_of(g1), edges_of(g2)
    a = neighbor_ell(*first, g1.n)
    b = neighbor_ell(*second, g2.n)
    assert neighbor_ell(*second, g2.n) is b
    again = neighbor_ell(*first, g1.n)  # evicted by the second graph: rebuilt
    assert again is not a
    assert torch.equal(again.col, a.col) and torch.equal(again.wgt, a.wgt)


# ---------------------------------------------------------------- #
# the vertex sum (GIN's neighbour sum over the neighbour ELL)


def fat_vertex_graph(n=50, width=None):
    """test_neighbor_sum_splits_fat_vertices's graph: a vertex of
    in-degree 150 among 400 edges on 40 vertices; vertices 40 .. n-1
    are isolated."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 40, 400).astype(np.int32)
    dst = rng.integers(0, 40, 400).astype(np.int32)
    dst[:150] = 7
    return Graph(n, src, dst, np.ones(400, np.float32))


def vertex_case(g, d, seed, width=None):
    """numpy x, edge mask (a quarter of the edges masked) and the port's
    neighbour ELL of g."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g.n, d)).astype(np.float32)
    mask = rng.random(g.m) > 0.25
    ell = build_neighbor_ell(torch.tensor(g.src), torch.tensor(g.dst), torch.tensor(mask),
                             g.n, width)
    return x, mask, ell


def rows_in_order(rows, row_dst, n):
    """out[v] = ((0 + rows[r0]) + rows[r1]) + ... over v's rows in order."""
    out = np.zeros((n, rows.shape[1]), np.float32)
    for r, v in enumerate(row_dst):
        out[v] = out[v] + rows[r]
    return out


def reference_vertex_sums(g, x, mask, ell):
    """The JAX package's two routes: its spmm_ell kernel (interpret mode)
    over the ELL rows, with the zero row it reads padding from, then the
    rows combined in row order; and its segment sum over the edges."""
    x_pad = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
    rows = reference(x_pad, ell.col.numpy(), ell.wgt.numpy(), "sum")
    by_rows = rows_in_order(rows, rows_of(ell), g.n)
    msgs = ref_layers.gather_src(jnp.asarray(x), jnp.asarray(g.src)) * \
        jnp.asarray(mask, jnp.float32)[:, None]
    segment = np.asarray(ref_layers.scatter_sum(msgs, jnp.asarray(g.dst), g.n))
    return by_rows, segment


def port_vertex_sum(x, ell):
    return neighbor_sum(ell, torch.tensor(x)).numpy()


TINY = ["tiny_rmat1", "tiny_rmat2", "tiny_grid", "tiny_smallworld"]


@pytest.mark.parametrize("graph", [*TINY, "rmat1_s8", "fat_w4", "fat_w64"])
def test_vertex_sum_matches_reference(tiny_graphs, graph):
    """On the shared tiny graphs, rmat1 scale 8 and the fat-vertex graph
    (W 4: every vertex of in-degree > 4 split; W 64: the hub in 3 rows),
    with masked edges and isolated vertices (three appended to each
    graph)."""
    width = None
    if graph in TINY:
        g = tiny_graphs[TINY.index(graph)]
    elif graph == "rmat1_s8":
        g = rmat1(8, seed=0)
    else:
        g, width = fat_vertex_graph(), int(graph[len("fat_w"):])
    g = Graph(g.n + 3, g.src, g.dst, g.weight)
    x, mask, ell = vertex_case(g, 100, seed=g.n + g.m, width=width)
    assert int((ell.deg == 0).sum()) >= 3
    out = port_vertex_sum(x, ell)
    for ref in reference_vertex_sums(g, x, mask, ell):
        assert_matches(out, ref, "sum")


def test_vertex_sum_nan_where_the_reference_has_it():
    """An inf in x behind a masked edge gives NaN (inf * 0) in the
    destination's sum, as in both reference routes; behind a live edge
    it gives inf."""
    g = fat_vertex_graph()
    x, mask, ell = vertex_case(g, 40, seed=5)
    masked = np.flatnonzero(~mask)
    u = int(g.src[masked[0]])
    x[u, [0, 3, 39]] = np.inf
    out = port_vertex_sum(x, ell)
    assert np.isnan(out[int(g.dst[masked[0]]), [0, 3, 39]]).all()
    for ref in reference_vertex_sums(g, x, mask, ell):
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        assert np.array_equal(np.isinf(out), np.isinf(ref))
        fin = np.isfinite(ref)
        assert np.abs(out[fin] - ref[fin]).max() <= SUM_REL_TOL * np.abs(ref[fin]).max()


def vertex_sums_in_order(x, col, wgt, row_ptr, deg):
    """The vertex sum's order written out in numpy f32: each row's live
    slots in slot order, then each vertex's rows in row order, from +0,
    every product and sum rounded."""
    W = col.shape[1]
    want = np.zeros((deg.shape[0], x.shape[1]), np.float32)
    for v in range(deg.shape[0]):
        acc = np.zeros(x.shape[1], np.float32)
        for r in range(row_ptr[v], row_ptr[v + 1]):
            row = np.zeros(x.shape[1], np.float32)
            for s in range(max(0, min(W, deg[v] - (r - row_ptr[v]) * W))):
                row = row + x[col[r, s]] * wgt[r, s]
            acc = acc + row
        want[v] = acc
    return want


@pytest.mark.parametrize("width", [4, 64])
def test_vertex_sum_ref_is_its_stated_order(width):
    """The plain version bit for bit against its order written out in
    numpy f32, with non-integer weights, where another order would
    show."""
    g = fat_vertex_graph()
    x, _, ell = vertex_case(g, 6, seed=2, width=width)
    rng = np.random.default_rng(3)
    wgt = np.where(ell.wgt.numpy() != 0, rng.normal(size=ell.wgt.shape), 0).astype(np.float32)
    want = vertex_sums_in_order(x, ell.col.numpy(), wgt, ell.row_ptr.numpy(), ell.deg.numpy())
    got = spmm_ell_vertex_ref(torch.tensor(x), ell.col, torch.tensor(wgt), ell.row_ptr,
                              ell.deg).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_vertex_sum_rows_past_the_last_live_slot():
    """An ELL whose vertices own rows past their last live slot (deg[v]
    below (rows - 1) x W, or 0, as the launch's contract allows): those
    rows add +0, their padding (NaN weights here) is never read, and
    the plan gives their scratch rows 0 live slots."""
    rng = np.random.default_rng(4)
    W = 4
    rows = np.array([5, 4, 3, 2, 0, 1, 6, 1])
    deg = np.array([2 * W + 3, 0, W, 3, 0, W, 6 * W, 0], np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    R = int(row_ptr[-1])
    live = np.clip(np.repeat(deg, rows) - (np.arange(R) - np.repeat(row_ptr[:-1], rows)) * W,
                   0, W)
    wgt = rng.normal(size=(R, W)).astype(np.float32)
    wgt[np.arange(W) >= live[:, None]] = np.nan
    col = rng.integers(0, 9, (R, W)).astype(np.int32)
    x = rng.normal(size=(9, 5)).astype(np.float32)
    args = [torch.tensor(a) for a in (x, col, wgt, row_ptr, deg)]
    got = spmm_ell_vertex_ref(*args).numpy()
    want = vertex_sums_in_order(x, col, wgt, row_ptr, deg)
    assert not np.isnan(want).any()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    plan = vertex_plan(args[0], args[1], args[3], args[4], 2)
    assert plan.fat_vertex.tolist() == [0, 1, 2, 6]
    assert plan.fat_live.tolist() == [4, 4, 3, 0, 0, 0, 0, 0, 0, 4, 0, 0, *[4] * 6]


def test_vertex_plan_and_checks():
    """The plan the CUDA wrapper makes (on any device: it is torch):
    the vertices of more than split_rows rows, the ELL row and live
    slots of each of their rows; and the checks that run before a
    launch.  Padding may hold any col: only live slots are checked."""
    g = fat_vertex_graph()
    _, _, ell = vertex_case(g, 4, seed=1, width=4)
    x = torch.zeros((g.n, 3))
    row_ptr = ell.row_ptr.numpy()
    nrows = np.diff(row_ptr)
    for split in (1, 2, 16, 1000):
        plan = vertex_plan(x, ell.col, ell.row_ptr, ell.deg, split)
        fat = np.flatnonzero(nrows > split)
        assert np.array_equal(plan.fat_vertex.numpy(), fat)
        assert np.array_equal(plan.fat_start.numpy(), np.concatenate([[0], np.cumsum(nrows[fat])]))
        rows = np.concatenate([np.arange(row_ptr[v], row_ptr[v + 1]) for v in fat]
                              or [np.zeros(0, np.int64)])
        assert np.array_equal(plan.fat_row.numpy(), rows)
        live = (ell.col.numpy() != g.n).sum(axis=1)  # the ELL's padding is col n
        assert np.array_equal(plan.fat_live.numpy(), live[rows])
        assert plan.fat_vertex.dtype == plan.fat_live.dtype == torch.int32
    assert vertex_plan(x, ell.col, ell.row_ptr, ell.deg, 2) is \
        vertex_plan(x, ell.col, ell.row_ptr, ell.deg, 2)
    with pytest.raises(ValueError, match="split_rows must be >= 1"):
        vertex_plan(x, ell.col, ell.row_ptr, ell.deg, 0)
    col = ell.col.clone()
    col[ell.col == g.n] = 10**6  # padding: never read
    vertex_plan(x, col, ell.row_ptr, ell.deg, 2)
    col[row_ptr[7], 0] = g.n  # a live slot past x
    with pytest.raises(ValueError, match="live col must lie in"):
        vertex_plan(x, col, ell.row_ptr, ell.deg, 2)
    bad_ptr = ell.row_ptr.clone()
    bad_ptr[-1] -= 1
    with pytest.raises(ValueError, match="row_ptr must rise from 0"):
        vertex_plan(x, ell.col, bad_ptr, ell.deg, 2)
    bad_deg = ell.deg.clone()
    bad_deg[8] = 4 * int(nrows[8]) + 1  # one slot more than its rows hold
    with pytest.raises(ValueError, match="deg must lie in"):
        vertex_plan(x, ell.col, ell.row_ptr, bad_deg, 2)
    args = (x, ell.col, ell.wgt, ell.row_ptr, ell.deg)
    with pytest.raises(ValueError, match="row_ptr must be 1-D int64"):
        check_vertex_args(*args[:3], ell.row_ptr.int(), ell.deg)
    with pytest.raises(ValueError, match="deg must be int32"):
        check_vertex_args(*args[:4], ell.deg.long())
    with pytest.raises(ValueError, match="deg must be int32"):
        check_vertex_args(*args[:4], ell.deg[1:])
    with pytest.raises(ValueError, match="x must be 2-D float32"):
        check_vertex_args(x.double(), *args[1:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_ell_vertex_cuda(*args)
