"""The port's ELL SpMM op and neighbour ELL against the JAX package.

``aggregate_neighbors`` on CPU tensors (the plain torch version, what a
CPU tensor takes) against the reference Pallas kernel in interpret mode
on the same numpy inputs, at the reference kernel test's shapes plus
the GIN cell widths d = 100 (ogb_products) and d = 1433 (full_graph_sm):
``max`` bit-identical (max does not depend on order), ``sum`` within
1e-5 of max |ref| (f32 sums of W products in another order).  The CUDA
kernel is held against the same plain version on the card in
test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm_ell import aggregate_neighbors as ref_aggregate
from repro_torch.core.selfstab import in_ell
from repro_torch.graph import Graph, rmat1, small_world_graph
from repro_torch.kernels import aggregate_neighbors, spmm_ell_cuda, spmm_ell_ref
from repro_torch.kernels.spmm_ell.kernel import _index_range, check_spmm_args
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
    assert np.array_equal(ell.row_dst.numpy(), row_dst)
    assert np.array_equal(ell.col.numpy(), col)
    assert np.array_equal(ell.wgt.numpy(), np.isfinite(wgt).astype(np.float32))
    assert ell.col.dtype == torch.int32 and ell.wgt.dtype == torch.float32


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
            assert int((ell.row_dst == 7).sum()) == fat_rows
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
