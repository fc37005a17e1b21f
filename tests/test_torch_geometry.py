"""The geometric bases, DimeNet's triplet lists and the segment ELL of
the port (``repro_torch.models.gnn.{geometry,batch,ell,layers}``)
against the JAX package's, on the CPU.

Tolerances:
- the bases (Bessel, cosine cutoff, spherical harmonics) and their
  gradients: 1e-6 of the largest |value| (f32 formulas taken op for
  op; the constants are rounded once in another order);
- the Gaunt table, ``_combo_gaunt`` and every triplet list: equal
  bytes;
- the segment ELL's vertex sum against ``index_add_``: 1e-6 of the
  largest |sum| (a segment of more than W rows is summed row by row,
  then the rows, where ``index_add_`` adds in one run); its backward,
  the W = 1 transpose, equals ``g[index] * mask`` bit for bit;
- ``gather_rows``: its forward equals ``index_select`` bit for bit, its
  backward the plain vertex sum over the segment ELL bit for bit and
  ``index_select``'s own backward within 1e-6 of the largest |grad|
  (one f32 sum a segment in another order); the segment mean against
  the reference's ``scatter_mean``: 1e-6 of the largest |mean|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as ref_data
from repro.models.gnn import batch as ref_batch
from repro.models.gnn import geometry as ref_geo
from repro.models.gnn import layers as ref_layers
from repro.models.gnn import mace as ref_mace
from repro_torch.data import gnn_flat_batch, molecule_batch
from repro_torch.graph import rmat1
from repro_torch.kernels import VertexSum, vertex_sum
from repro_torch.models.gnn import (
    build_segment_ell,
    build_segment_transpose,
    build_triplets,
    gather_rows,
    geometry,
    random_molecule_batch,
    scatter_sum,
    segment_ell,
    segment_mean,
    segment_sum,
    segment_transpose,
)
from repro_torch.models.gnn import ell as ell_mod
from repro_torch.models.gnn import mace

TOL = 1e-6


def distances():
    """Zero, the padded edges' sqrt(3) 1e-12, the clamps' own ties (1e-9,
    the cutoff 5), values past the cutoff and a spread between."""
    rng = np.random.default_rng(0)
    fixed = [0.0, np.sqrt(3) * 1e-12, 1e-9, 5.0, 5.5, 12.0]
    return np.concatenate([fixed, rng.uniform(0.05, 6.0, 200)]).astype(np.float32)


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), np.abs(a - b).max()


@pytest.mark.parametrize("fn", ["bessel", "cutoff"])
def test_radial_bases_and_their_gradients(fn):
    """Values and gradients, at the ties of their clamps too (where
    jnp.maximum and jnp.clip split the gradient in halves)."""
    r = distances()
    if fn == "bessel":
        ref = lambda x: ref_geo.bessel_basis(x, 8, 5.0)
        port = lambda x: geometry.bessel_basis(x, 8, 5.0)
    else:
        ref = lambda x: ref_geo.cosine_cutoff(x, 5.0)
        port = lambda x: geometry.cosine_cutoff(x, 5.0)
    close(port(torch.tensor(r)).numpy(), ref(jnp.asarray(r)))
    g_ref = jax.grad(lambda x: jnp.sum(ref(x) * jnp.arange(1.0, 1.0 + ref(x).size)
                                       .reshape(ref(x).shape)))(jnp.asarray(r))
    x = torch.tensor(r, requires_grad=True)
    out = port(x)
    (g,) = torch.autograd.grad((out * torch.arange(1.0, 1.0 + out.numel()).reshape(out.shape))
                               .sum(), x)
    close(g.numpy(), g_ref, tol=1e-5)
    tie = 2 if fn == "bessel" else 3  # r = 1e-9 and r = cutoff
    assert float(g[tie]) == pytest.approx(float(g_ref[tie]), rel=1e-5, abs=1e-30)


def test_spherical_harmonics():
    v = np.random.default_rng(1).normal(size=(300, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    close(geometry.real_sph_harm_l2(torch.tensor(v)).numpy(),
          ref_geo.real_sph_harm_l2(jnp.asarray(v)))
    assert geometry.LM_INDEX == ref_geo.LM_INDEX and geometry.N_LM == ref_geo.N_LM == 9


def test_gaunt_tables_are_the_reference_bytes():
    G, ref = geometry.real_gaunt_table(), ref_geo.real_gaunt_table()
    assert G.dtype == ref.dtype and G.shape == (9, 9, 9) and G.tobytes() == ref.tobytes()
    assert int((G != 0).sum()) == 83
    assert mace._BIS_COMBOS == ref_mace._BIS_COMBOS
    assert mace._combo_gaunt().tobytes() == ref_mace._combo_gaunt().tobytes()


def test_bispectrum_equals_the_reference_contraction():
    A = np.random.default_rng(2).normal(size=(7, 5, 9)).astype(np.float32)
    G = mace._combo_gaunt()
    want = jnp.einsum("kabc,nxa,nxb,nxc->nxk", jnp.asarray(G), *(jnp.asarray(A),) * 3)
    close(mace.bispectrum(torch.tensor(A), torch.tensor(G)).numpy(), want, tol=1e-5)


# ---------------------------------------------------------------- #
# triplets


@pytest.mark.parametrize("cap", [None, 1, 2])
def test_build_triplets_byte_identical(tiny_graphs, cap):
    for i, g in enumerate(tiny_graphs):
        a = build_triplets(g.src, g.dst, g.n, cap, seed=i)
        b = ref_batch.build_triplets(g.src, g.dst, g.n, cap, seed=i)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.int32 and x.tobytes() == y.tobytes(), (g.name, cap)


def test_build_triplets_of_a_padded_block():
    """A sampled block's shape: many masked 0 -> 0 padding edges, all
    candidates of vertex 0's in-edges, each capped by its own draw."""
    rng = np.random.default_rng(3)
    n, m, pad = 400, 2500, 4000
    src = np.concatenate([rng.integers(0, n, m), np.zeros(pad)]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n, m), np.zeros(pad)]).astype(np.int32)
    for cap in (2, 4, None):
        a = build_triplets(src, dst, n, cap, seed=5)
        b = ref_batch.build_triplets(src, dst, n, cap, seed=5)
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b)), cap
    assert build_triplets(src[:0], dst[:0], n, 2)[0].shape == (0,)


@pytest.mark.parametrize("cap", [4, 2, None])
def test_flat_batch_triplets_byte_identical(cap):
    g = rmat1(8, seed=1)
    a = gnn_flat_batch(g, 6, 3, coords=True, triplets=True, triplet_cap=cap, seed=2)
    b = ref_data.gnn_flat_batch(g, 6, 3, coords=True, triplets=True, triplet_cap=cap, seed=2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_molecule_triplets_byte_identical():
    a = random_molecule_batch(6, 30, 64, seed=4, with_triplets=True)
    b = ref_batch.random_molecule_batch(6, 30, 64, seed=4, with_triplets=True)
    for k in ("tri_kj", "tri_ji", "tri_mask"):
        assert getattr(a, k).tobytes() == getattr(b, k).tobytes(), k
    assert a.tri_kj.shape == (6, 512)
    a = molecule_batch(3, 4, 10, 20, triplets=True, triplet_pad=128)
    b = ref_data.molecule_batch(3, 4, 10, 20, triplets=True, triplet_pad=128)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------- #
# the segment ELL


def segment_case(T, n, seed, fat=0, pad=0):
    """T rows of values, segment ids in [0, n) and a mask; ``fat`` rows
    in one segment; the last ``pad`` rows a block's padding, all masked
    and all in segment 0."""
    rng = np.random.default_rng(seed)
    index = rng.integers(0, n, T)
    if fat:
        index[:fat] = n // 2  # a segment of several rows
    mask = rng.random(T) > 0.3
    if pad:
        index[T - pad:], mask[T - pad:] = 0, False
    index = torch.tensor(index, dtype=torch.int32)
    mask = torch.tensor(mask)
    values = torch.tensor(rng.normal(size=(T, 5)), dtype=torch.float32)
    return values * mask[:, None], index, mask


CASES = {"T<n": (6, 20, 0, 0), "T>n": (300, 7, 1, 0), "fat": (400, 50, 2, 150),
         "empty": (0, 4, 3, 0), "T=n": (33, 33, 4, 0), "padding": (600, 90, 5, 0, 400)}


def live_cols(ell) -> torch.Tensor:
    """The col entries of an ELL's live slots, vertex by vertex in order."""
    from repro_torch.kernels.spmm_ell.ref import live_slots

    W = ell.col.shape[1]
    return ell.col[torch.arange(W) < live_slots(ell.row_ptr, ell.deg, W)[:, None]]


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sum_equals_index_add(case):
    """Empty segments (T < n), segments of many rows, no rows at all, a
    block's padding; the ELL holds the live rows only, each once."""
    values, index, mask = segment_case(*CASES[case])
    n = CASES[case][1]
    ell = build_segment_ell(index, mask, n)
    live = torch.nonzero(mask).flatten()
    assert ell.n == n and int(ell.deg.sum()) == live.shape[0]
    assert torch.equal(torch.sort(live_cols(ell).long()).values, live)
    assert torch.equal(ell.deg.long(), torch.bincount(index[live].long(), minlength=n))
    out = vertex_sum(values, ell.col, ell.wgt, ell.row_ptr, ell.deg)
    want = scatter_sum(values, index.long(), n)
    atol = TOL * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(out, want, rtol=0, atol=atol)
    assert torch.equal(segment_sum(values, index, mask, n, "segment_sum"), want)
    torch.testing.assert_close(segment_sum(values, index, mask, n), want, rtol=0, atol=atol)
    # the mean's count: every row, masked or not, as scatter_mean counts
    torch.testing.assert_close(segment_mean(values, index, mask, n),
                               segment_mean(values, index, mask, n, "segment_sum"),
                               rtol=1e-6, atol=1e-6)


def test_padding_leaves_the_segment_ell():
    """The padding's shape (every masked row in segment 0, as a sampled
    block's masked 0 -> 0 edges): no slot for a masked row, W set by the
    live segments, and the mean still divides by the reference's count."""
    values, index, mask = segment_case(*CASES["padding"])
    n = CASES["padding"][1]
    ell = build_segment_ell(index, mask, n)
    assert not bool(torch.isin(live_cols(ell), torch.nonzero(~mask).flatten()).any())
    live_deg = torch.bincount(index[mask].long(), minlength=n)
    all_deg = torch.bincount(index.long())
    assert ell.col.shape[1] == min(64, int(live_deg.max())) < int(all_deg.max())
    assert int(ell.deg[0]) == int(live_deg[0])
    want = np.asarray(ref_layers.scatter_mean(jnp.asarray(values.numpy()),
                                              jnp.asarray(index.numpy()), n))
    close(segment_mean(values, index, mask, n).numpy(), want)
    tr = build_segment_transpose(index, mask, n)
    assert torch.equal(tr.deg, mask.to(torch.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_segment_sum_backward_is_the_masked_gather(case):
    values, index, mask = segment_case(*CASES[case])
    n = CASES[case][1]
    tr = build_segment_transpose(index, mask, n)
    assert tuple(tr.col.shape) == (index.shape[0], 1) and tr.n == index.shape[0]
    g = torch.randn((n, 5), generator=torch.Generator().manual_seed(0))
    want = g[index.long()] * mask[:, None].float()
    assert torch.equal(vertex_sum(g, tr.col, tr.wgt, tr.row_ptr, tr.deg), want)
    v = values.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad((segment_sum(v, index, mask, n) * g).sum(), v)
    assert torch.equal(grad, want)


def test_launches_are_counted_by_shape():
    """A launch counted at a shape counts in the kernel's total and under
    its shape; a reset clears both."""
    from repro_torch import kernels as K
    from repro_torch.kernels import _lib

    K.reset_launch_counts()
    for shape in [(6, 4, 3), (6, 4, 3), (4, 6, 3), None]:
        _lib.count_launch("spmm_ell", shape)
    assert K.launch_counts()["spmm_ell"] == 4
    assert K.launch_shapes()["spmm_ell"] == {(6, 4, 3): 2, (4, 6, 3): 1}
    K.reset_launch_counts()
    assert K.launch_counts()["spmm_ell"] == 0 and K.launch_shapes()["spmm_ell"] == {}


def test_vertex_bound_counts_only_slots_of_nonzero_weight():
    """A masked slot costs its weight's 4 bytes and nothing else: neither
    its col, its row of x nor a multiply-add."""
    from repro_torch.roofline.kernels import spmm_ell_vertex_traffic

    m, rows, n, d = 100, 30, 20, 8
    full = spmm_ell_vertex_traffic(m, rows, n, d)
    assert full == spmm_ell_vertex_traffic(m, rows, n, d, nnz=m)
    assert full == (8 * m + 4 * rows * d + 8 * (n + 1) + 4 * n + 4 * n * d, 2 * m * d)
    nbytes, ops = spmm_ell_vertex_traffic(m, 10, n, d, nnz=40)
    assert nbytes == full[0] - 4 * 60 - 4 * 20 * d and ops == 2 * 40 * d


def test_segment_sum_gradcheck_and_bf16():
    """Finite differences in float64 through the plain Function; a bf16
    table sums in f32 and comes back bf16."""
    values, index, mask = segment_case(40, 9, 5, fat=20)
    fwd, tr = build_segment_ell(index, mask, 9), build_segment_transpose(index, mask, 9)
    layout = lambda e: (e.col, e.wgt, e.row_ptr, e.deg)
    x = values.double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda v: VertexSum.apply(v, layout(fwd), lambda: layout(tr)), (x,))
    vb = values.to(torch.bfloat16)
    out = segment_sum(vb, index, mask, 9)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, segment_sum(vb.float(), index, mask, 9).to(torch.bfloat16))


def bits(t) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", ["fat", "T>n", "padding"])
def test_gather_rows_forward_and_backward(case):
    """Forward: ``index_select`` bit for bit, masked rows too.  Backward,
    for a gradient that is 0 at the masked rows as every caller's is:
    the plain vertex sum over the segment ELL bit for bit, and
    ``index_select``'s own backward within TOL; the plain route is
    ``index_select`` itself."""
    _, index, mask = segment_case(*CASES[case])
    n = CASES[case][1]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((n, 5), generator=gen)
    assert torch.equal(bits(gather_rows(x, index, mask)), bits(x.index_select(0, index)))
    g = torch.randn((index.shape[0], 5), generator=gen) * mask[:, None]
    xg = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(gather_rows(xg, index, mask), xg, g)
    ell = segment_ell(index, mask, n)
    assert torch.equal(bits(grad), bits(vertex_sum(g, ell.col, ell.wgt, ell.row_ptr, ell.deg)))
    (want,) = torch.autograd.grad(xg.index_select(0, index), xg, g)
    torch.testing.assert_close(grad, want, rtol=0, atol=TOL * float(want.abs().max()))
    (plain,) = torch.autograd.grad(gather_rows(xg, index, mask, "segment_sum"), xg, g)
    assert torch.equal(bits(plain), bits(want))


def test_gather_rows_gradcheck_and_bf16():
    """Finite differences in float64 (a 2-D and a 1-D table) of the
    gather times its mask, the composition every caller makes; a bf16
    table's gradient is summed in f32 and comes back bf16."""
    _, index, mask = segment_case(40, 9, 5, fat=20)
    gen = torch.Generator().manual_seed(2)
    w = mask.double()
    for shape in ((9, 3), (9,)):
        x = torch.randn(shape, dtype=torch.float64, generator=gen).requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda t: gather_rows(t, index, mask) * w.reshape(-1, *([1] * (t.dim() - 1))), (x,))
    xb = torch.randn((9, 5), generator=gen).to(torch.bfloat16).requires_grad_(True)
    g = (torch.randn((40, 5), generator=gen) * mask[:, None]).to(torch.bfloat16)
    (grad,) = torch.autograd.grad(gather_rows(xb, index, mask), xb, g)
    assert grad.dtype == torch.bfloat16
    assert torch.equal(bits(grad.float()),
                       bits(segment_sum(g.float(), index, mask, 9).to(torch.bfloat16).float()))
    with pytest.raises(ValueError, match="agg_impl"):
        gather_rows(xb, index, mask, "atomics")


@pytest.mark.parametrize("written", ["index", "mask"])
def test_gather_rows_backward_refuses_a_written_index(written):
    """The index and mask are saved for the backward: writing either in
    place after the forward makes the backward raise, where the segment
    memo would otherwise rebuild from the new index."""
    _, index, mask = segment_case(40, 9, 5, fat=20)
    index, mask = index.clone(), mask.clone()
    x = torch.randn((9, 3), generator=torch.Generator().manual_seed(3)).requires_grad_(True)
    out = gather_rows(x, index, mask)
    {"index": index, "mask": mask}[written].zero_()
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        out.sum().backward()


def test_segment_ells_are_kept_per_index(monkeypatch):
    """Built once a (index, mask, n) and way, those of the last
    PLANS_KEPT / 2 (index, mask, n) kept, forward and transposed (a
    DimeNet step's four index tensors); an in-place write to the index
    rebuilds."""
    builds = []
    for f in ("build_segment_ell", "build_segment_transpose"):
        monkeypatch.setattr(ell_mod, f,
                            lambda *a, real=getattr(ell_mod, f): builds.append(1) or real(*a))
    kept = ell_mod.PLANS_KEPT
    cases = [segment_case(30, 6, s) for s in range(kept // 2 + 1)]
    for _ in range(2):
        for _, index, mask in cases[:kept // 2]:
            segment_ell(index, mask, 6)
            segment_transpose(index, mask, 6)
    assert len(builds) == kept
    _, index, mask = cases[-1]
    segment_ell(index, mask, 6)  # pushes out the oldest
    segment_ell(*cases[0][1:], 6)
    assert len(builds) == kept + 2
    index[0] = (index[0] + 1) % 6
    segment_ell(index, mask, 6)
    assert len(builds) == kept + 3
    with pytest.raises(ValueError, match="lie in"):
        build_segment_ell(torch.tensor([0, 6]), torch.tensor([True, True]), 6)
    with pytest.raises(ValueError, match="lie in"):
        build_segment_transpose(torch.tensor([0, -1]), torch.tensor([True, True]), 6)
