"""GIN training on the port against the JAX package's, on the CPU: the
loss and gradients of both aggregation routes against
``jax.value_and_grad`` of the reference's losses (jitted), AdamW steps against
the reference's jitted ``build_train_step``, the differentiable vertex
sum (``VertexSum``), the molecule batch, the fanout sampler and
gin-tu's train cells.

The reference's random weights go through ``gin_params_from_numpy``
and every batch is byte-identical on both sides.  Tolerances:
- loss: 1e-6 of |loss| (a mean of f32 log-likelihoods in another
  order);
- gradients, leaf by leaf: max |port - ref| <= 5e-5 x max |ref| of the
  leaf.  Each is an f32 sum over every node (or edge) taken in another
  order by both routes and by XLA's fused matmuls; eps's gradient is
  one such sum with cancellation.  The measured worst is 4.8e-6 (the
  small-world graph), so the bound leaves 10x;
- params after AdamW steps: 1e-3 absolute, a tenth of lr = 1e-2.
  Adam moves an element by lr x m_hat / (sqrt(v_hat) + eps), about lr
  whatever the gradient's size, so an element whose gradient is tiny
  (a dead ReLU unit's readout row) moves apart by its gradient's own
  relative error times lr: the measured worst is 6.6e-5 (0.7% of lr,
  two elements of the readout after 3 steps); a wrong sign would show
  as 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.data.synthetic as ref_data
import repro.graph as ref_graph
import repro.train as R
from repro.configs import gin_tu as ref_gin_tu
from repro.launch.mesh import make_cpu_topology
from repro.models.gnn import batch as ref_batch
from repro.models.gnn import gin as ref_gin
import repro_torch.train as T
from repro_torch.configs import get_arch
from repro_torch.data import gnn_flat_batch, molecule_batch
from repro_torch.graph import FanoutSampler, Graph, erdos_renyi_graph, rmat1
from repro_torch.kernels import VertexSum, _lib, aggregate_neighbors, spmm_rows, vertex_sum
from repro_torch.kernels.spmm_ell import kernel as spmm_kernel
from repro_torch.models.convert import gin_params_from_numpy
from repro_torch.models.gnn import (
    build_neighbor_ell,
    gin,
    neighbor_ell,
    neighbor_sum,
    random_molecule_batch,
    transpose_ell,
)
from repro_torch.models.gnn import ell as ell_mod
from repro_torch.train.checkpoint import _flatten_with_paths as by_path
from repro_torch.train.train_step import value_and_grad

LOSS_RTOL = 1e-6
GRAD_LEAF_TOL = 5e-5
PARAM_ATOL = 1e-3
gin_tu = get_arch("gin-tu")


def setup(g, cell, reduced=False, seed=0):
    ref_cfg = ref_gin_tu.make_config(reduced, cell)
    cfg = gin_tu.make_config(reduced, cell)
    batch = gnn_flat_batch(g, cfg.d_in, cfg.n_classes, seed=seed)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_gin.init_params(jax.random.PRNGKey(seed + 1), ref_cfg))
    return ref_cfg, cfg, batch, tree


def route(cfg, agg_impl):
    return dataclasses.replace(cfg, agg_impl=agg_impl)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def assert_grads_close(port, ref, tol=GRAD_LEAF_TOL):
    p, r = by_path(port), by_path(ref)
    assert sorted(p) == sorted(r)
    for k in p:
        a, b = p[k].numpy(), np.asarray(r[k])
        assert a.shape == b.shape and np.isfinite(a).all(), k
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= tol * scale, \
            (k, float(np.abs(a - b).max() / scale))


def ref_value_and_grad(loss, tree, batch, ref_cfg):
    """The reference's loss and gradients, jitted (one compile a shape
    instead of one an op)."""
    return jax.jit(jax.value_and_grad(lambda t, b: loss(t, b, ref_cfg)))(
        tree, jax_batch(batch))


def check_loss_and_grads(g, cell, agg_impl, reduced=False, seed=0):
    ref_cfg, cfg, batch, tree = setup(g, cell, reduced, seed)
    rl, rg = ref_value_and_grad(ref_gin.node_classification_loss, tree, batch, ref_cfg)
    params = gin_params_from_numpy(tree, cfg, device="cpu")
    c = route(cfg, agg_impl)
    pl, pg = value_and_grad(lambda p, b: gin.node_classification_loss(p, b, c))(
        params, torch_batch(batch))
    assert abs(float(pl) - float(rl)) <= LOSS_RTOL * abs(float(rl))
    assert_grads_close(pg, rg)


# ---------------------------------------------------------------- #
# loss, gradients and steps against the reference


@pytest.mark.parametrize("agg_impl", gin.AGG_IMPLS)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_loss_and_grads_match_reference_on_tiny_graphs(tiny_graphs, agg_impl, reduced):
    for i, g in enumerate(tiny_graphs):
        check_loss_and_grads(g, "ogb_products", agg_impl, reduced, seed=i)


@pytest.mark.parametrize("agg_impl", gin.AGG_IMPLS)
def test_loss_and_grads_at_full_graph_sm_scale(agg_impl):
    check_loss_and_grads(erdos_renyi_graph(2708, 2.0, seed=0), "full_graph_sm", agg_impl)


@pytest.mark.parametrize("agg_impl", gin.AGG_IMPLS)
def test_masked_edges_carry_no_gradient(agg_impl):
    g = rmat1(8, seed=4)
    ref_cfg, cfg, batch, tree = setup(g, "ogb_products", seed=2)
    batch["edge_mask"] = np.random.default_rng(0).random(g.m) > 0.3
    rl, rg = ref_value_and_grad(ref_gin.node_classification_loss, tree, batch, ref_cfg)
    params = gin_params_from_numpy(tree, cfg, device="cpu")
    c = route(cfg, agg_impl)
    pl, pg = value_and_grad(lambda p, b: gin.node_classification_loss(p, b, c))(
        params, torch_batch(batch))
    assert abs(float(pl) - float(rl)) <= LOSS_RTOL * abs(float(rl))
    assert_grads_close(pg, rg)


@pytest.mark.parametrize("agg_impl", gin.AGG_IMPLS)
def test_three_adamw_steps_match_reference(agg_impl):
    """``build_train_step(node_classification_loss)`` at full width
    (AdamW, warmup-cosine, clip) three steps from the same params,
    against the reference's jitted step."""
    g = rmat1(8, seed=3)
    ref_cfg, cfg, batch, tree = setup(g, "ogb_products", seed=0)
    kw = dict(warmup_steps=2, total_steps=10)
    rtc = R.TrainConfig(adamw=R.AdamWConfig(lr=1e-2), **kw)
    ptc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), **kw)
    rstep = jax.jit(R.build_train_step(
        lambda p, b: ref_gin.node_classification_loss(p, b, ref_cfg), rtc))
    c = route(cfg, agg_impl)
    pstep = T.build_train_step(lambda p, b: gin.node_classification_loss(p, b, c), ptc)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    pp = gin_params_from_numpy(tree, cfg, device="cpu")
    rs, ps = R.init_train_state(rp, rtc), T.init_train_state(pp, ptc)
    rb, pb = jax_batch(batch), torch_batch(batch)
    for i in range(3):
        rp, rs, rm = rstep(rp, rs, rb, jnp.int32(i))
        pp, ps, pm = pstep(pp, ps, pb, i)
        for k, a in by_path(pp).items():
            np.testing.assert_allclose(a.numpy(), np.asarray(by_path(rp)[k]),
                                       atol=PARAM_ATOL, err_msg=k)
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_RTOL)
        assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                       rel=GRAD_LEAF_TOL)
        assert int(ps["step"]) == i + 1


@pytest.mark.parametrize("agg_impl", gin.AGG_IMPLS)
def test_molecule_loss_and_grads_match_reference(agg_impl):
    """The molecule cell at its size (128 graphs of 30 atoms and 64
    edge slots, 4 of them masked padding): the port's block-diagonal
    graph against the reference's vmap over the graphs."""
    ref_cfg = ref_gin_tu.make_config(False, "molecule")
    cfg = route(gin_tu.make_config(False, "molecule"), agg_impl)
    sh = ref_configs.cells.GNN_SHAPES["molecule"]
    batch = molecule_batch(0, sh["batch"], sh["n"], sh["e"], seed=3)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_gin.init_params(jax.random.PRNGKey(4), ref_cfg))
    rl, rg = ref_value_and_grad(ref_gin_tu._molecule_loss, tree, batch, ref_cfg)
    params = gin_params_from_numpy(tree, cfg, device="cpu")
    pl, pg = value_and_grad(lambda p, b: gin_tu._molecule_loss(p, b, cfg))(
        params, torch_batch(batch))
    assert abs(float(pl) - float(rl)) <= LOSS_RTOL * abs(float(rl))
    assert_grads_close(pg, rg)
    # and a loop over the graphs, one plain forward each
    tb = torch_batch(batch)
    with torch.no_grad():
        per = [gin.forward(params, tb["x"][b], tb["edge_src"][b], tb["edge_dst"][b],
                           tb["edge_mask"][b], route(cfg, "segment_sum")).mean()
               for b in range(sh["batch"])]
    loop = torch.mean((torch.stack(per) - tb["y"]) ** 2)
    assert abs(float(loop) - float(pl)) <= LOSS_RTOL * abs(float(loop))


def test_microbatches_on_a_flat_graph_batch():
    """The reference splits a flat graph batch's node and edge arrays
    independently, so a chunk's edges index nodes outside it, and its
    take fills them with NaN: the loss is NaN.  The port raises instead
    (the neighbour ELL's endpoint check; the segment route's gather or
    scatter).  Microbatching is defined for batches of independent rows
    only (ROADMAP.md Queue 3)."""
    g = rmat1(7, seed=0)
    ref_cfg, cfg, batch, tree = setup(g, "ogb_products", reduced=True)
    rtc = R.TrainConfig(microbatches=4, warmup_steps=1, total_steps=4)
    rstep = jax.jit(R.build_train_step(
        lambda p, b: ref_gin.node_classification_loss(p, b, ref_cfg), rtc))
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    _, _, rm = rstep(rp, R.init_train_state(rp, rtc), jax_batch(batch), jnp.int32(0))
    assert np.isnan(float(rm["loss"]))
    ptc = T.TrainConfig(microbatches=4, warmup_steps=1, total_steps=4)
    pp = gin_params_from_numpy(tree, cfg, device="cpu")
    for agg_impl, err in (("spmm_ell", ValueError), ("segment_sum", (IndexError, RuntimeError))):
        c = route(cfg, agg_impl)
        step = T.build_train_step(lambda p, b: gin.node_classification_loss(p, b, c), ptc)
        with pytest.raises(err, match="lie in|out of"):
            step(pp, T.init_train_state(pp, ptc), torch_batch(batch), 0)


# ---------------------------------------------------------------- #
# the differentiable vertex sum


def directed_case(dtype=torch.float64, seed=0):
    """A directed graph (edges one way only) with a fat vertex, a
    quarter of the edges masked, and the ELLs both ways at W = 4."""
    rng = np.random.default_rng(seed)
    n, m = 12, 60
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    dst[:14] = 3  # in-degree > 3 W: four rows
    edges = (torch.tensor(src), torch.tensor(dst),
             torch.tensor(rng.random(m) > 0.25))
    fwd = build_neighbor_ell(*edges, n, 4)
    bwd = build_neighbor_ell(edges[1], edges[0], edges[2], n, 4)
    x = torch.tensor(rng.normal(size=(n, 3)), dtype=dtype)
    return x, edges, fwd, bwd


def layout(ell):
    return ell.col, ell.wgt, ell.row_ptr, ell.deg


def test_vertex_sum_function_gradcheck():
    """Finite differences in float64 through the plain Function, to
    first and second order (the second applies the Function over the
    forward ELL again)."""
    x, _, fwd, bwd = directed_case()
    x.requires_grad_(True)

    def f(x_):
        return VertexSum.apply(x_, layout(fwd), lambda: layout(bwd))

    assert torch.autograd.gradcheck(f, (x,))
    assert torch.autograd.gradgradcheck(f, (x,))


def test_vertex_sum_backward_is_the_transpose_sum():
    """The gradient of sum(out * g) is the vertex sum of g over the
    transpose ELL, and equals the segment-sum route's gradient."""
    x, edges, fwd, bwd = directed_case(torch.float32, seed=1)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    xg = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad((VertexSum.apply(xg, layout(fwd), lambda: layout(bwd)) * g)
                                  .sum(), xg)
    assert torch.equal(grad, vertex_sum(g, *layout(bwd)))
    xs = x.clone().requires_grad_(True)
    w = edges[2].float()[:, None]
    seg = gin.segment_neighbor_sum(xs, edges[0], edges[1], w)
    (grad_seg,) = torch.autograd.grad((seg * g).sum(), xs)
    torch.testing.assert_close(grad, grad_seg, rtol=1e-6, atol=1e-6)


def test_no_gradient_is_dropped():
    """Outside the Function a grad-requiring input raises on the CPU as
    on the card (the kernel's launch is not recorded by autograd); under
    no_grad, or for data, the ops run; the Function without a transpose
    refuses an x that needs a gradient; the row entry's backward names
    ROADMAP.md."""
    x, _, fwd, bwd = directed_case(torch.float32)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="VertexSum"):
        vertex_sum(xg, *layout(fwd))
    with torch.no_grad():
        assert torch.equal(vertex_sum(xg, *layout(fwd)), vertex_sum(x, *layout(fwd)))
    with pytest.raises(RuntimeError, match="no transpose ELL"):
        neighbor_sum(fwd, xg)
    out = neighbor_sum(fwd, x)  # data: no gradient wanted, no transpose needed
    assert not out.requires_grad and torch.equal(out, vertex_sum(x, *layout(fwd)))
    pad = torch.cat([xg, xg.new_zeros((1, 3))])
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        spmm_rows(pad, fwd.col, fwd.wgt)
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        aggregate_neighbors(pad, fwd.col, fwd.wgt, impl="pallas")
    ref = aggregate_neighbors(pad, fwd.col, fwd.wgt)  # the plain op differentiates
    assert ref.requires_grad


def test_train_step_sums_nine_times_and_keeps_its_ells(monkeypatch):
    """A full-width step sums 5 times forward and 4 times backward (layer
    1's input is data); the neighbour and transpose ELLs are built once
    for the graph and kept across steps, and the vertex plan memo holds
    both ELLs' plans in turn, until PLANS_KEPT others push them out."""
    g = rmat1(8, seed=3)
    _, cfg, batch, tree = setup(g, "ogb_products")
    builds = []
    real_build = ell_mod.build_neighbor_ell
    monkeypatch.setattr(ell_mod, "build_neighbor_ell",
                        lambda *a, **k: builds.append(1) or real_build(*a, **k))
    tc = T.TrainConfig(warmup_steps=1, total_steps=3)
    step = T.build_train_step(lambda p, b: gin.node_classification_loss(p, b, cfg), tc)
    p = gin_params_from_numpy(tree, cfg, device="cpu")
    s, b = T.init_train_state(p, tc), torch_batch(batch)
    for i in range(3):
        before = _lib.call_counts()["spmm_ell"]["ref"]
        p, s, _ = step(p, s, b, i)
        assert _lib.call_counts()["spmm_ell"]["ref"] - before == 9
    assert len(builds) == 2
    edges = (b["edge_src"], b["edge_dst"], b["edge_mask"])
    fwd, bwd = neighbor_ell(*edges, g.n), transpose_ell(*edges, g.n)
    assert torch.equal(bwd.col[bwd.wgt > 0].sort().values,
                       build_neighbor_ell(edges[1], edges[0], edges[2], g.n)
                       .col[bwd.wgt > 0].sort().values)
    x = b["x"]
    plans = [spmm_kernel.vertex_plan(x, e.col, e.row_ptr, e.deg, 2) for e in (fwd, bwd)]
    for _ in range(2):  # alternating: each ELL keeps its plan
        for e, plan in zip((fwd, bwd), plans):
            assert spmm_kernel.vertex_plan(x, e.col, e.row_ptr, e.deg, 2) is plan
    others = [build_neighbor_ell(edges[0][:k], edges[1][:k], edges[2][:k], g.n)
              for k in range(100, 100 + spmm_kernel.PLANS_KEPT - 1)]
    for e in others:  # with bwd's plan, PLANS_KEPT newer than fwd's
        spmm_kernel.vertex_plan(x, e.col, e.row_ptr, e.deg, 2)
    assert spmm_kernel.vertex_plan(x, fwd.col, fwd.row_ptr, fwd.deg, 2) is not plans[0]
    assert len(spmm_kernel._planned) == spmm_kernel.PLANS_KEPT


def test_resume_is_idempotent_through_the_kernel_route(tmp_path):
    """4 steps straight equal 2 steps, a checkpoint, a restore and 2
    more, bit for bit (the chip run repeats this at full scale)."""
    g = rmat1(8, seed=1)
    _, cfg, batch, tree = setup(g, "ogb_products", seed=1)
    tc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), warmup_steps=2, total_steps=4)
    step = T.build_train_step(lambda p, b: gin.node_classification_loss(p, b, cfg), tc)
    b = torch_batch(batch)

    def fresh():
        p = gin_params_from_numpy(tree, cfg, device="cpu")
        return p, T.init_train_state(p, tc)

    p, s = fresh()
    for i in range(4):
        p, s, _ = step(p, s, b, i)
    p2, s2 = fresh()
    for i in range(2):
        p2, s2, _ = step(p2, s2, b, i)
    ck = T.Checkpointer(str(tmp_path))
    ck.save(2, {"params": p2, "opt": s2})
    tree2, man = ck.restore()
    p3, s3 = tree2["params"], tree2["opt"]
    for i in range(man["step"], 4):
        p3, s3, _ = step(p3, s3, b, i)
    for k, v in by_path(p).items():
        assert torch.equal(v, by_path(p3)[k]), k


def test_training_moves_between_the_packages_through_a_checkpoint(tmp_path):
    """Two steps in one package, a checkpoint of params and AdamW state,
    a third step in the other, both ways: the params agree with three
    steps taken in one package within PARAM_ATOL."""
    g = rmat1(8, seed=2)
    ref_cfg, cfg, batch, tree = setup(g, "ogb_products", seed=2)
    kw = dict(warmup_steps=2, total_steps=10)
    rtc = R.TrainConfig(adamw=R.AdamWConfig(lr=1e-2), **kw)
    ptc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), **kw)
    rstep = jax.jit(R.build_train_step(
        lambda p, b: ref_gin.node_classification_loss(p, b, ref_cfg), rtc))
    pstep = T.build_train_step(lambda p, b: gin.node_classification_loss(p, b, cfg), ptc)
    rb, pb = jax_batch(batch), torch_batch(batch)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs = R.init_train_state(rp, rtc)
    pp = gin_params_from_numpy(tree, cfg, device="cpu")
    ps = T.init_train_state(pp, ptc)
    for i in range(2):
        rp, rs, _ = rstep(rp, rs, rb, jnp.int32(i))
        pp, ps, _ = pstep(pp, ps, pb, i)
    R.Checkpointer(str(tmp_path / "ref")).save(2, {"params": rp, "opt": rs})
    T.Checkpointer(str(tmp_path / "port")).save(2, {"params": pp, "opt": ps})
    from_ref, _ = T.Checkpointer(str(tmp_path / "ref")).restore()
    from_port, _ = R.Checkpointer(str(tmp_path / "port")).restore()
    assert int(from_ref["opt"]["step"]) == 2 and from_ref["opt"]["step"].dtype == torch.int32
    port3, _, _ = pstep(from_ref["params"], from_ref["opt"], pb, 2)
    ref3, _, _ = rstep(*(jax.tree_util.tree_map(jnp.asarray, from_port[k])
                         for k in ("params", "opt")), rb, jnp.int32(2))
    rp, _, _ = rstep(rp, rs, rb, jnp.int32(2))
    for k, a in by_path(port3).items():
        want = np.asarray(by_path(rp)[k])
        np.testing.assert_allclose(a.numpy(), want, atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(np.asarray(by_path(ref3)[k]), want, atol=PARAM_ATOL,
                                   err_msg=k)


# ---------------------------------------------------------------- #
# batches, the sampler and the cells


@pytest.mark.parametrize("batch,n_atoms,n_edges,seed", [
    (128, 30, 64, 0), (4, 9, 40, 3), (3, 30, 30, 7), (2, 5, 11, 1)])
def test_random_molecule_batch_byte_identical(batch, n_atoms, n_edges, seed):
    a = random_molecule_batch(batch, n_atoms, n_edges, seed=seed)
    b = ref_batch.random_molecule_batch(batch, n_atoms, n_edges, seed=seed)
    for k in ("x", "edge_src", "edge_dst", "edge_mask", "coords", "y"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k
    # with triplets (each graph's list cut or padded to triplet_pad slots)
    for pad in (512, 16):
        a = random_molecule_batch(batch, n_atoms, n_edges, seed=seed, with_triplets=True,
                                  triplet_pad=pad)
        b = ref_batch.random_molecule_batch(batch, n_atoms, n_edges, seed=seed,
                                            with_triplets=True, triplet_pad=pad)
        for k in ("tri_kj", "tri_ji", "tri_mask"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("step", [0, 1, 5])
def test_molecule_batch_byte_identical(step):
    a = molecule_batch(step, 16, 30, 64, seed=2)
    b = ref_data.molecule_batch(step, 16, 30, 64, seed=2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    a = molecule_batch(step, 16, 30, 64, triplets=True, triplet_pad=200, seed=2)
    b = ref_data.molecule_batch(step, 16, 30, 64, triplets=True, triplet_pad=200, seed=2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("fanouts,seeds,seed", [((15, 10), 64, 0), ((3,), 10, 2),
                                                ((4, 3, 2), 32, 5)])
def test_fanout_sampler_blocks_byte_identical(fanouts, seeds, seed):
    """Three blocks drawn in turn from one sampler (the rng advances),
    over a graph with isolated vertices among the seeds."""
    g = rmat1(10, seed=seed)
    port = FanoutSampler(g, fanouts, seed=seed)
    ref = ref_graph.sampler.FanoutSampler(g, fanouts, seed=seed)
    assert port.padded_sizes(seeds) == ref.padded_sizes(seeds)
    pick = np.random.default_rng(seed)
    for _ in range(3):
        s = pick.choice(g.n, seeds, replace=False).astype(np.int32)
        a, b = port.sample(s), ref.sample(s)
        for k in ("nodes", "node_mask", "edge_src", "edge_dst", "edge_mask", "edge_layer"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        assert (a.n_seeds, a.n_nodes, a.n_edges) == (b.n_seeds, b.n_nodes, b.n_edges)
    assert np.array_equal(port.csr.row_ptr, ref.csr.row_ptr)


@pytest.mark.parametrize("cell", ref_gin_tu.SHAPES)
def test_train_cells_plan_the_reference_arguments(cell):
    """Argument bytes and leaves of gin-tu's four train cells equal the
    reference ``CellProgram``'s; the plan carries a step."""
    plan = gin_tu.make_cell(cell)
    ref = ref_gin_tu.make_cell(cell, make_cpu_topology(1))
    ref_bytes = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                    for x in jax.tree_util.tree_leaves(ref.args))
    assert plan.kind == ref.kind == "train" and plan.arg_bytes == ref_bytes
    p, r = by_path(plan.args), by_path(ref.args)
    assert sorted(p) == sorted(r)
    for k in p:
        assert tuple(p[k].shape) == tuple(r[k].shape), k
        assert str(p[k].dtype).split(".")[-1] == np.dtype(r[k].dtype).name, k
    assert plan.model_flops == float(ref.model_flops) and plan.notes == ref.notes


@pytest.mark.parametrize("cell", ["full_graph_sm", "molecule"])
def test_cell_step_runs_on_tensors_of_its_shapes(cell):
    """The plan's step on real tensors of the plan's shapes (reduced
    widths): a Cora-sized ER graph padded to the cell's node and edge
    counts, or the molecule batch; the loss finite, every param moved."""
    plan = gin_tu.make_cell(cell, reduced=True)
    params = gin.init_params(torch.Generator().manual_seed(0),
                             gin_tu.make_config(True, cell))
    opt = T.init_train_state(params, T.TrainConfig())
    shapes = plan.args[2]
    if cell == "molecule":
        sh = ref_configs.cells.GNN_SHAPES[cell]
        batch = torch_batch(molecule_batch(0, sh["batch"], sh["n"], sh["e"]))
    else:
        g = erdos_renyi_graph(2708, 1.9, seed=0)
        n, e = shapes["x"].shape[0], shapes["edge_src"].shape[0]
        pad = Graph(n, np.concatenate([g.src, np.zeros(e - g.m, np.int32)]),
                    np.concatenate([g.dst, np.zeros(e - g.m, np.int32)]),
                    np.ones(e, np.float32))
        batch = torch_batch(gnn_flat_batch(pad, shapes["x"].shape[1], 7))
        batch["edge_mask"][g.m:] = False
    for k, v in shapes.items():
        assert tuple(batch[k].shape) == tuple(v.shape) and batch[k].dtype == v.dtype, k
    new, new_opt, m = plan.fn(params, opt, batch, torch.tensor(0, dtype=torch.int32))
    assert np.isfinite(float(m["loss"])) and int(new_opt["step"]) == 1
    for k, v in by_path(new).items():
        assert not torch.equal(v, by_path(params)[k]), k
