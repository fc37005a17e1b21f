"""The port's GIN inference against the JAX package's.

The reference's random weights go through ``gin_params_from_numpy``
and the batch comes from ``gnn_flat_batch`` (byte-identical on both
sides).  Logits must agree node by node: max_j |port - ref| <= 1e-5 x
max_j |ref| for every node i (f32 sums over in-edges in another order;
the measured gap is under 2e-6 of a node's scale).  Both of the port's
routes are held against the reference: the ``spmm_ell`` route over the
neighbour ELL (the kernel op's plain version on the CPU) and the plain
segment-sum route.  At the full widths and at the real ``full_graph_sm``
scale (2,708 nodes, 1,433 features), and with masked edges."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as ref_data
import repro.graph as ref_graph
from repro.configs import cells as ref_cells
from repro.configs import gin_tu as ref_gin_tu
from repro.models.gnn import gin as ref_gin
from repro.models.gnn import layers as ref_layers
from repro_torch.configs import cells, get_arch
from repro_torch.data import gnn_flat_batch
from repro_torch.graph import Graph, erdos_renyi_graph, rmat1
from repro_torch.models.convert import gin_params_from_numpy
from repro_torch.models.gnn import (
    gather_src,
    gin,
    neighbor_ell,
    scatter_max,
    scatter_mean,
    scatter_sum,
)
from repro_torch.models.gnn.batch import flat_batch_from_graph

NODE_REL_TOL = 1e-5
EDGE_KEYS = ("x", "edge_src", "edge_dst", "edge_mask")
gin_tu = get_arch("gin-tu")


def assert_logits_close(port, ref, tol=NODE_REL_TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    err = np.abs(port - ref).max(axis=1)
    scale = np.abs(ref).max(axis=1)
    bad = np.flatnonzero(err > tol * scale)
    assert bad.size == 0, (f"{bad.size} nodes off, worst {(err / scale).max():.3g} "
                           f"of the node's max |ref|")


def setup(g, cell, reduced=False, seed=0):
    ref_cfg = ref_gin_tu.make_config(reduced, cell)
    cfg = gin_tu.make_config(reduced, cell)
    batch = gnn_flat_batch(g, cfg.d_in, cfg.n_classes, seed=seed)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_gin.init_params(jax.random.PRNGKey(seed + 1), ref_cfg))
    return ref_cfg, cfg, batch, tree


def ref_forward(tree, batch, ref_cfg):
    return np.asarray(ref_gin.forward(tree, *(jnp.asarray(batch[k]) for k in EDGE_KEYS),
                                      ref_cfg))


def port_forward(params, batch, cfg, agg_impl):
    cfg = dataclasses.replace(cfg, agg_impl=agg_impl)
    return gin.forward(params, *(torch.tensor(batch[k]) for k in EDGE_KEYS), cfg).numpy()


# ---------------------------------------------------------------- #
# data, configs, parameters


@pytest.mark.parametrize("n,avg_degree,seed", [(50, 8.0, 0), (2708, 2.0, 0), (1000, 3.5, 7)])
def test_erdos_renyi_byte_identical(n, avg_degree, seed):
    a = erdos_renyi_graph(n, avg_degree, seed=seed)
    b = ref_graph.erdos_renyi_graph(n, avg_degree, seed=seed)
    assert (a.n, a.name) == (b.n, b.name)
    for k in ("src", "dst", "weight"):
        assert getattr(a, k).dtype == getattr(b, k).dtype
        assert getattr(a, k).tobytes() == getattr(b, k).tobytes()


@pytest.mark.parametrize("d_feat,classes,coords,seed", [
    (100, 47, False, 0), (1433, 7, True, 3), (16, 2, False, 5),
])
def test_gnn_flat_batch_byte_identical(d_feat, classes, coords, seed):
    g = rmat1(7, seed=seed)
    a = gnn_flat_batch(g, d_feat, classes, coords=coords, seed=seed)
    b = ref_data.gnn_flat_batch(g, d_feat, classes, coords=coords, seed=seed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    # with DimeNet's triplets (capped at 4 a edge, the default), the same bytes
    a = gnn_flat_batch(g, d_feat, classes, coords=coords, triplets=True, seed=seed)
    b = ref_data.gnn_flat_batch(g, d_feat, classes, coords=coords, triplets=True, seed=seed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    fb = flat_batch_from_graph(g, d_feat, classes, seed=seed)
    assert (fb.n, fb.e) == (g.n, g.m)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("cell", [*ref_gin_tu.SHAPES, "not_a_cell"])
def test_make_config_matches(cell, reduced):
    ref = dataclasses.asdict(ref_gin_tu.make_config(reduced, cell))
    port = dataclasses.asdict(gin_tu.make_config(reduced, cell))
    assert port.pop("agg_impl") == "spmm_ell"
    assert port == ref
    if cell in ref_cells.GNN_SHAPES and not reduced:
        assert gin_tu._flops(cell, gin_tu.make_config(False, cell)) == \
            ref_gin_tu._flops(cell, ref_gin_tu.make_config(False, cell))


def test_registry_and_shapes():
    assert cells.GNN_SHAPES == ref_cells.GNN_SHAPES
    assert (gin_tu.ARCH_ID, gin_tu.FAMILY, gin_tu.SHAPES) == \
        (ref_gin_tu.ARCH_ID, ref_gin_tu.FAMILY, ref_gin_tu.SHAPES)
    with pytest.raises(ValueError, match="agg_impl"):
        gin.GINConfig(agg_impl="dense")


def test_gin_params_from_numpy():
    ref_cfg, cfg, _, tree = setup(rmat1(6, seed=0), "ogb_products")
    params = gin_params_from_numpy(tree, cfg, device="cpu")
    assert len(params["layers"]) == cfg.n_layers == 5
    for lp, rp in zip(params["layers"], tree["layers"]):
        assert lp["eps"].shape == () and float(lp["eps"]) == float(rp["eps"]) == 0.0
        for k, v in rp["mlp"].items():
            assert lp["mlp"][k].dtype == torch.float32
            assert np.array_equal(lp["mlp"][k].numpy(), v)
    assert params["readout"]["w0"].shape == (64, 47)
    # the port's own init lays the tree out the same way
    own = gin.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), own) == \
        jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)
    with pytest.raises(ValueError, match="layers"):
        gin_params_from_numpy(tree, dataclasses.replace(cfg, n_layers=4), device="cpu")
    with pytest.raises(ValueError, match=r"layers\[0\].mlp"):
        gin_params_from_numpy(tree, dataclasses.replace(cfg, d_in=99), device="cpu")


@pytest.mark.parametrize("d", [1, 5])
def test_segment_ops_match_reference(d):
    """gather_src exact; the segment max bit for bit, -inf for an empty
    segment (as jax.ops.segment_max gives); sum and mean within 1e-6 of
    max |ref| (f32 sums in another order)."""
    rng = np.random.default_rng(d)
    n, E = 30, 200
    x = rng.normal(size=(40, d)).astype(np.float32)
    src = rng.integers(0, 40, E).astype(np.int32)
    idx = rng.integers(0, n - 3, E).astype(np.int32)  # the last 3 segments empty
    v = np.asarray(gather_src(torch.tensor(x), torch.tensor(src)))
    assert np.array_equal(v, np.asarray(ref_layers.gather_src(jnp.asarray(x), jnp.asarray(src))))
    for port_fn, ref_fn in ((scatter_sum, ref_layers.scatter_sum),
                            (scatter_mean, ref_layers.scatter_mean),
                            (scatter_max, ref_layers.scatter_max)):
        out = port_fn(torch.tensor(v), torch.tensor(idx), n).numpy()
        ref = np.asarray(ref_fn(jnp.asarray(v), jnp.asarray(idx), n))
        assert out.shape == ref.shape == (n, d)
        if port_fn is scatter_max:
            assert np.array_equal(out.view(np.int32), ref.view(np.int32))
            assert np.all(out[n - 3:] == -np.inf)
        else:
            assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
            assert np.all(out[n - 3:] == 0)


# ---------------------------------------------------------------- #
# forward


@pytest.mark.parametrize("agg_impl", gin.AGG_IMPLS)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_forward_matches_reference_on_tiny_graphs(tiny_graphs, agg_impl, reduced):
    """Full: ogb_products widths (d_in 100, 5 x 64, 47 classes)."""
    fat = False
    for i, g in enumerate(tiny_graphs):
        ref_cfg, cfg, batch, tree = setup(g, "ogb_products", reduced, seed=i)
        params = gin_params_from_numpy(tree, cfg, device="cpu")
        assert_logits_close(port_forward(params, batch, cfg, agg_impl),
                            ref_forward(tree, batch, ref_cfg))
        ell = neighbor_ell(*(torch.tensor(batch[k]) for k in EDGE_KEYS[1:]), g.n)
        fat |= ell.col.shape[0] > g.n
    assert fat  # some vertex's in-edges span several ELL rows (rmat1)


@pytest.mark.parametrize("agg_impl", gin.AGG_IMPLS)
def test_forward_matches_reference_at_full_graph_sm_scale(agg_impl):
    g = erdos_renyi_graph(2708, 2.0, seed=0)  # 10,828 directed edges
    ref_cfg, cfg, batch, tree = setup(g, "full_graph_sm")
    assert batch["x"].shape == (2708, 1433) and cfg.n_layers == 5
    params = gin_params_from_numpy(tree, cfg, device="cpu")
    assert_logits_close(port_forward(params, batch, cfg, agg_impl),
                        ref_forward(tree, batch, ref_cfg))


@pytest.mark.parametrize("agg_impl", gin.AGG_IMPLS)
def test_masked_edges_change_nothing(agg_impl):
    """A masked edge counts 0: the logits equal those of the graph
    without it (within the tolerance: its ELL has other rows, so other
    sums), and the reference's with the mask."""
    g = rmat1(8, seed=4)
    ref_cfg, cfg, batch, tree = setup(g, "ogb_products", seed=2)
    keep = np.random.default_rng(0).random(g.m) > 0.3
    batch["edge_mask"] = keep
    params = gin_params_from_numpy(tree, cfg, device="cpu")
    out = port_forward(params, batch, cfg, agg_impl)
    assert_logits_close(out, ref_forward(tree, batch, ref_cfg))
    pruned = Graph(g.n, g.src[keep], g.dst[keep], g.weight[keep])
    kept = gnn_flat_batch(pruned, cfg.d_in, cfg.n_classes, seed=2)
    assert np.array_equal(kept["x"], batch["x"])
    assert_logits_close(out, port_forward(params, kept, cfg, agg_impl))


def test_node_classification_loss_matches_reference():
    g = rmat1(8, seed=1)
    ref_cfg, cfg, batch, tree = setup(g, "ogb_products", reduced=True, seed=3)
    params = gin_params_from_numpy(tree, cfg, device="cpu")
    ref = float(ref_gin.node_classification_loss(
        tree, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg))
    port = float(gin.node_classification_loss(
        params, {k: torch.tensor(v) for k, v in batch.items()}, cfg))
    assert np.isfinite(ref) and abs(port - ref) <= 1e-5 * abs(ref)
