"""EGNN, MACE and DimeNet on the port against the JAX package's, on
the CPU: forward, losses and gradients of both aggregation routes
(``agg_impl`` "spmm_ell", the kernel op's plain version here, and
"segment_sum"), on batches with and without a block's padding (masked
edges 0 -> 0, masked triplets (0, 0)), the block-diagonal molecule
losses against the reference's ``vmap``, one AdamW step of each reduced
molecule cell, E(3) invariance, the launch and ELL-build counts of a
train step, and, call site by call site, the precondition of
``gather_rows``'s backward: no gradient at a masked row.

The reference's weights go through ``*_params_from_numpy`` and every
batch is byte-identical on both sides; the reference runs jitted
(``jax.value_and_grad``), shared through module-scoped fixtures.
Tolerances:
- f32 outputs and losses: 1e-5 of max |out| (f32 sums over edges and
  triplets in another order, and XLA's fused matmuls);
- f32 gradients: 1e-4 of each leaf's max |grad| (each a sum over every
  edge or triplet, carried back through 2 to 6 layers);
- DimeNet with ``msg_dtype="bfloat16"``: 2e-2, on outputs, losses and
  gradients.  Messages round to bf16 (2^-8 relative) at each block; the
  port sums them in f32 where the reference sums in bf16;
- params after one AdamW step: a tenth of that step's learning rate
  (Adam moves an element by about lr whatever its gradient);
- invariance under a rotation and translation of the coordinates: 1e-4
  of |energy| (f32 geometry of rotated coordinates).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as ref_data
import repro.train as R
from repro.configs import dimenet_cfg as ref_dimenet_cfg
from repro.configs import egnn_cfg as ref_egnn_cfg
from repro.configs import mace_cfg as ref_mace_cfg
from repro.models.gnn import dimenet as ref_dimenet
from repro.models.gnn import egnn as ref_egnn
from repro.models.gnn import mace as ref_mace
import repro_torch.train as T
from repro_torch.configs import get_arch
from repro_torch.data import gnn_flat_batch, molecule_batch
from repro_torch.graph import Graph, erdos_renyi_graph, rmat1
from repro_torch.kernels import _lib
from repro_torch.kernels.spmm_ell import kernel as spmm_kernel
from repro_torch.models import convert
from repro_torch.models.gnn import dimenet, egnn, mace, segment_ell, segment_transpose
from repro_torch.models.gnn import ell as ell_mod
from repro_torch.models.gnn import layers
from repro_torch.models.gnn.layers import AGG_IMPLS, block_diagonal
from repro_torch.train.checkpoint import _flatten_with_paths as by_path
from repro_torch.train.train_step import value_and_grad

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
INVARIANCE_TOL = 1e-4

MODELS = {
    "egnn": (egnn, ref_egnn, ref_egnn_cfg, convert.egnn_params_from_numpy),
    "mace": (mace, ref_mace, ref_mace_cfg, convert.mace_params_from_numpy),
    "dimenet": (dimenet, ref_dimenet, ref_dimenet_cfg, convert.dimenet_params_from_numpy),
}
FLAT_CELL = "ogb_products"  # d_feat 100, 47 classes (MACE's reduced d_in stays 10)


def configs(name, reduced, cell, **kw):
    _, _, ref_cfg_mod, _ = MODELS[name]
    ref = dataclasses.replace(ref_cfg_mod.make_config(reduced, cell), **kw)
    port = dataclasses.replace(get_arch(name).make_config(reduced, cell), **kw)
    return ref, port


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def flat_batch(name, cfg, g, seed=0):
    return gnn_flat_batch(g, cfg.d_in, max(cfg.n_classes, 2), coords=True,
                          triplets=name == "dimenet", triplet_cap=2, seed=seed)


def ref_forward(name, tree, batch, cfg):
    _, ref_mod, _, _ = MODELS[name]
    keys = ["x", "coords", "edge_src", "edge_dst", "edge_mask"]
    if name == "dimenet":
        keys += ["tri_kj", "tri_ji", "tri_mask"]
    out = jax.jit(lambda t, b: ref_mod.forward(t, *(b[k] for k in keys), cfg))(
        tree, jax_batch(batch))
    return out, keys


def assert_close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape and np.isfinite(a).all(), what
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, (what, float(np.abs(a - b).max() / scale))


def assert_grads_close(port, ref, tol):
    p, r = by_path(port), by_path(ref)
    assert sorted(p) == sorted(r)
    for k in p:
        assert_close(p[k].numpy(), r[k], tol, k)


@dataclasses.dataclass
class Case:
    name: str
    ref_cfg: object
    cfg: object
    batch: dict
    tree: dict
    loss: float
    grads: dict
    tol: float


def make_case(name, reduced, cell, batch, seed=1, **kw) -> Case:
    _, ref_mod, _, _ = MODELS[name]
    ref_cfg, cfg = configs(name, reduced, cell, **kw)
    tree = jax.tree_util.tree_map(np.asarray, ref_mod.init_params(jax.random.PRNGKey(seed),
                                                                  ref_cfg))
    loss = (ref_mod.regression_loss if cell == "molecule"
            else ref_mod.node_classification_loss)
    rl, rg = jax.jit(jax.value_and_grad(lambda t, b: loss(t, b, ref_cfg)))(
        tree, jax_batch(batch))
    tol = BF16_TOL if kw.get("msg_dtype") == "bfloat16" else None
    return Case(name, ref_cfg, cfg, batch, tree, float(rl), rg, tol)


def port_loss_and_grads(case: Case, agg_impl):
    mod, _, _, conv = MODELS[case.name]
    cfg = dataclasses.replace(case.cfg, agg_impl=agg_impl)
    loss = mod.regression_loss if "y" in case.batch else mod.node_classification_loss
    params = conv(case.tree, cfg, device="cpu")
    pl, pg = value_and_grad(lambda p, b: loss(p, b, cfg))(params, torch_batch(case.batch))
    return float(pl), pg


def check(case: Case, agg_impl):
    pl, pg = port_loss_and_grads(case, agg_impl)
    assert abs(pl - case.loss) <= (case.tol or OUT_TOL) * abs(case.loss), (pl, case.loss)
    assert_grads_close(pg, case.grads, case.tol or GRAD_TOL)


@pytest.fixture(scope="module")
def molecule_cases():
    batch = ref_data.molecule_batch(0, 4, 10, 20, triplets=True, triplet_pad=128, seed=3)
    return {name: make_case(name, True, "molecule", batch) for name in MODELS}


@pytest.fixture(scope="module")
def flat_cases():
    g = rmat1(8, seed=2)
    out = {}
    for name in MODELS:
        _, cfg = configs(name, True, FLAT_CELL)
        out[name] = make_case(name, True, FLAT_CELL, flat_batch(name, cfg, g), seed=2)
    return out


@pytest.fixture(scope="module")
def full_width_cases():
    """The published widths on a 20-node graph (DimeNet's flat cells
    take bf16 messages)."""
    g = erdos_renyi_graph(20, 3.0, seed=4)
    out = {}
    for name in MODELS:
        _, cfg = configs(name, False, FLAT_CELL)
        out[name] = make_case(name, False, FLAT_CELL, flat_batch(name, cfg, g), seed=5)
    out["dimenet"].tol = BF16_TOL
    return out


def padded_flat_batch(name, cfg, pad=64, seed=6):
    """A flat batch with a sampled block's padding: rmat1 scale 7 and
    ``pad`` masked edges 0 -> 0; DimeNet's triplets of the padded edge
    list (capped at 2, so live triplets name masked edges, as on the
    card's minibatch_lg block), then ``pad`` masked (0, 0) slots."""
    g = rmat1(7, seed=seed)
    zeros = np.zeros(pad, np.int32)
    padded = Graph(g.n, np.concatenate([g.src, zeros]), np.concatenate([g.dst, zeros]),
                   np.ones(g.m + pad, np.float32))
    batch = flat_batch(name, cfg, padded, seed=seed)
    batch["edge_mask"][g.m:] = False
    if name == "dimenet":
        for k, v in (("tri_kj", zeros), ("tri_ji", zeros), ("tri_mask", zeros.astype(bool))):
            batch[k] = np.concatenate([batch[k], v])
    return batch


def padded_molecule_batch():
    """4 graphs of 10 atoms in 25 edge slots: 20 live edges and 5 masked
    0 -> 0 a graph, triplets of every slot, padded to 128 and masked."""
    return molecule_batch(0, 4, 10, 25, triplets=True, triplet_pad=128, seed=5)


@pytest.fixture(scope="module")
def padded_cases():
    out = {}
    for name in MODELS:
        _, cfg = configs(name, True, FLAT_CELL)
        out[name] = make_case(name, True, FLAT_CELL, padded_flat_batch(name, cfg), seed=7)
    return out


# ---------------------------------------------------------------- #
# forward, losses and gradients against the reference


@pytest.mark.parametrize("agg_impl", AGG_IMPLS)
@pytest.mark.parametrize("name", list(MODELS))
def test_molecule_loss_and_grads(molecule_cases, name, agg_impl):
    """The block-diagonal molecule loss against the reference's vmap."""
    check(molecule_cases[name], agg_impl)


@pytest.mark.parametrize("agg_impl", AGG_IMPLS)
@pytest.mark.parametrize("name", list(MODELS))
def test_node_classification_loss_and_grads(flat_cases, name, agg_impl):
    check(flat_cases[name], agg_impl)


@pytest.mark.parametrize("agg_impl", AGG_IMPLS)
@pytest.mark.parametrize("name", list(MODELS))
def test_full_width_loss_and_grads(full_width_cases, name, agg_impl):
    check(full_width_cases[name], agg_impl)


@pytest.mark.parametrize("agg_impl", AGG_IMPLS)
@pytest.mark.parametrize("name", list(MODELS))
def test_padded_loss_and_grads(padded_cases, name, agg_impl):
    """A block's padding: the kernel route's segment ELLs hold no masked
    row and its gathers drop g's masked rows, within the same tolerances."""
    check(padded_cases[name], agg_impl)


@pytest.mark.parametrize("agg_impl", AGG_IMPLS)
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_reference(flat_cases, name, agg_impl):
    """Node features (and EGNN's coordinates) of the forward."""
    case = flat_cases[name]
    mod, _, _, conv = MODELS[name]
    cfg = dataclasses.replace(case.cfg, agg_impl=agg_impl)
    want, keys = ref_forward(name, case.tree, case.batch, case.ref_cfg)
    tb = torch_batch(case.batch)
    with torch.no_grad():
        got = mod.forward(conv(case.tree, cfg, device="cpu"), *(tb[k] for k in keys), cfg)
    for a, b in zip(*((got, want) if name == "egnn" else ((got,), (want,)))):
        assert_close(a.numpy(), b, OUT_TOL, name)


@pytest.mark.parametrize("agg_impl", AGG_IMPLS)
def test_dimenet_bf16_messages(agg_impl):
    """Reduced DimeNet with bf16 messages: forward and loss within
    BF16_TOL, on a flat graph."""
    g = rmat1(7, seed=6)
    _, cfg = configs("dimenet", True, FLAT_CELL, msg_dtype="bfloat16")
    case = make_case("dimenet", True, FLAT_CELL, flat_batch("dimenet", cfg, g), seed=6,
                     msg_dtype="bfloat16")
    check(case, agg_impl)
    want, keys = ref_forward("dimenet", case.tree, case.batch, case.ref_cfg)
    c = dataclasses.replace(case.cfg, agg_impl=agg_impl)
    tb = torch_batch(case.batch)
    with torch.no_grad():
        got = dimenet.forward(convert.dimenet_params_from_numpy(case.tree, c, device="cpu"),
                              *(tb[k] for k in keys), c)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, BF16_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_block_diagonal_equals_a_loop_over_graphs(molecule_cases, name):
    """The port's own per-graph energies, one forward a graph, against
    its block-diagonal regression loss."""
    case = molecule_cases[name]
    mod, _, _, conv = MODELS[name]
    params = conv(case.tree, case.cfg, device="cpu")
    tb = torch_batch(case.batch)
    keys = ["x", "coords", "edge_src", "edge_dst", "edge_mask"]
    if name == "dimenet":
        keys += ["tri_kj", "tri_ji", "tri_mask"]
    with torch.no_grad():
        e = torch.stack([mod.energy(params, *(tb[k][b] for k in keys), case.cfg)
                         for b in range(tb["x"].shape[0])])
        loop = torch.mean((e - tb["y"]) ** 2)
        block = mod.regression_loss(params, tb, case.cfg)
    assert abs(float(loop) - float(block)) <= OUT_TOL * abs(float(loop))
    flat = block_diagonal(tb)
    assert flat is block_diagonal(tb)  # kept for the batch
    if name == "dimenet":  # triplets name edges: graph b's shift by b e
        e_slots = tb["edge_src"].shape[1]
        assert torch.equal(flat["tri_ji"].reshape(4, -1) - tb["tri_ji"],
                           (torch.arange(4) * e_slots)[:, None].expand(4, tb["tri_ji"].shape[1])
                           .to(torch.int32))


@pytest.mark.parametrize("name", list(MODELS))
def test_one_adamw_step_of_the_reduced_molecule_cell(molecule_cases, name):
    """The cell plan's step (``TrainConfig()``: AdamW lr 3e-4, warmup
    100, clip 1.0) at step 50 against the reference's jitted
    ``build_train_step`` of the same loss."""
    case = molecule_cases[name]
    mod, ref_mod, _, conv = MODELS[name]
    plan = get_arch(name).make_cell("molecule", reduced=True)
    rstep = jax.jit(R.build_train_step(
        lambda p, b: ref_mod.regression_loss(p, b, case.ref_cfg), R.TrainConfig()))
    rp = jax.tree_util.tree_map(jnp.asarray, case.tree)
    rp, _, rm = rstep(rp, R.init_train_state(rp, R.TrainConfig()), jax_batch(case.batch),
                      jnp.int32(50))
    pp = conv(case.tree, case.cfg, device="cpu")
    pp, ps, pm = plan.fn(pp, T.init_train_state(pp, T.TrainConfig()),
                         torch_batch(case.batch), 50)
    lr = float(rm["lr"]) if "lr" in rm else 3e-4
    for k, a in by_path(pp).items():
        np.testing.assert_allclose(a.numpy(), np.asarray(by_path(rp)[k]), atol=0.1 * lr,
                                   err_msg=k)
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=OUT_TOL)
    assert int(ps["step"]) == 1


# ---------------------------------------------------------------- #
# equivariance


def rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


@pytest.mark.parametrize("name", list(MODELS))
def test_energy_is_e3_invariant(molecule_cases, name):
    """A rotation and a translation of the coordinates leave every
    graph's energy as it was (and EGNN's coordinates rotate and shift
    with them)."""
    case = molecule_cases[name]
    mod, _, _, conv = MODELS[name]
    params = conv(case.tree, case.cfg, device="cpu")
    tb = torch_batch(case.batch)
    moved = dict(tb, coords=tb["coords"] @ torch.tensor(rotation(7)).T
                 + torch.tensor([1.5, -2.0, 0.25]))
    keys = ["x", "coords", "edge_src", "edge_dst", "edge_mask"]
    if name == "dimenet":
        keys += ["tri_kj", "tri_ji", "tri_mask"]
    with torch.no_grad():
        for b in range(tb["x"].shape[0]):
            e0 = mod.energy(params, *(tb[k][b] for k in keys), case.cfg)
            e1 = mod.energy(params, *(moved[k][b] for k in keys), case.cfg)
            assert abs(float(e1 - e0)) <= INVARIANCE_TOL * abs(float(e0)), (b, e0, e1)
        if name == "egnn":
            rot, shift = torch.tensor(rotation(7)), torch.tensor([1.5, -2.0, 0.25])
            for b in range(tb["x"].shape[0]):
                _, c0 = egnn.forward(params, *(tb[k][b] for k in keys), case.cfg)
                _, c1 = egnn.forward(params, *(moved[k][b] for k in keys), case.cfg)
                assert_close((c0 @ rot.T + shift).numpy(), c1.numpy(), INVARIANCE_TOL)


# ---------------------------------------------------------------- #
# launches and ELL builds a step


LAUNCHES = {  # spmm_ell vertex sums a step at L layers (blocks): the sums forward, their
    # backward, and the gathers' backward (of inputs that need a gradient)
    "egnn": lambda L: 2 * L + (2 * L - 1) + 4 * (L - 1),  # the last layer's coordinates
    # reach no loss; the first layer's h and coordinates are the batch's
    "mace": lambda L: 2 * L + L,  # W h at edge_src a layer; the coordinates are the batch's
    "dimenet": lambda L: 4 * L + 2 + L,  # h at both ends of the edges, m at tri_kj a block
}
BUILDS = {"egnn": 3, "mace": 3, "dimenet": 6}  # segment ELLs: forward and transpose each


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_launches_and_ell_builds(monkeypatch, name):
    """Three steps of the reduced molecule cell's plan: every step sums
    LAUNCHES times through the spmm_ell op; the segment ELLs (DimeNet's
    of tri_ji, edge_dst, tri_kj and edge_src, the others' of edge_dst and
    edge_src), forward and, for the sums, transposed, are built in the
    first step only; the vertex plans of a DimeNet step's six ELLs stay
    in the plan memo."""
    builds = []
    for f in ("build_segment_ell", "build_segment_transpose"):
        monkeypatch.setattr(ell_mod, f,
                            lambda *a, real=getattr(ell_mod, f): builds.append(1) or real(*a))
    mod = get_arch(name)
    plan, cfg = mod.make_cell("molecule", reduced=True), mod.make_config(True, "molecule")
    params = MODELS[name][0].init_params(torch.Generator().manual_seed(0), cfg)
    opt = T.init_train_state(params, T.TrainConfig())
    batch = torch_batch(molecule_batch(0, 4, 10, 20, triplets=name == "dimenet",
                                       triplet_pad=128, seed=1))
    L = cfg.n_blocks if name == "dimenet" else cfg.n_layers
    for i in range(3):
        before = _lib.call_counts()["spmm_ell"]["ref"]
        params, opt, m = plan.fn(params, opt, batch, i)
        assert _lib.call_counts()["spmm_ell"]["ref"] - before == LAUNCHES[name](L)
        assert len(builds) == BUILDS[name], (i, len(builds))
        assert np.isfinite(float(m["loss"]))
    if name == "dimenet":
        flat = block_diagonal(batch)
        E, N = flat["edge_src"].shape[0], flat["x"].shape[0]
        tri = (flat["tri_ji"], flat["tri_mask"], E)
        kj = (flat["tri_kj"], flat["tri_mask"], E)
        edge = (flat["edge_dst"], flat["edge_mask"], N)
        src = (flat["edge_src"], flat["edge_mask"], N)
        order = [(tri, segment_ell, 128 * 4), (edge, segment_ell, E),
                 (edge, segment_transpose, N), (tri, segment_transpose, E),
                 (kj, segment_ell, 128 * 4), (src, segment_ell, E)]
        ells = [way(*args) for args, way, _ in order]
        assert len(builds) == BUILDS[name]
        plans = [spmm_kernel.vertex_plan(torch.empty(n_x, 1), e.col, e.row_ptr, e.deg, 2)
                 for e, (_, _, n_x) in zip(ells, order)]
        for _ in range(2):
            for e, (_, _, n_x), p in zip(ells, order, plans):
                assert spmm_kernel.vertex_plan(torch.empty(n_x, 1), e.col, e.row_ptr,
                                               e.deg, 2) is p


GATHER_SITES = {"egnn": 4, "mace": 3, "dimenet": 6}  # gather_rows calls in a forward


def gather_site(module) -> tuple:
    """The lines of the frames from gather_rows's caller up to
    ``module``'s forward: one call site of the forward."""
    frame, lines = sys._getframe(2), []
    while frame is not None:
        lines.append(frame.f_lineno)
        if frame.f_code.co_name == "forward" and frame.f_globals is vars(module):
            return tuple(lines)
        frame = frame.f_back
    raise AssertionError("gather_rows called outside the model's forward")


@pytest.mark.parametrize("cell", ["molecule", "flat"])
@pytest.mark.parametrize("name", list(MODELS))
def test_gathers_get_no_gradient_at_masked_rows(monkeypatch, name, cell):
    """The precondition of ``gather_rows``'s backward on the kernel
    route, call site by call site: on a batch with a block's padding,
    the features and coordinates needing a gradient too, the gradient
    that reaches each gathered tensor is exactly 0 at every masked row.
    The params are moved off their init (zero biases would make DimeNet's
    messages at a masked edge 0 and hide a live triplet naming it).
    Every site is reached; the inputs' gradients equal the segment-sum
    route's within GRAD_TOL."""
    mod = MODELS[name][0]
    seen = {}
    real = layers.gather_rows

    def hooked(x, index, mask, agg_impl="spmm_ell"):
        out = real(x, index, mask, agg_impl)
        if out.requires_grad:
            grads = seen.setdefault(gather_site(mod), [])
            out.register_hook(lambda g: grads.append((g, mask)))
        return out

    monkeypatch.setattr(mod, "gather_rows", hooked)
    _, cfg = configs(name, True, "molecule" if cell == "molecule" else FLAT_CELL)
    gen = torch.Generator().manual_seed(3)
    params = torch.utils._pytree.tree_map(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=gen), mod.init_params(gen, cfg))
    raw = padded_molecule_batch() if cell == "molecule" else padded_flat_batch(name, cfg)
    loss = mod.regression_loss if cell == "molecule" else mod.node_classification_loss
    grads = {}
    for agg_impl in AGG_IMPLS:
        batch = torch_batch(raw)
        inputs = [batch["x"].requires_grad_(True), batch["coords"].requires_grad_(True)]
        c = dataclasses.replace(cfg, agg_impl=agg_impl)
        grads[agg_impl] = torch.autograd.grad(loss(params, batch, c), inputs)
    assert len(seen) == GATHER_SITES[name], sorted(seen)
    for site, got in seen.items():
        for g, mask in got:
            assert not bool(mask.all()), site  # the site has masked rows
            assert bool((g[~mask] == 0).all()), (site, float(g[~mask].abs().max()))
    for a, b in zip(grads["spmm_ell"], grads["segment_sum"]):
        assert_close(a.numpy(), b.numpy(), GRAD_TOL)


# ---------------------------------------------------------------- #
# the cells


@pytest.mark.parametrize("name,cell", [("egnn", "molecule"), ("mace", "molecule"),
                                       ("dimenet", "molecule"), ("egnn", "full_graph_sm"),
                                       ("dimenet", "full_graph_sm")])
def test_cell_step_runs_on_tensors_of_its_shapes(name, cell):
    """The plan's step on real tensors of the plan's shapes (reduced
    widths): the molecule batch, or a Cora-sized ER graph padded to the
    cell's node, edge and triplet counts with masked entries; the loss
    finite, every param moved.  (MACE's reduced config keeps d_in 10 on
    every cell, as the reference's does, so its flat cells take no
    1433-wide features.)"""
    mod = get_arch(name)
    plan, cfg = mod.make_cell(cell, reduced=True), mod.make_config(True, cell)
    params = MODELS[name][0].init_params(torch.Generator().manual_seed(0), cfg)
    shapes = plan.args[2]
    if cell == "molecule":
        batch = torch_batch(molecule_batch(0, 128, 30, 64, triplets=name == "dimenet"))
    else:
        g = erdos_renyi_graph(2708, 1.9, seed=0)
        n, e = shapes["x"].shape[0], shapes["edge_src"].shape[0]
        pad = Graph(n, np.concatenate([g.src, np.zeros(e - g.m, np.int32)]),
                    np.concatenate([g.dst, np.zeros(e - g.m, np.int32)]),
                    np.ones(e, np.float32))
        batch = torch_batch(gnn_flat_batch(pad, shapes["x"].shape[1], cfg.n_classes,
                                           coords=True, triplets=name == "dimenet",
                                           triplet_cap=2))
        batch["edge_mask"][g.m:] = False
        if name == "dimenet":
            t = shapes["tri_kj"].shape[0]
            live = batch["tri_kj"].shape[0]
            for k in ("tri_kj", "tri_ji", "tri_mask"):
                batch[k] = torch.cat([batch[k], batch[k].new_zeros(t - live)])
    for k, v in shapes.items():
        assert tuple(batch[k].shape) == tuple(v.shape) and batch[k].dtype == v.dtype, k
    new, new_opt, m = plan.fn(params, T.init_train_state(params, T.TrainConfig()), batch,
                              torch.tensor(0, dtype=torch.int32))
    assert np.isfinite(float(m["loss"])) and int(new_opt["step"]) == 1
    # EGNN's last coordinate update reaches no loss (as in the reference):
    # its zero biases get no gradient, and weight decay leaves zeros
    still = {f"layers/{cfg.n_layers - 1}/phi_x/b{i}" for i in range(2)} if name == "egnn" else set()
    for k, v in by_path(new).items():
        assert torch.equal(v, by_path(params)[k]) == (k in still), k


def test_converters_check_every_shape():
    _, cfg = configs("dimenet", True, "molecule")
    tree = jax.tree_util.tree_map(
        np.asarray, ref_dimenet.init_params(jax.random.PRNGKey(0),
                                            ref_dimenet_cfg.make_config(True, "molecule")))
    convert.dimenet_params_from_numpy(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="w_sbf"):
        convert.dimenet_params_from_numpy(tree, dataclasses.replace(cfg, n_bilinear=3),
                                          device="cpu")
    with pytest.raises(ValueError, match="entries"):
        convert.dimenet_params_from_numpy(tree, dataclasses.replace(cfg, n_blocks=3),
                                          device="cpu")
    _, ecfg = configs("egnn", True, "molecule")
    etree = jax.tree_util.tree_map(
        np.asarray, ref_egnn.init_params(jax.random.PRNGKey(0),
                                         ref_egnn_cfg.make_config(True, "molecule")))
    with pytest.raises(ValueError, match="phi_e"):
        convert.egnn_params_from_numpy(etree, dataclasses.replace(ecfg, d_in=11),
                                       device="cpu")
    _, mcfg = configs("mace", True, "molecule")
    mtree = jax.tree_util.tree_map(
        np.asarray, ref_mace.init_params(jax.random.PRNGKey(0),
                                         ref_mace_cfg.make_config(True, "molecule")))
    with pytest.raises(ValueError, match="radial"):
        convert.mace_params_from_numpy(mtree, dataclasses.replace(mcfg, n_rbf=6),
                                       device="cpu")
