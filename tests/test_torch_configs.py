"""The port's architecture registry and cell plans
(``repro_torch.configs``) against the JAX package's ``repro.configs``:
the shape tables, the 47 reference cells (no exclusion is left), and
for every planned cell the argument shapes and dtypes at one rank and
``model_flops`` (equal as floats)."""

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
import repro.configs.cells as ref_cells
import repro.configs.sssp_cfg as ref_sssp
import repro_torch.configs as configs
from repro.launch.mesh import make_cpu_topology
from repro_torch.configs import cells, sssp_cfg
from torch.utils._pytree import tree_flatten_with_path, keystr


def leaves(tree, ref: bool):
    """(path, shape, dtype name) of every leaf, dict keys sorted."""
    if ref:
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return sorted((jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
                      for p, x in flat)
    flat = tree_flatten_with_path(tree)[0]
    return sorted((keystr(p), tuple(x.shape), str(x.dtype).split(".")[-1])
                  for p, x in flat)


@pytest.fixture(scope="module")
def topo():
    return make_cpu_topology(1)


def test_shape_tables_equal_the_reference():
    assert sssp_cfg.SSSP_CELLS == ref_sssp.SSSP_CELLS
    assert sssp_cfg.SHAPES == ref_sssp.SHAPES
    assert cells.LM_SHAPES == ref_cells.LM_SHAPES
    assert cells.RECSYS_SHAPES == ref_cells.RECSYS_SHAPES
    assert cells.GNN_SHAPES == ref_cells.GNN_SHAPES
    for arch, mod in configs.REGISTRY.items():
        ref = ref_configs.get_arch(arch)
        assert (mod.ARCH_ID, mod.FAMILY, list(mod.SHAPES)) == \
            (ref.ARCH_ID, ref.FAMILY, list(ref.SHAPES))
        assert configs.list_cells(arch) == ref_configs.list_cells(arch)
    assert configs.ASSIGNED == ref_configs.ASSIGNED


def test_all_cells_are_the_reference_less_the_named_15():
    """The port plans all 47 of the reference's pairs, in its order:
    31 were left out before gin-tu's four train cells planned, 27 before
    the twelve of egnn, mace and dimenet, 15 before the nine serving
    cells of minicpm3, phi3.5-moe and dbrx, 6 before the five LMs' train
    cells, 1 before MIND's train cell; none since."""
    ref = ref_configs.all_cells()
    assert configs.reference_cells() == ref and len(ref) == 47
    assert configs.all_cells() == ref and len(configs.all_cells()) == 47
    kinds = {}
    for arch, _ in configs.all_cells():
        kinds[arch] = kinds.get(arch, 0) + 1
    assert kinds == {"phi3.5-moe-42b-a6.6b": 4, "dbrx-132b": 4, "phi3-mini-3.8b": 4,
                     "minitron-8b": 4, "minicpm3-4b": 4, "mace": 4, "gin-tu": 4,
                     "egnn": 4, "dimenet": 4, "mind": 4, "sssp": 7}
    assert configs.all_cells(include_sssp=False) == ref_configs.all_cells(include_sssp=False)
    assert sorted(configs.REGISTRY) == sorted(a for a, _ in configs.REFERENCE_ARCHS)
    assert ("mind", "train_batch") in configs.all_cells()


@pytest.mark.parametrize("arch,cell", ref_configs.all_cells())
def test_plan_matches_reference_cell(arch, cell, topo):
    plan = configs.get_arch(arch).make_cell(cell, 1)
    ref = ref_configs.get_arch(arch).make_cell(cell, topo)
    assert (plan.arch, plan.cell, plan.kind) == (ref.arch, ref.cell, ref.kind)
    assert leaves(plan.args, ref=False) == leaves(ref.args, ref=True)
    assert isinstance(plan.model_flops, float)
    assert plan.model_flops == float(ref.model_flops)
    assert plan.notes == ref.notes
    ref_bytes = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                    for x in jax.tree_util.tree_leaves(ref.args))
    assert plan.arg_bytes == ref_bytes


@pytest.mark.parametrize("cell", sssp_cfg.SHAPES)
def test_sssp_reduced_and_ranked_plans(cell, topo):
    """Reduced plans equal the reference's reduced cell; at P ranks the
    arguments stack one row a rank over ceil(n / P) vertices."""
    plan = sssp_cfg.make_cell(cell, 1, reduced=True)
    ref = ref_sssp.make_cell(cell, topo, reduced=True)
    assert leaves(plan.args, ref=False) == leaves(ref.args, ref=True)
    assert plan.model_flops == float(ref.model_flops)
    kw = sssp_cfg.SSSP_CELLS[cell]
    p4 = sssp_cfg.make_cell(cell, 4)
    n_local = (1 << kw["scale"]) // 4
    rows = int(1.3 * (n_local * kw["avg_degree"] / kw["width"] + n_local))
    assert p4.shape == dict(n_parts=4, n_local=n_local, rows=rows, width=kw["width"])
    assert [tuple(t.shape) for t in p4.args] == [
        (4, rows), (4, rows, kw["width"]), (4, rows, kw["width"])] + [(4, n_local + 1)] * 3
    assert p4.ranks == 4 and p4.config == plan.config


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "minitron-8b", "mind", "gin-tu",
                                  "egnn", "dimenet", "mace", "minicpm3-4b",
                                  "phi3.5-moe-42b-a6.6b", "dbrx-132b"])
def test_train_cells_raise(arch):
    """Every train cell plans (none raises any more): MIND's
    train_batch, the four cells of each GNN arch and each LM's train_4k
    cell are train cells that carry their step, with the AdamW state and
    the labelled batch."""
    mod = configs.get_arch(arch)
    if arch in ("gin-tu", "egnn", "dimenet", "mace"):
        for cell in mod.SHAPES:
            plan = mod.make_cell(cell)
            assert plan.kind == "train" and callable(plan.fn)
        with pytest.raises(KeyError, match="unknown"):
            mod.make_cell("no_such_cell")
        return
    if mod.FAMILY == "lm":
        plan = mod.make_cell("train_4k")
        assert plan.kind == "train" and callable(plan.fn)
        params, opt, batch, step = plan.args
        assert sorted(opt) == ["m", "master", "step", "v"]
        assert {k: tuple(t.shape) for k, t in batch.items()} == {
            "tokens": (256, 4096), "labels": (256, 4096)}
        return
    plan = mod.make_cell("train_batch")
    assert plan.kind == "train" and callable(plan.fn)
    params, opt, batch, step = plan.args
    assert sorted(opt) == ["m", "master", "step", "v"]
    assert {k: tuple(t.shape) for k, t in batch.items()} == {
        "hist": (65536, 50), "hist_mask": (65536, 50), "profile_ids": (65536, 16),
        "profile_mask": (65536, 16), "target": (65536,), "negatives": (65536, 127)}
    for cell in ("serve_p99", "serve_bulk", "retrieval_cand"):
        assert mod.make_cell(cell).kind == "serve" and mod.make_cell(cell).fn is None


def test_flop_formulas_equal_the_reference():
    """The LM and MIND formulas equal the reference's (MLA's and MoE's
    too) at the cells' sizes and at another; MIND's train formula too,
    which its train_batch cell also reaches."""
    for arch in ("phi3-mini-3.8b", "minitron-8b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
                 "dbrx-132b"):
        cfg = configs.get_arch(arch).make_config()
        rcfg = ref_configs.get_arch(arch).make_config()
        assert cfg.n_params() == rcfg.n_params()
        assert cfg.n_active_params() == rcfg.n_active_params()
        for B, S in ((256, 4096), (3, 17)):
            assert cells.lm_flops_train(cfg, B, S) == ref_cells.lm_flops_train(rcfg, B, S)
            assert cells.lm_flops_prefill(cfg, B, S) == ref_cells.lm_flops_prefill(rcfg, B, S)
            assert cells.lm_flops_decode(cfg, B, S) == ref_cells.lm_flops_decode(rcfg, B, S)
    mcfg = configs.get_arch("mind").make_config()
    rmcfg = ref_configs.get_arch("mind").make_config()
    for kind in ("train", "serve", "retrieval"):
        assert cells.mind_flops(mcfg, 65536, kind, 1000) == \
            ref_cells.mind_flops(rmcfg, 65536, kind, 1000)


@pytest.mark.parametrize("cell", list(cells.GNN_SHAPES))
def test_gnn_batch_shapes_equal_the_reference(cell):
    sh = cells.GNN_SHAPES[cell]
    assert cells._pad_up(sh["e"]) == ref_cells._pad_up(sh["e"])
    if cell == "molecule":
        for tri in (False, True):
            assert leaves(cells.gnn_packed_batch_shapes(sh, triplets=tri), False) == \
                leaves(ref_cells.gnn_packed_batch_shapes(sh, triplets=tri), True)
        return
    for coords in (False, True):
        for tri in (False, True):
            assert leaves(cells.gnn_flat_batch_shapes(sh, coords=coords, triplets=tri),
                          False) == \
                leaves(ref_cells.gnn_flat_batch_shapes(sh, coords=coords, triplets=tri),
                       True)
