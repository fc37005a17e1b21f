"""LM training across ranks (``models/lm.py::lm_loss`` under a
``Topology``, ``train/``'s step, norm, compression and checkpoints
across ranks): gloo processes on the CPU, f32, at the reduced phi3-mini
(dense GQA) and phi3.5-moe (MoE, 4 experts top-2) configs with their
vocab rounded up to a multiple of 4, as ``tests/test_torch_lm_shard.py``
does.  One spawn a world size runs every grid of that size
(``launch/lm_shard.py``'s jobs, ``launch/train.py::run_job``): 2 ranks as
tp 2 and as dp 2, 4 ranks as dp 2 x tp 2, with ``seq_shard_resid`` True
and False.  Every rank's gradient blocks are put back together by their
specs (``convert.unshard_tree``).  The batch is ``lm_batch``'s with every
fifth label masked, the same count in every row, so that the mean over
the whole batch is the mean of the dp ranks' means.

- Against the one-rank port on the same weights and batch: the loss
  within 1e-6 of its value and every gradient leaf within 1e-5 of its max
  |grad|; at dp > 1 a MoE run against the mean of one-rank runs on each
  dp rank's rows (its aux loss is each dp rank's, averaged).  The losses
  of 3 AdamW steps within 1e-5 with ``microbatches=2`` and with
  ``compress_accum``: losses, not weights (a gradient under Adam's eps
  moves a weight by up to lr between two summation orders).
- Against the JAX package (its weights through ``convert.py``; its
  ``value_and_grad(lm_loss)`` on a one-device Auto-axis mesh, since its
  sharded program fails under this jax, ROADMAP Queue 3): GQA at every
  grid within 1e-5 of a leaf's max |grad|; MoE at dp 2 against the mean
  of the reference's gradients on each dp rank's rows.
- ``compressed_psum`` at dp 4 against the reference's under
  ``shard_map`` over 4 forced host devices (a subprocess): codes and
  scales equal, the sums within f32 rounding, the error trees equal.
- ``state_specs`` equal to the reference's leaf for leaf, and the train
  cells' planned bytes those of the reference's specs at 1, 4 and 256
  ranks.
- A train state saved at dp 2 x tp 2 after step 1 restores at tp 2, in
  one process and in the JAX package's ``Checkpointer``, each going on
  to the uninterrupted run's next loss.
- ``launch/train.py --ranks 4 --tp 2`` trains to the losses of
  ``--ranks 1``; what cannot split is refused before any work.
"""

import dataclasses
import functools
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, PartitionSpec

import repro.train as R
import repro_torch.train as T
from repro.configs import get_arch as ref_get_arch
from repro.models import lm as ref_lm
from repro.models.common import Topology as RefTopology
from repro_torch.configs import get_arch
from repro_torch.configs.cells import lm_cell
from repro_torch.data import lm_batch
from repro_torch.launch import lm_shard
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import lm_grid, make_cpu_topology, make_topology, spawn_ranks
from repro_torch.models import lm
from repro_torch.models.convert import tree_to_numpy, unshard_tree
from repro_torch.train.checkpoint import _flatten_with_paths as by_path

from lm_train_shard_calls import compressed_psum_rank

GQA, MOE = "phi3-mini-3.8b", "phi3.5-moe-42b-a6.6b"
VOCAB = {GQA: 196, MOE: 200}
B, S = 4, 16
LOSS_RTOL, GRAD_TOL, STEP_RTOL = 1e-6, 1e-5, 1e-5
STEPS = 3
LM_ARCHS = ("phi3-mini-3.8b", "minitron-8b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b", "dbrx-132b")
HERE = os.path.dirname(os.path.abspath(__file__))

# (name, world, arch, tp, seq_shard_resid): the gradient cases
GRADS = [
    ("gqa tp2 sp", 2, GQA, 2, True), ("gqa tp2", 2, GQA, 2, False),
    ("moe tp2 sp", 2, MOE, 2, True), ("moe tp2", 2, MOE, 2, False),
    ("gqa dp2", 2, GQA, 1, True), ("moe dp2", 2, MOE, 1, True),
    ("gqa dp2tp2 sp", 4, GQA, 2, True), ("gqa dp2tp2", 4, GQA, 2, False),
    ("moe dp2tp2 sp", 4, MOE, 2, True), ("moe dp2tp2", 4, MOE, 2, False),
]
# (name, world, arch, tp, seq_shard_resid, train config): 3 steps each
STEPPED = [
    ("gqa dp2tp2 sp micro2", 4, GQA, 2, True, {"microbatches": 2}),
    ("gqa dp2tp2 compress", 4, GQA, 2, False, {"microbatches": 2, "compress_accum": True}),
    ("moe tp2 sp micro2", 2, MOE, 2, True, {"microbatches": 2}),
]
TRAIN = {"warmup_steps": 2, "total_steps": 10}
ADAMW = {"lr": 1e-3}


def over(arch, sp=True):
    return {"vocab": VOCAB[arch], "seq_shard_resid": sp}


def port_config(arch, sp=True):
    return lm_shard.job_config(dict(arch=arch, reduced=True, over=over(arch, sp)))


def ref_config(arch):
    return dataclasses.replace(ref_get_arch(arch).make_config(reduced=True), vocab=VOCAB[arch])


@functools.cache
def ref_tree(arch):
    tree = ref_lm.init_params(jax.random.PRNGKey(7), ref_config(arch))
    return jax.tree_util.tree_map(np.asarray, tree)


def batch(arch, step=0, rows=slice(None)):
    b = lm_batch(step, B, S, VOCAB[arch], seed=3)
    b["labels"] = b["labels"].copy()
    b["labels"][:, ::5] = -1  # the same count of labels in every row
    return {k: v[rows] for k, v in b.items()}


def dp_rows(world, tp):
    dp = world // tp
    return [slice(i * B // dp, (i + 1) * B // dp) for i in range(dp)]


def job(arch, tp, sp, tree, **kw):
    return dict(kind="train", arch=arch, reduced=True, over=over(arch, sp), tp=tp, tree=tree,
                adamw=ADAMW, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(world, name): every rank's results}: one spawn a world size, 4
    ranks first (the 2-rank world restores its checkpoint); the
    reference's compressed_psum runs in a subprocess meanwhile."""
    tmp = tmp_path_factory.mktemp("lm_train_shard")
    trees = {}
    for arch in (GQA, MOE):
        trees[arch] = str(tmp / f"{arch}.npz")
        lm_shard.save_tree(ref_tree(arch), trees[arch])
    psum_in, psum_out = str(tmp / "psum_in.npz"), str(tmp / "psum_out.npz")
    r = np.random.default_rng(0)
    np.savez(psum_in, **{"g/a": r.standard_normal((4, 8, 6)).astype(np.float32),
                         "g/b": r.standard_normal((4, 5)).astype(np.float32),
                         "e/a": (1e-3 * r.standard_normal((4, 8, 6))).astype(np.float32),
                         "e/b": (1e-3 * r.standard_normal((4, 5))).astype(np.float32)})
    src = os.path.join(os.path.dirname(HERE), "src")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ref_psum = subprocess.Popen([sys.executable, "-c", REF_PSUM, psum_in, psum_out], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ckpt = str(tmp / "ckpt")
    jobs = {2: [], 4: []}
    names = {2: [], 4: []}
    for name, world, arch, tp, sp in GRADS:
        jobs[world].append(job(arch, tp, sp, trees[arch], batches=[batch(arch)], grads=(0,)))
        names[world].append(name)
    for name, world, arch, tp, sp, tc in STEPPED:
        jobs[world].append(job(arch, tp, sp, trees[arch], train=dict(TRAIN, **tc),
                               batches=[batch(arch, s) for s in range(STEPS)]))
        names[world].append(name)
    # the uninterrupted run saves after step 1; the 2-rank world resumes
    jobs[4].append(job(GQA, 2, True, trees[GQA], train=TRAIN, save=(ckpt, 1),
                       batches=[batch(GQA, s) for s in range(2)]))
    names[4].append("ckpt dp2tp2")
    jobs[2].append(job(GQA, 2, True, None, train=TRAIN, restore=ckpt, batches=[batch(GQA, 1)]))
    names[2].append("resume tp2")
    out = {"trees": trees, "ckpt": ckpt, "psum_out": psum_out}
    for world in (4, 2):
        res = lm_shard.run_world(world, jobs[world], str(tmp / f"w{world}"), device="cpu",
                                 timeout=300)
        for j, name in enumerate(names[world]):
            out[(world, name)] = [r[j] for r in res]
    # compressed_psum at dp 4, in a world of its own
    psum_dir = tmp / "psum"
    psum_dir.mkdir()
    spawn_ranks(compressed_psum_rank, 4, (f"file://{psum_dir / 'store'}", psum_in,
                                          str(psum_dir)), timeout=120)
    out["psum"] = []
    for r in range(4):
        with open(psum_dir / f"rank{r}.pkl", "rb") as f:
            out["psum"].append(pickle.load(f))
    stdout, stderr = ref_psum.communicate(timeout=300)
    assert ref_psum.returncode == 0, stderr[-2000:]
    return out


REF_PSUM = """
import sys, numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.train import compression as C
z = np.load(sys.argv[1])
g = {k[2:]: z[k] for k in z.files if k.startswith("g/")}
e = {k[2:]: z[k] for k in z.files if k.startswith("e/")}
mesh = jax.make_mesh((4,), ("data",))
spec = jax.tree_util.tree_map(lambda _: P("data"), g)
first = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
stack = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)
def fn(g, e):
    r, ne = C.compressed_psum(first(g), first(e), "data")
    return stack(r), stack(ne)
r, ne = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)))(g, e)
out = {}
for k in g:
    out["r/" + k], out["e/" + k] = np.asarray(r[k]), np.asarray(ne[k])
    for d in range(4):
        q, s = jax.jit(C.quantize_int8)(g[k][d] + e[k][d])
        out[f"q/{k}/{d}"], out[f"s/{k}/{d}"] = np.asarray(q), np.asarray(s)
np.savez(sys.argv[2], **out)
"""


@functools.cache
def one_rank(arch, sp, rows_start, rows_stop, train=None, steps=1):
    """The one-rank port (``run_job`` in this process) on the rows
    [rows_start, rows_stop) of each step's batch: its losses and first
    gradients as numpy by path."""
    rows = slice(rows_start, rows_stop)
    tc = dict(TRAIN, **dict(train or ()))
    path = one_rank_tree(arch)
    res = train_cli.run_job(job(arch, 1, sp, path, train=tc, grads=(0,),
                                batches=[batch(arch, s, rows) for s in range(steps)]),
                            None, "cpu")
    return res["losses"], by_path(tree_to_numpy(res["grads"][0]))


@functools.cache
def one_rank_tree(arch):
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), f"{arch}.npz")
    lm_shard.save_tree(ref_tree(arch), path)
    return path


def spec_paths(specs, prefix="") -> dict:
    """A spec tree (dicts of spec tuples) by path, as ``by_path`` keys a
    tree of tensors."""
    if isinstance(specs, dict):
        return {k: v for key in sorted(specs)
                for k, v in spec_paths(specs[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tuple(specs)}


def assembled(ranks, world, arch, tp, sp):
    """The whole gradient tree from every rank's blocks, by path."""
    topo = make_cpu_topology(world, tp)
    specs = lm.param_specs(port_config(arch, sp), topo)
    return by_path(unshard_tree([r["grads"][0] for r in ranks], specs, topo))


def close_trees(got, want, tol=GRAD_TOL):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        gap = float(np.abs(got[k] - w).max())
        assert gap <= tol * scale, f"{k}: gap {gap:.3g} over {tol} of {scale:.3g}"


def mean_over(trees):
    return {k: sum(t[k] for t in trees) / len(trees) for k in trees[0]}


@pytest.mark.parametrize("case", GRADS, ids=[c[0] for c in GRADS])
def test_sharded_loss_and_grads_match_one_rank(runs, case):
    name, world, arch, tp, sp = case
    ranks = runs[(world, name)]
    losses = {r["losses"][0] for r in ranks}
    assert len(losses) == 1, f"the ranks' losses differ: {losses}"
    sets = dp_rows(world, tp) if arch == MOE else [slice(0, B)]
    want = [one_rank(arch, sp, s.start, s.stop) for s in sets]
    loss = sum(w[0][0] for w in want) / len(want)
    assert abs(ranks[0]["losses"][0] - loss) <= LOSS_RTOL * abs(loss)
    close_trees(assembled(ranks, world, arch, tp, sp), mean_over([w[1] for w in want]))
    # a leaf that several ranks hold whole has the same gradient on each
    topo = make_cpu_topology(world, tp)
    for k, v in spec_paths(lm.param_specs(port_config(arch, sp), topo)).items():
        if not any(v):
            blocks = [by_path(tree_to_numpy(r["grads"][0]))[k] for r in ranks]
            for b in blocks[1:]:
                np.testing.assert_array_equal(b, blocks[0])


def test_collectives_are_tallied(runs):
    """Under the sequence-parallel residual a tp 2 layer all-gathers its
    normed input and reduce-scatters its row-parallel sums (attention
    and MLP, forward and backward); the all_reduce form reduces instead.
    A forward run again under remat tallies under ``recompute`` keys."""
    L = port_config(GQA).n_layers
    sp = runs[(2, "gqa tp2 sp")][0]["counts"][0]
    plain = runs[(2, "gqa tp2")][0]["counts"][0]
    assert sp["reduce_scatter"] >= 4 * L and sp["all_gather"] >= 4 * L
    assert "reduce_scatter" not in plain and plain["all_reduce"] >= 4 * L
    assert sp["recompute all_gather"] > 0 and plain["recompute all_reduce"] > 0
    # dp 2: every layer's FSDP blocks gathered and their gradients
    # reduce-scattered, the norms' gradients summed over dp
    dp = runs[(2, "gqa dp2")][0]["counts"][0]
    assert dp["all_gather"] >= 7 * L and dp["reduce_scatter"] >= 7 * L


@pytest.mark.parametrize("case", STEPPED, ids=[c[0] for c in STEPPED])
def test_steps_match_one_rank(runs, case):
    name, world, arch, tp, sp, tc = case
    got = runs[(world, name)][0]["losses"]
    want, _ = one_rank(arch, sp, 0, B, tuple(sorted(tc.items())), STEPS)
    for s, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= STEP_RTOL * abs(w), f"step {s}: {g} against {w}"
    for r in runs[(world, name)]:
        assert r["losses"] == got


# ----------------------------------------------------------------- #
# the JAX package


def auto_topology():
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    return RefTopology(mesh=mesh, dp_axes=("data",), tp_axis=None)


@functools.cache
def ref_grad_fn(arch):
    cfg, topo = ref_config(arch), auto_topology()
    return jax.jit(jax.value_and_grad(lambda p, b: ref_lm.lm_loss(p, b, cfg, topo)))


def ref_loss_and_grads(arch, rows):
    loss, grads = ref_grad_fn(arch)(ref_tree(arch), batch(arch, 0, rows))
    return float(loss), by_path(jax.tree_util.tree_map(np.asarray, grads))


REF_CASES = [c for c in GRADS if c[2] == GQA] + [c for c in GRADS if c[0] == "moe dp2"]


@pytest.mark.parametrize("case", REF_CASES, ids=[c[0] for c in REF_CASES])
def test_sharded_grads_match_reference(runs, case):
    name, world, arch, tp, sp = case
    sets = dp_rows(world, tp) if arch == MOE else [slice(0, B)]
    want = [ref_loss_and_grads(arch, s) for s in sets]
    loss = sum(w[0] for w in want) / len(want)
    got = runs[(world, name)][0]["losses"][0]
    assert abs(got - loss) <= LOSS_RTOL * abs(loss)
    close_trees(assembled(runs[(world, name)], world, arch, tp, sp),
                mean_over([w[1] for w in want]))


def test_compressed_psum_matches_reference(runs):
    ranks = sorted(runs["psum"], key=lambda r: r["dp_rank"])
    with np.load(runs["psum_out"]) as z:
        want = {k: z[k] for k in z.files}
    for leaf in ("a", "b"):
        for d, r in enumerate(ranks):
            np.testing.assert_array_equal(r["q"][leaf], want[f"q/{leaf}/{d}"])
            assert np.float32(r["scale"][leaf]) == want[f"s/{leaf}/{d}"]
            np.testing.assert_array_equal(r["errors"][leaf], want[f"e/{leaf}"][d])
            w = want[f"r/{leaf}"][d]
            np.testing.assert_allclose(r["reduced"][leaf], w, rtol=0,
                                       atol=4 * np.finfo(np.float32).eps * np.abs(w).max())


# ----------------------------------------------------------------- #
# layouts


GRIDS = {"2x2": (make_cpu_topology(4, 2), {"data": 2, "model": 2}),
         "1x4": (make_cpu_topology(4, 4), {"data": 1, "model": 4}),
         "16x16": (make_topology(), {"data": 16, "model": 16})}


def ref_specs(arch, mesh_shape):
    cfg = ref_get_arch(arch).make_config()
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    topo = RefTopology(mesh=mesh, dp_axes=("data",), tp_axis="model")
    return cfg, ref_lm.param_specs(cfg, topo)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_state_specs_equal_the_references(arch, grid):
    topo, mesh_shape = GRIDS[grid]
    _, rspecs = ref_specs(arch, mesh_shape)
    want = jax.tree_util.tree_leaves_with_path(
        R.state_specs(rspecs, R.AdamWConfig()),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    got = spec_paths(T.state_specs(lm.param_specs(get_arch(arch).make_config(), topo),
                                   T.AdamWConfig()))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(v) for path, v in want}
    assert got == want


def ref_block_bytes(shape, itemsize, spec, mesh_shape) -> int:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    n = 1
    for dim, e in zip(shape, spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n *= -(-dim // math.prod(mesh_shape[a] for a in axes))
    return n * itemsize


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_plans_keep_the_references_bytes(arch):
    """The train_4k plan's bytes a card at 1, 4 and 256 ranks: the
    reference's params and AdamW state by its param_specs and
    state_specs, the batch over dp and the step."""
    for ranks in (1, 4, 256):
        grid = lm_grid(ranks)
        mesh_shape = dict(zip(grid.axis_names, grid.grid.shape))
        cfg, rspecs = ref_specs(arch, mesh_shape)
        shapes = jax.eval_shape(lambda: ref_lm.init_params(jax.random.PRNGKey(0), cfg))
        state = jax.eval_shape(lambda p: R.init_state(p, R.AdamWConfig()), shapes)
        sspecs = R.state_specs(rspecs, R.AdamWConfig())

        def total(tree, specs):
            leaves = jax.tree_util.tree_leaves(tree)
            sl = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
            return sum(ref_block_bytes(x.shape, x.dtype.itemsize, sp, mesh_shape)
                       for x, sp in zip(leaves, sl))

        dp = mesh_shape["data"]
        want = total(shapes, rspecs) + total(state, sspecs) + 2 * -(-256 // dp) * 4096 * 4 + 4
        plan = lm_cell(arch, get_arch(arch).make_config(), "train_4k", ranks)
        assert plan.arg_bytes_per_card == want
        # the plan's state specs are state_specs' own
        assert plan.specs[1] == T.state_specs(plan.specs[0], T.AdamWConfig())


# ----------------------------------------------------------------- #
# checkpoints


def test_checkpoint_restores_across_grids(runs):
    """The state saved at dp 2 x tp 2 after step 1 (whole leaves, rank 0)
    resumes at tp 2, in one process and in the JAX package, each to the
    uninterrupted run's step-2 loss."""
    want = runs[(4, "ckpt dp2tp2")][0]["losses"][1]
    resumed = runs[(2, "resume tp2")]
    assert {r["start"] for r in resumed} == {1}
    assert abs(resumed[0]["losses"][0] - want) <= STEP_RTOL * abs(want)
    one = train_cli.run_job(job(GQA, 1, True, None, train=TRAIN, restore=runs["ckpt"],
                                batches=[batch(GQA, 1)]), None, "cpu")
    assert abs(one["losses"][0] - want) <= STEP_RTOL * abs(want)
    # the JAX package reads the whole leaves the port reads, and its loss
    # on them is the next loss
    ref, man = R.Checkpointer(runs["ckpt"]).restore()
    port, _ = T.Checkpointer(runs["ckpt"]).restore()
    assert man["step"] == 1
    ref_flat, port_flat = by_path(ref), by_path(port)
    assert sorted(ref_flat) == sorted(port_flat)
    for k, v in port_flat.items():
        np.testing.assert_array_equal(np.asarray(ref_flat[k]), v.numpy())
    cfg, topo = ref_config(GQA), auto_topology()
    loss = jax.jit(lambda p, b: ref_lm.lm_loss(p, b, cfg, topo))(
        ref["params"], {k: jnp.asarray(v) for k, v in batch(GQA, 1).items()})
    assert abs(float(loss) - want) <= STEP_RTOL * abs(want)


# ----------------------------------------------------------------- #
# the launcher and the refusals


def losses_printed(out: str) -> list:
    return [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
            if line.startswith("[train] step")]


def test_launcher_across_ranks_matches_one_rank(tmp_path, capfd):
    common = ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16"]
    train_cli.main(common + ["--tp", "2"])  # one rank: --tp only rounds the vocab
    out = capfd.readouterr().out
    assert "vocab 193 rounded up to 194" in out
    one = losses_printed(out)
    train_cli.main(common + ["--ranks", "4", "--tp", "2", "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert "vocab 193 rounded up to 194" in out
    # steps 0 and 2 print (every 5th and the last): step 2's loss follows
    # step 1's update
    assert len(one) == 2 and losses_printed(out) == pytest.approx(one, abs=1e-4)
    tree, man = T.Checkpointer(str(tmp_path)).restore()
    assert man["step"] == 3 and tuple(tree["params"]["lm_head"].shape) == (64, 194)


def test_what_does_not_split_is_refused():
    cfg = dataclasses.replace(port_config(GQA), loss_chunk=6)
    tree = lm.init_tree(torch.Generator().manual_seed(0), cfg)
    b = {k: torch.as_tensor(v[:, :6]) for k, v in batch(GQA).items()}
    topo = make_cpu_topology(4, 4)  # plans only: a collective would raise
    with pytest.raises(ValueError, match="sequence length 6 does not split over tp 4"):
        lm.lm_loss(tree, b, cfg, topo)
    with pytest.raises(RuntimeError, match="only plans"):  # the all_reduce form takes it
        lm.lm_loss(tree, b, dataclasses.replace(cfg, seq_shard_resid=False), topo)
    with pytest.raises(ValueError, match="batch of 3 rows does not split over dp 2"):
        lm.lm_loss(tree, {k: v[:3] for k, v in b.items()}, cfg, make_cpu_topology(2, 1))
    mla = dataclasses.replace(get_arch("minicpm3-4b").make_config(reduced=True), vocab=196)
    with pytest.raises(NotImplementedError, match="MLA across ranks"):
        lm.lm_loss({}, b, mla, make_cpu_topology(2, 2))
