"""LM serving across ranks (``models/lm.py`` with a ``Topology``): gloo
processes on the CPU, f32, at the reduced phi3-mini (dense GQA) and
phi3.5-moe (MoE, 4 experts top-2) configs with their vocab rounded up to
a multiple of 4 (the reduced vocabs, 193 and 199, split over no tp).
One spawn a world size shares one process group over every grid of that
size (``launch/lm_shard.py``): 2 ranks as tp 2 and as dp 2, 4 ranks as
dp 2 x tp 2.  Every rank's blocks (logits, cache) are put back together
by their specs (``convert.unshard_tree``).

- Against the one-rank port on the same weights: the prefill logits,
  the cache after 8 greedy decode steps and every step's logits within
  1e-5 of the largest magnitude, and the greedy tokens equal; GQA and
  MoE, the decode (sequence over tp) and long (sequence over every rank,
  B 1) layouts.  At dp 2 the one-rank port runs each dp rank's rows
  alone: a MoE layer's capacity is its dp rank's token count.
- Against the JAX package (the reference's weights through
  ``convert.py``; its LM on a one-device Auto-axis mesh, since its
  sharded forward fails under this jax, ROADMAP Queue 3): the
  reference's prefill and decode run once a dp rank, on that rank's
  rows, is what its sharded program computes.  A MoE case whose
  capacity drops pairs keeps and drops exactly the reference's pairs,
  dp rank by dp rank, in the prefill and every decode step, and drops
  other pairs than the one-rank run of the whole batch; a tp case and a
  long case at B 1 against one reference run.
- The layouts: the bytes a card of every LM arch's params and caches by
  the port's specs equal those of the JAX package's ``PartitionSpec``s on
  the same shapes, on the 2 x 2, 1 x 4 and 16 x 16 grids (no devices),
  and the cells' plans at 4 and 256 ranks hold those bytes.
- The one-rank code stays: a topology of one rank runs the one-card code,
  bit for bit; what the grid cannot split is refused.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding, PartitionSpec

from repro.configs import get_arch as ref_get_arch
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.common import Topology as RefTopology
from repro_torch.configs import get_arch
from repro_torch.configs.cells import lm_cell, lm_param_shapes
from repro_torch.data import lm_batch
from repro_torch.launch import lm_shard
from repro_torch.launch.mesh import lm_grid, make_cpu_topology, make_topology
from repro_torch.models import lm
from repro_torch.models.common import generator, shard_shape, single_device_topology
from repro_torch.models.convert import lm_params_from_numpy, unshard_tree

GQA, MOE = "phi3-mini-3.8b", "phi3.5-moe-42b-a6.6b"
VOCAB = {GQA: 196, MOE: 200}
B, PROMPT, MAX_LEN, STEPS = 4, 16, 32, 8
TOL = 1e-5
# a capacity that drops pairs: C = int(0.5 N k / E) at N = 32 tokens a dp
# rank is 8 of a mean 16 pairs an expert (16 at dp 1)
DROP = {"capacity_factor": 0.5, "min_capacity": 1}
LM_ARCHS = ("phi3-mini-3.8b", "minitron-8b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b", "dbrx-132b")


def over(arch, moe=None):
    out = {"vocab": VOCAB[arch]}
    if moe:
        out["moe"] = moe
    return out


def port_config(arch, moe=None):
    return lm_shard.job_config(dict(arch=arch, reduced=True, over=over(arch, moe)))


def ref_config(arch, moe=None):
    cfg = ref_get_arch(arch).make_config(reduced=True)
    cfg = dataclasses.replace(cfg, vocab=VOCAB[arch])
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


@functools.cache
def ref_tree(arch):
    """The reference's random weights (one tree an arch: a MoE capacity
    changes no weight)."""
    tree = ref_lm.init_params(jax.random.PRNGKey(7), ref_config(arch))
    return jax.tree_util.tree_map(np.asarray, tree)


def prompt(arch, batch):
    return lm_batch(0, batch, PROMPT, VOCAB[arch])["tokens"]


# (name, arch, tp, batch, long, moe): the jobs of each world size
CASES = {
    2: [("gqa tp2", GQA, 2, B, False, None),
        ("moe tp2", MOE, 2, B, False, None),
        ("gqa dp2", GQA, 1, B, False, None),
        ("moe dp2", MOE, 1, B, False, None),
        ("moe dp2 drop", MOE, 1, B, False, DROP),
        ("moe long tp2", MOE, 2, 1, True, None),
        ("gqa long dp2", GQA, 1, 1, True, None)],
    4: [("gqa dp2tp2", GQA, 2, B, False, None),
        ("moe dp2tp2", MOE, 2, B, False, None),
        ("moe dp2tp2 drop", MOE, 2, B, False, DROP),
        ("moe long dp2tp2", MOE, 2, 1, True, None),
        ("gqa long dp2tp2", GQA, 2, 1, True, None)],
}
ALL = [(world, c) for world, cases in CASES.items() for c in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(world, name): every rank's results}: one spawn a world size."""
    tmp = tmp_path_factory.mktemp("lm_shard")
    trees = {}
    for arch in (GQA, MOE):
        trees[arch] = str(tmp / f"{arch}.npz")
        lm_shard.save_tree(ref_tree(arch), trees[arch])
    out = {}
    for world, cases in CASES.items():
        jobs = [dict(arch=arch, reduced=True, over=over(arch, moe), tp=tp,
                     tokens=prompt(arch, batch), max_len=MAX_LEN, steps=STEPS, long=long,
                     tree=trees[arch], forward=True, routes=True)
                for _, arch, tp, batch, long, moe in cases]
        res = lm_shard.run_world(world, jobs, str(tmp / f"w{world}"), device="cpu",
                                 timeout=300)
        for j, case in enumerate(cases):
            out[(world, case[0])] = [r[j] for r in res]
    return out


def assembled(ranks, world, case):
    """The whole of a sharded run: logits and caches from their blocks."""
    _, arch, tp, batch, long, moe = case
    cfg, topo = port_config(arch, moe), make_cpu_topology(world, tp)
    over_dp = lm.batch_rows(batch, topo)[1]
    lspec = topo.spec("dp" if over_dp else None, "tp")
    cspecs = lm.cache_specs(cfg, topo, long=long)
    return dict(
        prefill=unshard_tree([r["prefill_logits"] for r in ranks], lspec, topo),
        steps=[unshard_tree([r["step_logits"][s] for r in ranks], lspec, topo)
               for s in range(STEPS)],
        cache=unshard_tree([r["cache"] for r in ranks], cspecs, topo),
        tokens=ranks[0]["tokens"])


def one_rank(arch, moe, tokens):
    """The one-rank port on ``tokens``: prefill logits, the cache after
    the greedy steps, each step's logits and the tokens."""
    cfg = port_config(arch, moe)
    model = lm_params_from_numpy(ref_tree(arch), cfg, device="cpu")
    hidden = lm.forward(model, torch.as_tensor(tokens), cfg).numpy()
    cache, logits = lm.prefill_step(model, torch.as_tensor(tokens), cfg, MAX_LEN)
    prefill, steps, toks = logits.numpy(), [], []
    for s in range(STEPS):
        nxt = lm.greedy_tokens(logits)
        toks.append(nxt.numpy())
        logits, cache = lm.decode_step(model, cache, nxt, PROMPT + s, cfg)
        steps.append(logits.numpy())
    return dict(prefill=prefill, steps=steps, cache={k: v.numpy() for k, v in cache.items()},
                tokens=np.stack(toks), forward=hidden)


def shard_rows(world, tp, batch):
    """The dp ranks' rows: slices of the batch, one a dp rank."""
    dp = world // tp
    if batch % dp:
        return [slice(0, batch)]
    n = batch // dp
    return [slice(i * n, (i + 1) * n) for i in range(dp)]


def close(got, want, scale=None):
    scale = float(np.abs(want).max()) if scale is None else scale
    gap = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert gap <= TOL * scale, f"gap {gap:.3g} over {TOL} of {scale:.3g}"


@pytest.mark.parametrize("world,case", ALL, ids=[c[0] for _, c in ALL])
def test_sharded_serving_matches_one_rank(runs, world, case):
    name, arch, tp, batch, long, moe = case
    got = assembled(runs[(world, name)], world, case)
    toks = prompt(arch, batch)
    dp_sets = shard_rows(world, tp, batch)
    for i, rows in enumerate(dp_sets):
        want = one_rank(arch, moe, toks[rows])
        scale = float(np.abs(want["prefill"]).max())
        close(got["prefill"][rows], want["prefill"], scale)
        for s in range(STEPS):
            close(got["steps"][s][rows], want["steps"][s], scale)
        np.testing.assert_array_equal(got["tokens"][:, rows], want["tokens"])
        for k in ("k", "v"):
            close(got["cache"][k][:, rows], want["cache"][k])
        # forward: each rank holds its dp rank's rows of the hidden states
        for r in runs[(world, name)]:
            if len(dp_sets) == 1 or r["coords"]["data"] == i:
                close(r["forward"], want["forward"])
    # every rank agrees on the tokens
    for r in runs[(world, name)]:
        np.testing.assert_array_equal(r["tokens"], got["tokens"])


def test_collectives_are_tallied(runs):
    """A tp 2 MoE prefill: per layer an all_reduce for the embedding's
    sum, attention and the experts, and an all_to_all for k and v each;
    a decode step gathers q, k, v and the chunks' partials a layer."""
    cfg = port_config(MOE)
    L = cfg.n_layers
    for r in runs[(2, "moe tp2")]:
        assert r["prefill_counts"]["all_reduce"] == 1 + 2 * L
        assert r["prefill_counts"]["all_to_all"] == 2 * L
        assert r["step_counts"][0]["all_gather"] == 5 * L
        assert r["prefill_counts"]["bytes"] > 0
    # dp 2: every layer's weights are all-gathered (FSDP), nothing over tp
    r = runs[(2, "moe dp2")][0]
    assert "all_to_all" not in r["prefill_counts"]
    assert r["prefill_counts"]["all_gather"] >= 7 * L


# ----------------------------------------------------------------- #
# the JAX package


def auto_topology():
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    return RefTopology(mesh=mesh, dp_axes=("data",), tp_axis=None)


def ref_run(arch, moe, tokens, monkeypatch=None):
    """The reference's prefill and greedy decode on ``tokens`` (one
    device), each MoE layer call's kept (token, choice) pairs recorded in
    call order when ``monkeypatch`` is given."""
    cfg, topo = ref_config(arch, moe), auto_topology()
    kept = []
    if monkeypatch is not None:
        real = ref_moe._moe_local

        def recording(x, router_w, *a, cfg, C, **kw):
            # the reference's routing steps (models/moe.py::_moe_local)
            N, k = x.shape[0], cfg.top_k
            probs = jax.nn.softmax(x.astype(jnp.float32) @ router_w.astype(jnp.float32), -1)
            _, idx = jax.lax.top_k(probs, k)
            flat = idx.reshape(-1)
            order = jnp.argsort(flat)
            se = flat[order]
            counts = jax.ops.segment_sum(jnp.ones_like(se), se, num_segments=cfg.n_experts)
            starts = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]])
            rank = jnp.arange(N * k) - starts[se]
            keep = jnp.zeros((N * k,), bool).at[order].set(rank < C).reshape(N, k)
            jax.debug.callback(lambda i, m: kept.append((np.asarray(i), np.asarray(m))),
                               idx, keep, ordered=True)
            return real(x, router_w, *a, cfg=cfg, C=C, **kw)

        monkeypatch.setattr(ref_moe, "_moe_local", recording)
    params = ref_tree(arch)
    prefill = jax.jit(lambda p, t: ref_lm.prefill_step(p, t, cfg, topo, max_len=MAX_LEN))
    decode = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, c, t, pos, cfg, topo))
    cache, logits = prefill(params, jnp.asarray(tokens))
    out = dict(prefill=np.asarray(logits), steps=[], tokens=[])
    for s in range(STEPS):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        out["tokens"].append(np.asarray(nxt))
        logits, cache = decode(params, cache, nxt, PROMPT + s)
        out["steps"].append(np.asarray(logits))
    jax.effects_barrier()
    out["kept"] = kept
    return out


def port_kept(rank_result):
    """The kept pairs a rank routed, prefill then each step, in order."""
    routes = list(rank_result["prefill_routes"])
    for step in rank_result["step_routes"]:
        routes.extend(step)
    return [(r["idx"], r["keep"]) for r in routes]


@pytest.mark.parametrize("world,name", [(2, "moe dp2 drop"), (4, "moe dp2tp2 drop")])
def test_dp_shards_drop_the_references_pairs(runs, monkeypatch, world, name):
    case = dict((c[0], c) for c in CASES[world])[name]
    _, arch, tp, batch, _, moe = case
    ranks = runs[(world, name)]
    got = assembled(ranks, world, case)
    toks = prompt(arch, batch)
    topo = make_cpu_topology(world, tp)
    dropped = 0
    for i, rows in enumerate(shard_rows(world, tp, batch)):
        want = ref_run(arch, moe, toks[rows], monkeypatch)
        scale = float(np.abs(want["prefill"]).max())
        close(got["prefill"][rows], want["prefill"], scale)
        for s in range(STEPS):
            close(got["steps"][s][rows], want["steps"][s], scale)
        np.testing.assert_array_equal(got["tokens"][:, rows], np.stack(want["tokens"]))
        # every rank of dp index i routed its rows as the reference did
        mine = [r for r in ranks if r["coords"]["data"] == i]
        for r in mine:
            pk = port_kept(r)
            assert len(pk) == len(want["kept"])
            for (pi, pkeep), (ri, rkeep) in zip(pk, want["kept"]):
                np.testing.assert_array_equal(pi, ri)
                np.testing.assert_array_equal(pkeep, rkeep)
        dropped += sum(int((~k).sum()) for _, k in want["kept"])
        monkeypatch.undo()
    assert dropped > 0
    # dp 1 over the whole batch keeps other pairs in the first layer: the
    # capacity is a dp rank's
    whole = ref_run(arch, moe, toks, monkeypatch)
    by_rank = np.concatenate([
        port_kept(next(r for r in ranks if r["coords"]["data"] == i))[0][1]
        for i in range(topo.dp_size)])
    assert whole["kept"][0][1].shape == by_rank.shape
    assert not np.array_equal(whole["kept"][0][1], by_rank)


@pytest.mark.parametrize("world,name", [(2, "moe tp2"), (4, "moe long dp2tp2"),
                                        (2, "gqa long dp2")])
def test_sharded_serving_matches_reference(runs, world, name):
    case = dict((c[0], c) for c in CASES[world])[name]
    _, arch, tp, batch, _, moe = case
    got = assembled(runs[(world, name)], world, case)
    want = ref_run(arch, moe, prompt(arch, batch))
    scale = float(np.abs(want["prefill"]).max())
    close(got["prefill"], want["prefill"], scale)
    for s in range(STEPS):
        close(got["steps"][s], want["steps"][s], scale)
    np.testing.assert_array_equal(got["tokens"], np.stack(want["tokens"]))


# ----------------------------------------------------------------- #
# layouts


def ref_bytes(shape, itemsize, spec, mesh_shape) -> int:
    """One device's block of an array under a PartitionSpec: each split
    dim ceil(dim / its axes' product), as XLA pads; where the dims divide,
    also NamedSharding's own shard shape."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    block = []
    for n, e in zip(shape, spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        block.append(-(-n // math.prod(mesh_shape[a] for a in axes)))
    if all(n % b == 0 for n, b in zip(shape, block)):
        mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
        assert NamedSharding(mesh, PartitionSpec(*spec)).shard_shape(shape) == tuple(block)
    return math.prod(block) * itemsize


def ref_layout_bytes(arch, mesh_shape, dp_axes) -> tuple:
    """(params, decode cache, long cache) bytes a device by the JAX
    package's specs, shapes from jax.eval_shape (no arrays)."""
    cfg = ref_get_arch(arch).make_config()
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    topo = RefTopology(mesh=mesh, dp_axes=dp_axes, tp_axis="model")
    shapes = jax.eval_shape(lambda: ref_lm.init_params(jax.random.PRNGKey(0), cfg))

    def total(tree, specs):
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
        return sum(ref_bytes(x.shape, x.dtype.itemsize, sp, mesh_shape)
                   for x, sp in zip(leaves, spec_leaves))

    cache = ref_lm.cache_shapes(cfg, 128, 32768)
    return (total(shapes, ref_lm.param_specs(cfg, topo)),
            total(cache, ref_lm.cache_specs(cfg, topo, long=False)),
            total(ref_lm.cache_shapes(cfg, 1, 524288), ref_lm.cache_specs(cfg, topo, long=True)))


def port_layout_bytes(arch, topo) -> tuple:
    from repro_torch.configs.cells import spec_leaves

    cfg = get_arch(arch).make_config()

    def total(args, specs):
        return sum(math.prod(shard_shape(t.shape, sp, topo)) * t.element_size()
                   for t, sp in spec_leaves(args, specs))

    return (total(lm_param_shapes(cfg), lm.param_specs(cfg, topo)),
            total(lm.cache_shapes(cfg, 128, 32768), lm.cache_specs(cfg, topo, long=False)),
            total(lm.cache_shapes(cfg, 1, 524288), lm.cache_specs(cfg, topo, long=True)))


GRIDS = {"2x2": (make_cpu_topology(4, 2), {"data": 2, "model": 2}),
         "1x4": (make_cpu_topology(4, 4), {"data": 1, "model": 4}),
         "16x16": (make_topology(), {"data": 16, "model": 16})}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_layout_bytes_equal_the_references(arch, grid):
    topo, mesh_shape = GRIDS[grid]
    assert port_layout_bytes(arch, topo) == ref_layout_bytes(arch, mesh_shape, ("data",))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cell_plans_hold_the_layout_bytes(arch):
    """At 4 ranks (1 x 4) and 256 (16 x 16) the cells' bytes a card are
    the layouts' bytes beside the batch's block."""
    cfg = get_arch(arch).make_config()
    for ranks, mesh_shape in ((4, {"data": 1, "model": 4}), (256, {"data": 16, "model": 16})):
        grid = lm_grid(ranks)
        assert dict(zip(grid.axis_names, grid.grid.shape)) == mesh_shape
        params, cache, cache_long = port_layout_bytes(arch, grid)
        dp = mesh_shape["data"]
        assert lm_cell(arch, cfg, "decode_32k", ranks).arg_bytes_per_card == \
            params + cache + -(-128 // dp) * 4 + 4
        assert lm_cell(arch, cfg, "long_500k", ranks).arg_bytes_per_card == \
            params + cache_long + 4 + 4
        assert lm_cell(arch, cfg, "prefill_32k", ranks).arg_bytes_per_card == \
            params + -(-32 // dp) * 32768 * 4


# ----------------------------------------------------------------- #
# one rank, construction and refusals


def test_one_rank_topology_runs_the_one_card_code():
    cfg = port_config(MOE)
    model = lm.init_params(generator(3, "cpu"), cfg)
    toks = torch.as_tensor(prompt(MOE, B))
    cache, logits = lm.prefill_step(model, toks, cfg, MAX_LEN)
    topo = single_device_topology()
    cache1, logits1 = lm.prefill_step(model, toks, cfg, MAX_LEN, topo)
    assert torch.equal(logits, logits1)
    nxt = lm.greedy_tokens(logits)
    assert torch.equal(nxt, lm.greedy_tokens(logits1, topo))
    a, _ = lm.decode_step(model, cache, nxt, PROMPT, cfg)
    b, _ = lm.decode_step(model, cache1, nxt, PROMPT, cfg, topo)
    assert torch.equal(a, b) and not topo.counts
    assert torch.equal(lm.forward(model, toks, cfg), lm.forward(model, toks, cfg, topo))


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_init_keeps_the_one_card_draws(tp):
    """init_params(topo=) draws every tensor whole and keeps the rank's
    block: the blocks of the one-card model, for every rank."""
    cfg = port_config(MOE)
    whole = lm.init_params(generator(3, "cpu"), cfg)
    for r in range(4):
        topo = make_cpu_topology(4, tp)
        topo.rank = r
        part = lm.init_params(generator(3, "cpu"), cfg, topo)
        want = lm.shard_params(whole, topo)
        for (n, a), (_, b) in zip(part.named_parameters(), want.named_parameters()):
            assert torch.equal(a, b), n


def test_what_does_not_split_is_refused():
    topo = make_topology()  # tp 16: more than phi3.5-moe's 8 kv heads
    with pytest.raises(ValueError, match="kv heads do not split over tp 16"):
        lm.check_shardable(get_arch(MOE).make_config(), topo)
    with pytest.raises(ValueError, match="vocab do not split over tp 2"):
        lm.check_shardable(get_arch(MOE).make_config(reduced=True), make_cpu_topology(2, 2))
    with pytest.raises(NotImplementedError, match="MLA across ranks"):
        lm.check_shardable(get_arch("minicpm3-4b").make_config(), make_cpu_topology(2, 2))
    cfg = port_config(MOE)
    topo = make_cpu_topology(2, 1)
    model = lm.init_params(generator(3, "cpu"), cfg, topo)
    with pytest.raises(ValueError, match="does not split over dp 2"):
        lm.prefill_step(model, torch.as_tensor(prompt(MOE, 3)), cfg, MAX_LEN, topo)
