"""MIND training in the port against the JAX package's, at the reduced
config with a batch of 32 from ``mind_batch``, a quarter of the profile
slots masked and one user's whole history masked; the reference's
random weights go through ``convert.py``.

- ``sampled_softmax_loss`` and its gradient, leaf by leaf, against the
  reference's jitted ``jax.value_and_grad`` with ``bag_impl="ref"``:
  the loss within 1e-6 of its value, each gradient within 2e-5 of the
  leaf's max |grad| (f32 sums in another order; the worst leaf measured
  3.8e-6).  At the reference's 0.02-scale init every logit is about 0,
  so the loss is ln(1 + n_neg) and the gradients about 1e-6: the same
  check runs at the init's tables scaled to 1, where the loss moves off
  ln 16.  ``routing_init``'s gradient is 0 in exact arithmetic (its
  softmax over the history is shift-invariant in it): on both sides it
  must stay below 1e-6 of the largest gradient of any leaf.
- The port's kernel route (``bag_impl="pallas_interpret"``: ``BagSum``,
  its backward the plain vertex sum on the CPU) against the same
  reference gradient.
- Two train steps (AdamW, warmup-cosine, clip) of ``build_train_step``
  on both sides at lr 1e-2, at the scale-1 tables: params, AdamW state
  and metrics; params and master within 1e-3, as test_torch_lm_train.py.
  ``routing_init``'s rounding noise, normalised by Adam, moves it by up
  to lr a step on each side in its own direction: each side is held to
  that bound from the start, its moments to the noise bound above.
- ``BagSum``'s backward against autograd of ``embedding_bag_ref``, with
  masked slots and a table row that no slot names, and bit for bit
  against ``spmm_ell_vertex_ref`` over the bag ELL; the kernel entry's
  refusal of an input that needs a gradient, with the launch mocked.
- A checkpoint written by either package is read by the other.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

import repro.train as R
import repro_torch.train as T
from repro.configs import mind_cfg as ref_mind_cfg
from repro.models import mind as ref_mind
from repro_torch import kernels as K
from repro_torch.configs import get_arch
from repro_torch.data import mind_batch
from repro_torch.kernels.embedding_bag import BagSum, bag_pool, embedding_bag_ref
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.models import mind
from repro_torch.models.convert import mind_tree_from_numpy, tree_to_numpy
from repro_torch.models.gnn.ell import build_bag_ell
from repro_torch.train.checkpoint import _flatten_with_paths as by_path
from repro_torch.train.train_step import value_and_grad

B = 32
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, PARAM_ATOL = 1e-6, 2e-5, 1e-6, 1e-3
#: the leaf whose gradient is 0 in exact arithmetic
ZERO_LEAF = "routing_init"


@functools.cache
def configs():
    return (ref_mind_cfg.make_config(reduced=True),
            get_arch("mind").make_config(reduced=True))


@functools.cache
def ref_grad_fn():
    ref_cfg, _ = configs()
    return jax.jit(jax.value_and_grad(lambda p, b: ref_mind.sampled_softmax_loss(p, b, ref_cfg)))


def batch() -> dict:
    _, cfg = configs()
    b = mind_batch(1, B, cfg, seed=3)
    b["profile_mask"] = np.random.default_rng(0).random(b["profile_mask"].shape) > 0.25
    b["hist_mask"][0] = False  # a user with no history: uniform routing weights
    return b


@functools.cache
def case(scale: float):
    """The reference's weights (tables scaled to ``scale``), the batch,
    and the reference's loss and gradients, all numpy."""
    ref_cfg, _ = configs()
    tree = jax.tree_util.tree_map(np.asarray, ref_mind.init_params(jax.random.PRNGKey(7), ref_cfg))
    for k in ("item_table", "profile_table"):
        tree[k] = (tree[k] * np.float32(scale / 0.02)).astype(np.float32)
    b = batch()
    loss, grads = ref_grad_fn()(tree, b)
    return tree, b, float(loss), jax.tree_util.tree_map(np.asarray, grads)


def as_torch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def port_loss_and_grads(tree, b, cfg):
    params = mind_tree_from_numpy(tree, cfg, device="cpu")
    return value_and_grad(lambda p, x: mind.sampled_softmax_loss(p, x, cfg))(params, as_torch(b))


def assert_grads_close(port, ref):
    got, want = by_path(tree_to_numpy(port)), by_path(ref)
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        if name == ZERO_LEAF:
            assert np.abs(got[name]).max() <= ZERO_GRAD_TOL * top, name
            assert np.abs(w).max() <= ZERO_GRAD_TOL * top, name
            continue
        np.testing.assert_allclose(got[name], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("scale", [0.02, 1.0])
def test_loss_and_grads_match_reference(scale, impl):
    tree, b, ref_loss, ref_grads = case(scale)
    cfg = dataclasses.replace(configs()[1], bag_impl=impl)
    K.reset_launch_counts()
    before = K.call_counts()
    loss, grads = port_loss_and_grads(tree, b, cfg)
    after = K.call_counts()
    calls = {k: after[k]["ref"] - before[k]["ref"] for k in ("embedding_bag", "spmm_ell")}
    # the kernel route's bag and its backward, the plain route's neither
    assert calls == ({"embedding_bag": 0, "spmm_ell": 0} if impl == "ref"
                     else {"embedding_bag": 1, "spmm_ell": 1})
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(loss) == pytest.approx(ref_loss, rel=LOSS_RTOL)
    n_neg = cfg.n_negatives
    if scale == 0.02:  # every logit about 0
        assert ref_loss == pytest.approx(np.log(1 + n_neg), rel=1e-4)
    else:
        assert abs(ref_loss - np.log(1 + n_neg)) > 0.1
    assert_grads_close(grads, ref_grads)


def test_kernel_route_repeats_the_profile_gradient():
    """The kernel route's profile-table gradient (BagSum's ordered
    segment sum) repeats its bits run to run, and is within GRAD_TOL of
    the plain route's (index_put's adds, whose order may change between
    runs on the CPU's threads, as the item table's gathers' may)."""
    tree, b, _, _ = case(1.0)
    cfg = dataclasses.replace(configs()[1], bag_impl="pallas_interpret")
    first, again = (by_path(port_loss_and_grads(tree, b, cfg)[1]) for _ in range(2))
    assert torch.equal(first["profile_table"], again["profile_table"])
    plain = by_path(port_loss_and_grads(tree, b, configs()[1])[1])
    want = plain["profile_table"]
    torch.testing.assert_close(first["profile_table"], want, rtol=0,
                               atol=GRAD_TOL * float(want.abs().max()))


def test_two_train_steps_match_reference():
    """The scale-1 tables, lr 1e-2: each side's build_train_step, two
    steps; the port's step is the train_batch cell's (in place)."""
    ref_cfg, cfg = configs()
    tree, b, _, _ = case(1.0)
    kw = dict(warmup_steps=2, total_steps=10)
    rtc = R.TrainConfig(adamw=R.AdamWConfig(lr=1e-2), **kw)
    ptc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), **kw)
    rstep = jax.jit(R.build_train_step(lambda p, x: ref_mind.sampled_softmax_loss(p, x, ref_cfg),
                                       rtc))
    pstep = T.build_train_step(lambda p, x: mind.sampled_softmax_loss(p, x, cfg), ptc,
                               donate=True)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs = R.init_train_state(rp, rtc)
    pp = mind_tree_from_numpy(tree, cfg, device="cpu")
    ps = T.init_train_state(pp, ptc)
    tb = as_torch(b)
    lrs = []
    for i in range(2):
        rp, rs, rm = rstep(rp, rs, b, jnp.int32(i))
        pp, ps, pm = pstep(pp, ps, tb, torch.tensor(i, dtype=torch.int32))
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_RTOL)
        assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=2e-5)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        lrs.append(float(rm["lr"]))
    start = tree[ZERO_LEAF]
    # Adam's normalised step is at most 1 an element, weight decay adds wd |p|
    moved = sum(lrs) * (1 + rtc.adamw.weight_decay * (np.abs(start).max() + 1))
    for port, ref in ((pp, rp), (ps["master"], rs["master"])):
        got, want = by_path(tree_to_numpy(port)), by_path(jax.tree_util.tree_map(np.asarray, ref))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if k == ZERO_LEAF:
                for side in (got[k], w):
                    assert np.abs(side - start).max() <= moved, k
                continue
            np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_ATOL, err_msg=k)
    for moment in ("m", "v"):
        got = by_path(tree_to_numpy(ps[moment]))
        want = by_path(jax.tree_util.tree_map(np.asarray, rs[moment]))
        top = max(np.abs(w).max() for w in want.values())
        for k, w in want.items():
            if k == ZERO_LEAF:
                noise = (ZERO_GRAD_TOL * top) ** (2 if moment == "v" else 1)
                assert max(np.abs(got[k]).max(), np.abs(w).max()) <= noise, k
                continue
            np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                       err_msg=f"{moment}.{k}")
    assert int(ps["step"]) == int(rs["step"]) == 2


def bag_case(seed=0, V=40, d=8, B=6, L=5):
    """Ids that never name row 7, a third of the slots masked, and a
    bag whose every slot is masked."""
    r = np.random.default_rng(seed)
    idx = r.choice(np.setdiff1d(np.arange(V), [7]), (B, L)).astype(np.int32)
    w = (r.random((B, L)) > 0.33).astype(np.float32)
    w[2] = 0.0
    table = r.normal(size=(V, d)).astype(np.float32)
    g = r.normal(size=(B, d)).astype(np.float32)
    return (torch.tensor(a) for a in (table, idx, w, g))


@pytest.mark.parametrize("seed", [0, 1])
def test_bag_backward_matches_autograd_of_the_plain_bag(seed):
    table, idx, w, g = bag_case(seed)
    t = table.clone().requires_grad_(True)
    out = BagSum.apply(t, idx, w)
    (grad,) = torch.autograd.grad(out, t, g)
    tp = table.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(embedding_bag_ref(tp, idx, w), tp, g)
    assert torch.equal(out, embedding_bag_ref(table, idx, w))
    torch.testing.assert_close(grad, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(grad[7], torch.zeros_like(grad[7]))  # a row no slot names
    ell = build_bag_ell(idx, w, table.shape[0])
    assert torch.equal(grad, K.spmm_ell_vertex_ref(g, ell.col, ell.wgt, ell.row_ptr, ell.deg))
    # every live slot once, in its row's slots in flat order, its bag as column
    assert int(ell.deg.sum()) == int((w != 0).sum()) and ell.n == table.shape[0]


def test_bag_ell_is_the_segment_ell_with_bag_columns():
    from repro_torch.models.gnn.ell import build_segment_ell

    _, idx, w, _ = bag_case(2)
    seg = build_segment_ell(idx.reshape(-1), w.reshape(-1), 40)
    bag = build_bag_ell(idx, w, 40)
    assert torch.equal(bag.row_ptr, seg.row_ptr) and torch.equal(bag.deg, seg.deg)
    assert torch.equal(bag.wgt, seg.wgt)
    mask = seg.wgt != 0
    assert torch.equal(bag.col[mask], seg.col[mask] // idx.shape[1])


def test_bag_sum_refuses_w_that_needs_a_gradient_and_gives_idx_none():
    table, idx, w, g = bag_case()
    with pytest.raises(RuntimeError, match="w needs a gradient"):
        BagSum.apply(table.requires_grad_(True), idx, w.clone().requires_grad_(True))
    t = table.detach().requires_grad_(True)
    out = BagSum.apply(t, idx, w)
    assert out.grad_fn is not None and not idx.requires_grad


def test_bag_pool_keeps_the_layout_of_the_batch():
    """The backward builds the bag ELL anew each call; the build is
    deterministic, so one batch gets the same layout, and the same
    gradient bits, every time."""
    table, idx, w, _ = bag_case()
    mask = w != 0
    t = table.requires_grad_(True)
    grads = []
    for _ in range(2):
        (gr,) = torch.autograd.grad(bag_pool(t, idx, mask, mode="mean", impl="pallas").sum(), t)
        grads.append(gr)
    first, again = (build_bag_ell(idx, mask.to(torch.float32), table.shape[0]) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first[:4], again[:4])) and first.n == again.n
    assert torch.equal(grads[0], grads[1])
    (want,) = torch.autograd.grad(bag_pool(t, idx, mask, mode="mean", impl="ref").sum(), t)
    torch.testing.assert_close(grads[0], want, rtol=1e-6, atol=1e-6)


def test_bag_kernel_entry_refuses_grad_before_its_launch(monkeypatch):
    """The launch mocked (the CPU has no card): with grad mode on, a
    table or w that needs a gradient raises before the launch; without
    grad mode, or with inputs that need none, the launch runs and counts."""
    launched = []
    monkeypatch.setattr(bag_kernel._lib, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(bag_kernel._lib, "stream_of", lambda t: 0)
    monkeypatch.setattr(bag_kernel, "_launch", lambda: lambda *args: launched.append(args) or 0)
    table, idx, w, _ = bag_case()
    for t, ww in ((table.clone().requires_grad_(True), w), (table, w.clone().requires_grad_(True))):
        with pytest.raises(RuntimeError, match="needs a gradient"):
            bag_kernel.embedding_bag_cuda(t, idx, ww)
    assert not launched
    K.reset_launch_counts()
    with torch.no_grad():
        bag_kernel.embedding_bag_cuda(table.clone().requires_grad_(True), idx, w)
    bag_kernel.embedding_bag_cuda(table, idx, w)
    assert len(launched) == 2 and K.launch_counts()["embedding_bag"] == 2


def test_train_cell_step_runs_on_the_cpu():
    """The train_batch cell's own step, at the reduced config and B 8."""
    plan = get_arch("mind").make_cell("train_batch", reduced=True)
    _, cfg = configs()
    assert plan.kind == "train" and cfg.bag_impl == "ref"
    tree = mind.init_tree(torch.Generator().manual_seed(0), cfg)
    opt = T.init_train_state(tree, T.TrainConfig())
    tb = as_torch(mind_batch(0, 8, cfg, seed=1))
    new, opt, m = plan.fn(tree, opt, tb, torch.tensor(0, dtype=torch.int32))
    assert new is tree  # updated in place
    assert torch.isfinite(m["loss"]) and int(opt["step"]) == 1


def test_checkpoints_cross_read_between_the_packages(tmp_path):
    """Params and AdamW state of the reduced config: the reference's
    checkpoint read by the port and the reverse, leaf for leaf."""
    ref_cfg, cfg = configs()
    rp = ref_mind.init_params(jax.random.PRNGKey(3), ref_cfg)
    rs = R.init_train_state(rp, R.TrainConfig())
    R.Checkpointer(str(tmp_path / "ref")).save(5, {"params": rp, "opt": rs})
    from_ref, man = T.Checkpointer(str(tmp_path / "ref")).restore()
    assert man["step"] == 5
    want = by_path(jax.tree_util.tree_map(np.asarray, {"params": rp, "opt": rs}))
    got = by_path(from_ref)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    pp = mind.init_tree(torch.Generator().manual_seed(3), cfg)
    ps = T.init_train_state(pp, T.TrainConfig())
    T.Checkpointer(str(tmp_path / "port")).save(6, {"params": pp, "opt": ps})
    from_port, man = R.Checkpointer(str(tmp_path / "port")).restore()
    assert man["step"] == 6
    leaves, spec = tree_flatten({"params": pp, "opt": ps})
    want = by_path(tree_to_numpy(tree_unflatten(leaves, spec)))
    got = by_path(from_port)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=k)
