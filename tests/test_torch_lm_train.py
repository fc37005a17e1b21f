"""LM training in the port against the JAX package's, at the reduced
configs of phi3-mini (GQA), minicpm3 (MLA, tied embeddings) and
phi3.5-moe (GQA with MoE, its aux loss in the loss): the reference's
random weights go through ``convert.py``, the batch is ``lm_batch``'s
tokens with about a fifth of the labels set below 0 (masked).

- ``lm_loss`` and its gradient, leaf by leaf, against the reference's
  jitted ``jax.value_and_grad(lm_loss)``: the loss within 1e-6 of its
  value, each gradient within 2e-5 of the leaf's max |grad| (f32 sums in
  another order; the worst leaf measured 2.5e-6).
- phi3-mini at D 64 through ``attn_impl="pallas"``: the FlashAttention
  Function's CPU route (its plain backward) against the reference's
  ``"xla"`` attention, at the same tolerances.
- ``remat`` "none" and "full" give the same bits.
- Two train steps (AdamW, warmup-cosine, clip) against the reference's
  step: its ``build_train_step`` body at one microbatch, composed from
  the same jitted value_and_grad so that nothing compiles twice; params
  and master weights within 1e-3, as test_torch_gin_train.py at the same
  lr 1e-2 (an element whose gradient is near f32 noise takes a visibly
  different Adam step; the worst gap measured 2.0e-4, one element of
  ``layers.wd``).  The in-place (donated) step gives
  the bits of the functional one.
- ``launch/train.py --device cpu`` resumes idempotently, and a
  checkpoint written by either package is read by the other.

The reference's LM runs on a one-device mesh whose axis is Auto: on
``single_device_topology()``'s Explicit axis its ``forward`` fails under
this jax (ROADMAP.md, Queue 3)."""

import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

import repro.train as R
import repro_torch.train as T
from repro.configs import minicpm3 as ref_minicpm3
from repro.configs import phi3_mini as ref_phi3_mini
from repro.configs import phi35_moe as ref_phi35_moe
from repro.models import lm as ref_lm
from repro.models.common import Topology
from repro_torch import kernels as K
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.models.convert import lm_tree_from_numpy, tree_to_numpy
from repro_torch.train.checkpoint import _flatten_with_paths as by_path
from repro_torch.train.train_step import value_and_grad

KINDS = {"gqa": ref_phi3_mini, "mla": ref_minicpm3, "moe": ref_phi35_moe}
B, S = 2, 64
LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 1e-6, 2e-5, 1e-3
# phi3-mini's reduced config at D 64: the kernel's smallest head dim
PALLAS_OVER = dict(d_model=128, n_heads=2, n_kv_heads=2)


@functools.cache
def auto_topology() -> Topology:
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    return Topology(mesh=mesh, dp_axes=("data",), tp_axis=None)


def configs(kind, **over):
    mod = KINDS[kind]
    ref = dataclasses.replace(mod.make_config(reduced=True), **over)
    port = dataclasses.replace(get_arch(mod.ARCH_ID).make_config(reduced=True), **over)
    return ref, port


def batch_for(vocab: int) -> dict:
    b = lm_batch(0, B, S, vocab, seed=3)
    r = np.random.default_rng(1)
    b["labels"] = np.where(r.random((B, S)) < 0.2, -1, b["labels"]).astype(np.int32)
    return b


@functools.cache
def ref_grad_fn(ref_cfg):
    topo = auto_topology()
    return jax.jit(jax.value_and_grad(lambda p, b: ref_lm.lm_loss(p, b, ref_cfg, topo)))


@functools.cache
def case(kind, pallas: bool = False):
    """(ref cfg, port cfg, the reference's weights as numpy, the batch,
    its loss and gradients as numpy), one reference compile a case."""
    ref_cfg, port_cfg = configs(kind, **(PALLAS_OVER if pallas else {}))
    if pallas:
        port_cfg = dataclasses.replace(port_cfg, attn_impl="pallas")
    tree = jax.tree_util.tree_map(np.asarray, ref_lm.init_params(jax.random.PRNGKey(7), ref_cfg))
    batch = batch_for(ref_cfg.vocab)
    loss, grads = ref_grad_fn(ref_cfg)(tree, batch)
    return ref_cfg, port_cfg, tree, batch, float(loss), jax.tree_util.tree_map(np.asarray, grads)


def port_loss_and_grads(tree, batch, cfg):
    params = lm_tree_from_numpy(tree, cfg, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    return value_and_grad(lambda p, b: lm.lm_loss(p, b, cfg))(params, tb)


def assert_trees_close(port_tree, ref_tree, tol=GRAD_TOL, atol=None):
    """Leaf by leaf, within ``tol`` of the reference leaf's max |value|
    (or within ``atol``)."""
    got, want = by_path(tree_to_numpy(port_tree)), by_path(ref_tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=tol * np.abs(w).max() if atol is None else atol,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["gqa", "mla", "moe"])
def test_loss_and_grads_match_reference(kind):
    _, cfg, tree, batch, ref_loss, ref_grads = case(kind)
    loss, grads = port_loss_and_grads(tree, batch, cfg)
    assert loss.dtype == torch.float32
    assert float(loss) == pytest.approx(ref_loss, rel=LOSS_RTOL)
    assert_trees_close(grads, ref_grads)


def test_pallas_route_matches_reference_xla():
    """The kernel route (FlashAttention's CPU route: the plain forward
    with lse, the plain backward) against the reference's plain
    attention; under remat each layer's forward runs twice."""
    _, cfg, tree, batch, ref_loss, ref_grads = case("gqa", pallas=True)
    assert cfg.head_dim == 64 and cfg.remat == "full"
    K.reset_launch_counts()
    loss, grads = port_loss_and_grads(tree, batch, cfg)
    calls = K.call_counts()
    assert calls["flash_attention"]["ref"] == 2 * cfg.n_layers
    assert calls["flash_attention_bwd"]["ref"] == cfg.n_layers
    assert float(loss) == pytest.approx(ref_loss, rel=LOSS_RTOL)
    assert_trees_close(grads, ref_grads)


@pytest.mark.parametrize("kind", ["gqa", "mla", "moe"])
def test_remat_none_and_full_give_the_same_bits(kind):
    _, cfg, tree, batch, _, _ = case(kind)
    assert cfg.remat == "full"
    full = port_loss_and_grads(tree, batch, cfg)
    none = port_loss_and_grads(tree, batch, dataclasses.replace(cfg, remat="none"))
    assert torch.equal(full[0], none[0])
    for a, b in zip(tree_flatten(full[1])[0], tree_flatten(none[1])[0]):
        assert torch.equal(a, b)


def test_two_train_steps_match_reference():
    ref_cfg, cfg, tree, batch, _, _ = case("gqa")
    kw = dict(warmup_steps=2, total_steps=10)
    rtc = R.TrainConfig(adamw=R.AdamWConfig(lr=1e-2), **kw)
    ptc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), **kw)
    grad_fn = ref_grad_fn(ref_cfg)
    update = jax.jit(lambda p, g, s, l: R.apply_updates(p, g, s, rtc.adamw, l))
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs = R.init_train_state(rp, rtc)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    step = T.build_train_step(lambda p, b: lm.lm_loss(p, b, cfg), ptc)
    donated = T.build_train_step(lambda p, b: lm.lm_loss(p, b, cfg), ptc, donate=True)
    pp = lm_tree_from_numpy(tree, cfg, device="cpu")
    ps = T.init_train_state(pp, ptc)
    dp = tree_map(torch.clone, pp)
    ds = T.init_train_state(dp, ptc)
    for i in range(2):
        rloss, rg = grad_fn(rp, batch)
        lr_scale = R.warmup_cosine(jnp.int32(i), **kw)
        rp, rs, _ = update(rp, rg, rs, lr_scale)
        pp, ps, pm = step(pp, ps, tb, torch.tensor(i, dtype=torch.int32))
        dp_new, ds, dm = donated(dp, ds, tb, torch.tensor(i, dtype=torch.int32))
        assert dp_new is dp  # updated in place
        assert float(pm["loss"]) == pytest.approx(float(rloss), rel=LOSS_RTOL)
        assert torch.equal(pm["loss"], dm["loss"])
    for a, b in zip(tree_flatten((pp, ps))[0], tree_flatten((dp, ds))[0]):
        assert torch.equal(a, b)
    assert_trees_close(pp, jax.tree_util.tree_map(np.asarray, rp), atol=PARAM_ATOL)
    assert_trees_close(ps["master"], jax.tree_util.tree_map(np.asarray, rs["master"]),
                       atol=PARAM_ATOL)


def run_cli(ckpt_dir, steps, capsys):
    train_cli.main(["--device", "cpu", "--steps", str(steps), "--batch", "2", "--seq", "32",
                    "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2"])
    return capsys.readouterr().out


def test_train_cli_resumes_idempotently(tmp_path, capsys):
    """Four steps straight, and the same run resumed from its step-2
    checkpoint: the final checkpoints are equal bit for bit."""
    out = run_cli(tmp_path / "a", 4, capsys)
    assert "[train] step     0 loss=" in out and "gnorm=" in out and " lr=" in out
    assert "[train] checkpointed step 4" in out
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    (tmp_path / "b" / "LATEST").write_text("2")
    out = run_cli(tmp_path / "b", 4, capsys)
    assert "[train] resumed from step 2" in out
    a, _ = T.Checkpointer(str(tmp_path / "a")).restore()
    b, _ = T.Checkpointer(str(tmp_path / "b")).restore()
    ga, gb = by_path(a), by_path(b)
    assert sorted(ga) == sorted(gb) and int(a["opt"]["step"]) == 4
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k
    with pytest.raises(SystemExit, match="LM family"):
        train_cli.main(["--device", "cpu", "--arch", "gin-tu"])


def test_checkpoints_cross_read_between_the_packages(tmp_path):
    """bf16 params with their f32 master, m, v and the int32 step: the
    port's checkpoint read by the reference's Checkpointer and the
    reverse, leaf for leaf."""
    ref_cfg, cfg = configs("moe", param_dtype="bfloat16")
    rp = ref_lm.init_params(jax.random.PRNGKey(3), ref_cfg)
    rs = R.init_train_state(rp, R.TrainConfig())
    R.Checkpointer(str(tmp_path / "ref")).save(5, {"params": rp, "opt": rs})
    from_ref, man = T.Checkpointer(str(tmp_path / "ref")).restore()
    assert man["step"] == 5 and from_ref["params"]["embed"].dtype == torch.bfloat16
    assert from_ref["opt"]["step"].dtype == torch.int32
    want = by_path(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                          {"params": rp, "opt": rs}))
    got = by_path(from_ref)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), w, err_msg=k)

    pp = lm.init_tree(torch.Generator().manual_seed(3), cfg)
    ps = T.init_train_state(pp, T.TrainConfig())
    T.Checkpointer(str(tmp_path / "port")).save(6, {"params": pp, "opt": ps})
    from_port, man = R.Checkpointer(str(tmp_path / "port")).restore()
    assert man["step"] == 6 and from_port["params"]["embed"].dtype == jnp.bfloat16
    leaves, spec = tree_flatten({"params": pp, "opt": ps})
    want = by_path(tree_to_numpy(tree_unflatten(leaves, spec)))
    got = by_path(from_port)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), w, err_msg=k)
