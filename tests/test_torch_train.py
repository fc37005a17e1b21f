"""The port's training substrate (``repro_torch.train``) against the JAX
package's ``repro.train`` on the same numpy inputs.

Tolerances, each from what the two sides compute:
- schedules: 4 f32 ulps of 1 (``jnp.cos`` and ``torch.cos`` differ by
  an ulp or two of 1, and near the end of the decay ``1 + cos``
  cancels, so the error is absolute; the rest is the same operations);
- AdamW: 4 ulps of the params' scale (the same operations in the same
  order; XLA may fuse them);
- int8 codes and scales: equal (both round half to even);
- the train step on a small row-wise loss: 1e-6 of the params' scale
  (the loss and its gradient are f32 sums taken in another order; a
  step moves a param by about lr = 1e-2, so a flipped update would show
  as 1e-2).  The reference runs jitted.  Not ``lm_loss``: the
  reference's LM forward fails under jax 0.9.0 (ROADMAP.md Queue 3);
- checkpoints: bit for bit, both ways.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

import repro.train as R
import repro_torch.train as T
from repro_torch.train import compression as C
from repro_torch.train.train_step import _split_batch

ULP = 2.0 ** -23


def to_torch(tree):
    return tree_map(torch.tensor, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def by_path(tree) -> dict:
    """Leaves by path, dict keys sorted, on either side."""
    return T.checkpoint._flatten_with_paths(tree)


def assert_trees_close(port, ref, atol, rtol=0.0):
    p, r = by_path(port), by_path(ref)
    assert sorted(p) == sorted(r)
    for k, a in p.items():
        b = np.asarray(r[k])
        a = a.detach().float().numpy() if a.dtype == torch.bfloat16 else a.detach().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b.astype(a.dtype), atol=atol, rtol=rtol)


def test_exports_are_the_reference_less_what_waits():
    assert set(T.__all__) == set(R.__all__)
    assert callable(T.compression.compressed_psum) and callable(T.state_specs)


# ---------------------------------------------------------------- #
# schedules


@pytest.mark.parametrize("warmup,total,final", [(10, 100, 0.1), (0, 50, 0.0), (7, 7, 0.3)])
def test_schedule_values(warmup, total, final):
    for s in range(0, total + 20):
        ref = float(R.warmup_cosine(jnp.int32(s), warmup_steps=warmup, total_steps=total,
                                    final_frac=final))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = T.warmup_cosine(step, warmup_steps=warmup, total_steps=total,
                                  final_frac=final)
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(float(got) - ref) <= 4 * ULP, (s, float(got), ref)
    steps = np.arange(6, dtype=np.int32)
    got = T.constant(torch.tensor(steps))
    assert got.dtype == torch.float32 and np.array_equal(
        got.numpy(), np.asarray(R.constant(jnp.asarray(steps))))


# ---------------------------------------------------------------- #
# AdamW


def param_tree(rng):
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "l": [rng.normal(size=(4,)).astype(np.float32), np.asarray(0.3, np.float32)]}


def test_global_norm_and_clip():
    rng = np.random.default_rng(1)
    g = param_tree(rng)
    ref_norm = float(R.global_norm(to_jax(g)))
    assert abs(float(T.global_norm(to_torch(g))) - ref_norm) <= 4 * ULP * ref_norm
    for max_norm in (0.5, 100.0):
        clipped, norm = T.clip_by_global_norm(to_torch(g), max_norm)
        rc, rn = R.clip_by_global_norm(to_jax(g), max_norm)
        assert float(norm) == pytest.approx(float(rn), rel=4 * ULP)
        assert_trees_close(clipped, rc, atol=4 * ULP * ref_norm)


@pytest.mark.parametrize("clip", [0.5, 1e9], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("master", [True, False])
def test_apply_updates_matches_reference(clip, master):
    """Five steps of the reference's jitted update and the port's, from
    the same params, state and grads: params, m, v, master, step and the
    metrics."""
    rng = np.random.default_rng(0)
    p = param_tree(rng)
    rcfg = R.AdamWConfig(lr=1e-2, clip_norm=clip, master_fp32=master)
    pcfg = T.AdamWConfig(lr=1e-2, clip_norm=clip, master_fp32=master)
    rp, pp = to_jax(p), to_torch(p)
    rs, ps = R.init_state(rp, rcfg), T.init_state(pp, pcfg)
    assert sorted(ps) == sorted(rs) and ps["step"].dtype == torch.int32
    upd = jax.jit(lambda p_, g_, s_, l_: R.apply_updates(p_, g_, s_, rcfg, l_))
    for i in range(5):
        g = param_tree(rng)
        lr_scale = np.float32(0.5 + 0.1 * i)
        rp, rs, rm = upd(rp, to_jax(g), rs, jnp.float32(lr_scale))
        pp, ps, pm = T.apply_updates(pp, to_torch(g), ps, pcfg, torch.tensor(lr_scale))
        assert_trees_close(pp, rp, atol=4 * ULP * 3)
        for k in ("m", "v") + (("master",) if master else ()):
            assert_trees_close(ps[k], rs[k], atol=4 * ULP * 3, rtol=4 * ULP)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=4 * ULP)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=ULP)


def test_bf16_params_keep_an_f32_master():
    """The reference's ``test_master_fp32_roundtrip`` on both sides:
    tiny updates accumulate in the master while the bf16 params stay
    put; the two masters agree."""
    rcfg = R.AdamWConfig(lr=1e-5, weight_decay=0.0, clip_norm=1e9)
    pcfg = T.AdamWConfig(lr=1e-5, weight_decay=0.0, clip_norm=1e9)
    rp = {"w": jnp.ones((8,), jnp.bfloat16)}
    pp = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    rs, ps = R.init_state(rp, rcfg), T.init_state(pp, pcfg)
    assert ps["master"]["w"].dtype == torch.float32
    rg = {"w": jnp.full((8,), 1e-3, jnp.bfloat16)}
    pg = {"w": torch.full((8,), 1e-3, dtype=torch.bfloat16)}
    for _ in range(3):
        rp, rs, _ = R.apply_updates(rp, rg, rs, rcfg, jnp.float32(1.0))
        pp, ps, _ = T.apply_updates(pp, pg, ps, pcfg, torch.tensor(1.0))
    assert pp["w"].dtype == torch.bfloat16
    assert float(ps["master"]["w"][0]) != 1.0
    np.testing.assert_allclose(ps["master"]["w"].numpy(), np.asarray(rs["master"]["w"]),
                               rtol=4 * ULP)
    assert np.array_equal(pp["w"].float().numpy(), np.asarray(rp["w"], np.float32))


def test_tree_structures_must_match():
    p = to_torch(param_tree(np.random.default_rng(0)))
    s = T.init_state(p, T.AdamWConfig())
    with pytest.raises(ValueError, match="tree structure"):
        T.apply_updates(p, {"a": p["a"]}, s, T.AdamWConfig(), torch.tensor(1.0))


# ---------------------------------------------------------------- #
# int8 compression


def test_int8_codes_equal_the_reference():
    rng = np.random.default_rng(3)
    cases = [(rng.normal(size=(1000,)) * 10.0 ** e).astype(np.float32) for e in range(-3, 3)]
    cases.append(np.zeros(7, np.float32))
    # values exactly half-way between two codes: both round half to even
    cases.append((np.arange(-254, 255, dtype=np.float32) / 2.0))
    for x in cases:
        rq, rs = R.compression.quantize_int8(jnp.asarray(x))
        pq, ps = C.quantize_int8(torch.tensor(x))
        assert pq.dtype == torch.int8 and np.array_equal(pq.numpy(), np.asarray(rq))
        assert np.float32(ps).tobytes() == np.float32(rs).tobytes()
        assert np.array_equal(C.dequantize_int8(pq, ps).numpy(),
                              np.asarray(R.compression.dequantize_int8(rq, rs)))
    x = cases[2]
    rq, _ = R.compression.quantize_int8(jnp.asarray(x), jnp.float32(0.01))
    pq, _ = C.quantize_int8(torch.tensor(x), torch.tensor(0.01))
    assert np.array_equal(pq.numpy(), np.asarray(rq))


def test_error_feedback_sums():
    """Twenty rounds of error feedback: the codes equal the reference's
    each round, the errors agree, and on both sides the sent sum plus
    the last error is the sum of the inputs (the reference test's
    tolerance, 1e-4)."""
    rng = np.random.default_rng(0)
    grads = [(rng.normal(size=(64,)) * 10.0 ** float(rng.integers(-3, 2))).astype(np.float32)
             for _ in range(20)]
    r_err, p_err = jnp.zeros((64,), jnp.float32), torch.zeros(64)
    sent = torch.zeros(64)
    for g in grads:
        rq, rs, r_err = R.compression.ef_compress(jnp.asarray(g), r_err)
        pq, ps, p_err = C.ef_compress(torch.tensor(g), p_err)
        assert np.array_equal(pq.numpy(), np.asarray(rq))
        np.testing.assert_allclose(p_err.numpy(), np.asarray(r_err), atol=1e-6)
        sent = sent + C.dequantize_int8(pq, ps)
    np.testing.assert_allclose((sent + p_err).numpy(), np.sum(grads, axis=0),
                               rtol=1e-4, atol=1e-4)


def test_ef_compress_tree_matches_reference():
    rng = np.random.default_rng(5)
    g, e = param_tree(rng), param_tree(rng)
    e = {"a": e["a"] * 0.01, "l": [x * 0.01 for x in e["l"]]}
    rc, rerr = R.compression.ef_compress_tree(to_jax(g), to_jax(e))
    pc, perr = C.ef_compress_tree(to_torch(g), to_torch(e))
    assert {k: q.numpy().tolist() for k, q in by_path(pc["q"]).items()} == \
        {k: np.asarray(q).tolist() for k, q in by_path(rc["q"]).items()}
    assert_trees_close(pc["scale"], rc["scale"], atol=0)
    assert_trees_close(perr, rerr, atol=1e-7)
    assert_trees_close(C.dequantize_tree(pc), R.compression.dequantize_tree(rc), atol=0)
    zeros = C.init_error_tree(to_torch(g))
    assert all(z.dtype == torch.float32 and not z.any() for z in tree_leaves(zeros))
    with pytest.raises(ValueError, match="error tree"):
        C.ef_compress_tree(to_torch(g), {"a": zeros["a"]})


# ---------------------------------------------------------------- #
# the train step


def ref_loss(p, b):
    h = jnp.tanh(b["x"] @ p["w0"] + p["b0"])
    return jnp.mean((h @ p["w1"] + p["b1"] - b["y"]) ** 2)


def port_loss(p, b):
    h = torch.tanh(b["x"] @ p["w0"] + p["b0"])
    return torch.mean((h @ p["w1"] + p["b1"] - b["y"]) ** 2)


def mlp_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w0": rng.normal(size=(6, 8)).astype(np.float32),
              "b0": np.zeros(8, np.float32),
              "w1": (rng.normal(size=(8, 2)) * 0.3).astype(np.float32),
              "b1": np.zeros(2, np.float32),
              "unused": np.ones(3, np.float32)}
    batch = {"x": rng.normal(size=(16, 6)).astype(np.float32),
             "y": rng.normal(size=(16, 2)).astype(np.float32)}
    return params, batch


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("compress", [False, True], ids=["exact", "int8"])
def test_train_step_matches_reference(microbatches, compress):
    """Three steps of ``build_train_step`` (AdamW, warmup-cosine, clip)
    on a row-wise MLP loss, in one batch or 4 microbatches, with the
    exact or the int8 error-feedback accumulator."""
    params, batch = mlp_case()
    kw = dict(microbatches=microbatches, compress_accum=compress, warmup_steps=2,
              total_steps=10)
    rtc = R.TrainConfig(adamw=R.AdamWConfig(lr=1e-2), **kw)
    ptc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), **kw)
    rstep = jax.jit(R.build_train_step(ref_loss, rtc))
    pstep = T.build_train_step(port_loss, ptc)
    rp, pp = to_jax(params), to_torch(params)
    rs, ps = R.init_train_state(rp, rtc), T.init_train_state(pp, ptc)
    rb, pb = to_jax(batch), to_torch(batch)
    for i in range(3):
        rp, rs, rm = rstep(rp, rs, rb, jnp.int32(i))
        pp, ps, pm = pstep(pp, ps, pb, i)
        assert_trees_close(pp, rp, atol=1e-6)
        assert sorted(pm) == sorted(rm) == ["grad_norm", "loss", "lr"]
        for k in pm:
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-6, abs=1e-7), k
    assert float(pp["unused"][0]) < 1.0  # no gradient, but weight decay


def test_microbatches_split_rows():
    batch = {"x": torch.arange(24.0).reshape(8, 3), "y": torch.arange(8)}
    parts = _split_batch(batch, 4)
    assert len(parts) == 4 and parts[1]["x"].tolist() == [[6.0, 7.0, 8.0], [9.0, 10.0, 11.0]]
    assert [p["y"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not split"):
        _split_batch(batch, 3)


def test_resume_is_idempotent(tmp_path):
    """4 steps straight equal 2 steps, a checkpoint, a restore and 2
    more, bit for bit (the reference's ``test_resume_is_idempotent`` on
    the port, with the MLP loss)."""
    params, batch = mlp_case(1)
    tc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), warmup_steps=2, total_steps=4)
    step = T.build_train_step(port_loss, tc)
    b = to_torch(batch)
    p, s = to_torch(params), T.init_train_state(to_torch(params), tc)
    for i in range(4):
        p, s, _ = step(p, s, b, i)
    p2, s2 = to_torch(params), T.init_train_state(to_torch(params), tc)
    for i in range(2):
        p2, s2, _ = step(p2, s2, b, i)
    ck = T.Checkpointer(str(tmp_path))
    ck.save(2, {"params": p2, "opt": s2})
    tree, man = ck.restore()
    p3, s3 = tree["params"], tree["opt"]
    for i in range(man["step"], 4):
        p3, s3, _ = step(p3, s3, b, i)
    for a, c in zip(tree_leaves(p), tree_leaves(p3)):
        assert torch.equal(a, c)


# ---------------------------------------------------------------- #
# checkpoints


def port_tree():
    return {"a": torch.arange(5, dtype=torch.int32), "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16) * 1.5},
            "l": [torch.zeros(2), torch.tensor([1.0, 2.0, 3.0])],
            "step": torch.tensor(7, dtype=torch.int32), "mask": torch.tensor([True, False]),
            "q": torch.tensor([-127, 0, 5], dtype=torch.int8)}


def ref_tree():
    return {"a": jnp.arange(5), "b": {"c": jnp.ones((2, 3), jnp.bfloat16) * 1.5},
            "l": [jnp.zeros(2), jnp.asarray([1.0, 2.0, 3.0])],
            "step": jnp.int32(7), "mask": jnp.asarray([True, False]),
            "q": jnp.asarray([-127, 0, 5], jnp.int8)}


def assert_same_leaves(port, ref):
    """Port tensors against reference arrays: dtype names and bits."""
    p, r = by_path(port), by_path(ref)
    assert sorted(p) == sorted(r)
    for k in p:
        a, b = p[k], np.asarray(r[k])
        assert str(a.dtype).split(".")[-1] == str(b.dtype), k
        host = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        assert host.tobytes() == b.tobytes() and host.shape == b.shape, k


def test_roundtrip_and_latest(tmp_path):
    ck = T.Checkpointer(str(tmp_path))
    tree = port_tree()
    ck.save(3, tree)
    ck.save(7, tree)
    assert ck.latest_step() == 7
    out, man = ck.restore(step=3)
    assert man["step"] == 3 and out["b"]["c"].dtype == torch.bfloat16
    for k, v in by_path(tree).items():
        got = by_path(out)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    assert isinstance(out["l"], list)
    on = ck.restore(device="meta")[0]
    assert on["a"].device.type == "meta"


def test_async_save_and_snapshot(tmp_path):
    """save_async copies the leaves first: a write after the call does
    not reach the file."""
    ck = T.Checkpointer(str(tmp_path))
    w = torch.arange(100.0)
    ck.save_async(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    out, _ = ck.restore()
    assert torch.equal(out["w"], torch.arange(100.0))


def test_no_partial_checkpoint_visible(tmp_path):
    ck = T.Checkpointer(str(tmp_path))
    os.makedirs(tmp_path / ".tmp-step_9")
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.restore()
    ck.save(1, {"w": torch.zeros(2)})
    assert ck.latest_step() == 1
    os.makedirs(tmp_path / ".tmp-step_2")
    (tmp_path / ".tmp-step_2" / "stale").write_text("x")
    ck.save(2, {"w": torch.ones(2)})  # a stale tmp dir of the same step goes first
    assert sorted(os.listdir(tmp_path)) == [".tmp-step_9", "LATEST", "step_1", "step_2"]


def test_checkpoints_cross_read_both_ways(tmp_path):
    """The port's checkpoint is the reference's, file for file: the same
    names, manifests and bytes; each package restores the other's."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    T.Checkpointer(str(port_dir)).save(4, port_tree())
    R.Checkpointer(str(ref_dir)).save(4, ref_tree())
    assert sorted(os.listdir(port_dir / "step_4")) == sorted(os.listdir(ref_dir / "step_4"))
    for name in os.listdir(ref_dir / "step_4"):
        a, b = (d / "step_4" / name for d in (port_dir, ref_dir))
        if name == "manifest.json":
            assert json.loads(a.read_text()) == json.loads(b.read_text())
        else:
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert (port_dir / "LATEST").read_text() == (ref_dir / "LATEST").read_text()
    ref_out, _ = R.Checkpointer(str(port_dir)).restore()
    assert_same_leaves(port_tree(), ref_out)
    port_out, man = T.Checkpointer(str(ref_dir)).restore()
    assert man["step"] == 4
    assert_same_leaves(port_out, ref_tree())
