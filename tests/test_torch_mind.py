"""The port's MIND serving path and embedding-bag op against the JAX
package's.  The reference's random weights go through ``convert.py``
and the batch comes from ``mind_batch``; ``serve_interests`` and
``retrieval_scores`` must agree within 1e-5 of the reference's largest
magnitude (f32, sums in another order), with the bag pooled by the
plain version and by the kernel op on each side.  The tables are
0.02-scale, so interests are about 1e-5 and scores about 1e-6: an
absolute 1e-5 would pass a wrong routing or a dropped profile id.  ``bag_pool`` sweeps the reference kernel test's cases at
its tolerance, and the synthetic batches are byte-identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as ref_data
from repro.configs import mind_cfg as ref_mind_cfg
from repro.kernels.embedding_bag import bag_pool as ref_bag_pool
from repro.models import mind as ref_mind
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch, mind_batch
from repro_torch.kernels import bag_pool, bag_sum, embedding_bag_cuda
from repro_torch.kernels.embedding_bag.kernel import check_bag_args
from repro_torch.models import mind
from repro_torch.models.convert import mind_params_from_numpy

REL_TOL = 1e-5


def assert_close_at_scale(port, ref, rel_tol=REL_TOL):
    """max |port - ref| <= rel_tol * max |ref|."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    scale = float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert scale > 0 and err <= rel_tol * scale, \
        f"max abs diff {err:.3g} > {rel_tol} x max |ref| {scale:.3g}"


def as_torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def mind_setup():
    ref_cfg = ref_mind_cfg.make_config(reduced=True)
    cfg = get_arch("mind").make_config(reduced=True)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_mind.init_params(jax.random.PRNGKey(11), ref_cfg))
    model = mind_params_from_numpy(tree, cfg, device="cpu")
    batch = mind_batch(step=2, batch=16, cfg=cfg, seed=5)
    cands = np.random.default_rng(0).integers(0, cfg.n_items, 300).astype(np.int32)
    return ref_cfg, cfg, tree, model, batch, cands


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
def test_serve_interests_and_retrieval_match_reference(mind_setup, impl):
    ref_cfg, cfg, tree, model, batch, cands = mind_setup
    ref_cfg = dataclasses.replace(ref_cfg, bag_impl=impl)
    cfg = dataclasses.replace(cfg, bag_impl=impl)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    caps = mind.serve_interests(model, as_torch(batch), cfg)
    assert caps.shape == (16, cfg.n_interests, cfg.embed_dim)
    assert_close_at_scale(caps.numpy(), ref_mind.serve_interests(tree, jb, ref_cfg))
    scores = mind.retrieval_scores(model, as_torch(batch), torch.tensor(cands), cfg)
    ref_scores = ref_mind.retrieval_scores(tree, jb, jnp.asarray(cands), ref_cfg)
    assert_close_at_scale(scores.numpy(), ref_scores)


def test_label_aware_attention_matches_reference():
    r = np.random.default_rng(1)
    caps = r.normal(size=(8, 4, 16)).astype(np.float32)
    tgt = r.normal(size=(8, 16)).astype(np.float32)
    port = mind.label_aware_attention(torch.tensor(caps), torch.tensor(tgt), 2.0)
    ref = ref_mind.label_aware_attention(jnp.asarray(caps), jnp.asarray(tgt), 2.0)
    assert_close_at_scale(port.numpy(), ref)


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,d,B,L", [
    (100, 32, 8, 5),
    (1000, 64, 16, 10),
    (50, 128, 4, 20),
    (64, 30, 3, 7),       # d not a multiple of 4 (the kernel's scalar path)
])
def test_bag_pool_matches_reference(impl, mode, V, d, B, L):
    r = np.random.default_rng(V + d + B + L)
    table = r.normal(size=(V, d)).astype(np.float32)
    idx = r.integers(0, V, (B, L)).astype(np.int32)
    mask = r.random((B, L)) > 0.3
    port = bag_pool(torch.tensor(table), torch.tensor(idx), torch.tensor(mask),
                    mode=mode, impl=impl)
    ref = ref_bag_pool(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(mask),
                       mode=mode, impl=impl)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_bag_pool_rejects_unknown_impl():
    z = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="bag impl"):
        bag_pool(torch.zeros((4, 8)), z, z.bool(), impl="cuda")


@pytest.mark.parametrize("args,match", [
    ((torch.zeros(4, 8, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.int32),
      torch.zeros(2, 3)), "table"),
    ((torch.zeros(4, 8), torch.zeros(2, 3, dtype=torch.int64), torch.zeros(2, 3)), "int32"),
    ((torch.zeros(4, 8), torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 4)), "w must"),
    ((torch.zeros(4, 8), torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 3)),
     "CUDA tensor"),
])
def test_bag_kernel_wrapper_raises(args, match):
    with pytest.raises(ValueError, match=match):
        embedding_bag_cuda(*args)


def test_bag_plain_version_on_cpu():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[1, 3, 0]], dtype=torch.int32)
    w = torch.tensor([[2.0, 1.0, 0.0]])
    check_bag_args(table, idx, w)
    assert bag_sum(table, idx, w).tolist() == [[15.0, 18.0, 21.0]]


@pytest.mark.parametrize("step,batch,seed", [(0, 4, 0), (3, 17, 9)])
def test_synthetic_batches_byte_identical(step, batch, seed):
    cfg = get_arch("mind").make_config(reduced=True)
    for port, ref in (
        (mind_batch(step, batch, cfg, seed), ref_data.mind_batch(step, batch, cfg, seed)),
        (lm_batch(step, batch, 64, 241, seed), ref_data.lm_batch(step, batch, 64, 241, seed)),
    ):
        assert port.keys() == ref.keys()
        for k in port:
            assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape
            assert port[k].tobytes() == ref[k].tobytes(), k
