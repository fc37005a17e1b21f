"""Each kernel module of the port against the JAX package: the plain
torch version (what a CPU tensor takes) must equal the reference Pallas
kernel run in interpret mode and its jnp oracle, bit for bit, at the
shapes the reference's own kernel tests sweep.  The CUDA kernels are
held against the same plain versions on the card in test_torch_cuda.py
and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.relax_ell.ops import relax_rows as ref_relax_rows
from repro.kernels.relax_ell.ref import relax_ell_ref as ref_relax_ell_ref
from repro.kernels.relax_push import relax_push_gather as ref_push_gather
from repro.kernels.relax_push import relax_push_ref as ref_push_ref
from repro.kernels.relax_push import relax_push_rows as ref_push_rows
from repro.kernels.superstep_fused import fused_superstep as ref_fused
from repro.kernels.superstep_fused import fused_superstep_ref as ref_fused_ref
from repro_torch.kernels import (
    fused_superstep,
    fused_superstep_cuda,
    relax_ell_cuda,
    relax_push_gather,
    relax_push_gather_cuda,
    relax_push_rows,
    relax_rows,
)


def same(a, b):
    """Bit-identical f32 arrays (+inf compares as itself)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n_pad,R,W,block", [
    (256, 128, 8, 64),
    (512, 300, 16, 128),
    (1024, 65, 32, 256),
    (128, 1, 4, 128),
])
def test_relax_ell_plain_matches_pallas(n_pad, R, W, block):
    rng = np.random.default_rng(n_pad + R)
    dist = np.concatenate([rng.exponential(10, n_pad), [np.inf]]).astype(np.float32)
    col = rng.integers(0, n_pad + 1, (R, W)).astype(np.int32)
    wgt = np.where(col == n_pad, np.inf,
                   rng.uniform(1, 100, (R, W))).astype(np.float32)
    port = relax_rows(t(dist), t(col), t(wgt)).numpy()
    pallas = ref_relax_rows(jnp.asarray(dist), jnp.asarray(col),
                            jnp.asarray(wgt), impl="pallas_interpret",
                            block_rows=block)
    oracle = ref_relax_ell_ref(jnp.asarray(dist), jnp.asarray(col),
                               jnp.asarray(wgt))
    assert same(port, pallas) and same(port, oracle)


@pytest.mark.parametrize("n_local,n_pad,R,W,F", [
    (128, 256, 96, 8, 32),
    (256, 512, 300, 16, 64),
    (64, 128, 40, 4, 64),
    (128, 128, 50, 8, 1),
])
def test_relax_push_plain_matches_pallas(n_local, n_pad, R, W, F):
    rng = np.random.default_rng(n_local + R + F)
    dist = np.concatenate([rng.exponential(10, n_local), [np.inf]]).astype(np.float32)
    row_src = rng.integers(0, n_local, R).astype(np.int32)
    col = rng.integers(0, n_pad + 1, (R, W)).astype(np.int32)
    wgt = np.where(col == n_pad, np.inf,
                   rng.uniform(1, 100, (R, W))).astype(np.float32)
    k = min(F, max(1, R // 3))
    frontier = np.sort(rng.choice(R, k, replace=False)).astype(np.int32)
    row_idx = np.concatenate([frontier, np.full(F - k, R, np.int32)])
    args = [jnp.asarray(a) for a in (dist, row_idx)]
    rest = [jnp.asarray(a) for a in (row_src, col, wgt)]
    cand = relax_push_gather(t(dist), t(row_idx), k, t(row_src), t(col),
                             t(wgt)).numpy()
    pallas = ref_push_gather(*args, jnp.int32(k), *rest, interpret=True)
    assert same(cand, pallas)
    rows = relax_push_rows(t(dist), t(row_idx), k, t(row_src), t(col),
                           t(wgt), n_pad).numpy()
    assert rows.shape == (n_pad + 1,)
    pallas_rows = ref_push_rows(*args, *rest, n_pad, count=jnp.int32(k),
                                impl="pallas_interpret")
    oracle = ref_push_ref(*args, *rest, n_pad)
    assert same(rows[:n_pad], pallas_rows) and same(rows[:n_pad], oracle)


@pytest.mark.parametrize("n_local,n_pad,R,W,F,count", [
    (128, 256, 96, 8, 32, None),
    (256, 512, 300, 16, 64, None),
    (64, 128, 40, 4, 64, None),
    (128, 128, 50, 8, 1, None),
    (64, 96, 30, 3, 12, None),
    (64, 96, 30, 5, 12, None),
    (100, 160, 70, 33, 20, None),
    (100, 160, 70, 33, 20, 0),
    (100, 160, 70, 5, 20, 20),
    (128, 256, 96, 8, 32, 32),
])
def test_relax_push_rows_matches_reference(n_local, n_pad, R, W, F, count):
    """The push relaxation, whose +inf candidates (padding, fill rows)
    the port scatters into spill columns of their own, against the JAX
    package's relax_push_rows: its plain version (which reads no count:
    rows past count are fill rows here) and the Pallas kernel."""
    rng = np.random.default_rng(n_local + R + W + F)
    dist = np.concatenate([rng.exponential(10, n_local), [np.inf]]).astype(np.float32)
    dist[:n_local][rng.random(n_local) < 0.2] = np.inf  # unreached sources
    row_src = rng.integers(0, n_local, R).astype(np.int32)
    col = rng.integers(0, n_pad + 1, (R, W)).astype(np.int32)
    wgt = np.where(col == n_pad, np.inf,
                   rng.uniform(1, 100, (R, W))).astype(np.float32)
    k = min(F, max(1, R // 3)) if count is None else count
    frontier = rng.choice(R, k, replace=False).astype(np.int32)
    row_idx = np.concatenate([frontier, np.full(F - k, R, np.int32)])
    rows = relax_push_rows(t(dist), t(row_idx), k, t(row_src), t(col),
                           t(wgt), n_pad).numpy()
    assert rows.shape == (n_pad + 1,)
    args = [jnp.asarray(a) for a in (dist, row_idx, row_src, col, wgt)]
    ref = ref_push_rows(*args, n_pad, impl="ref")
    pallas = ref_push_rows(*args, n_pad, count=jnp.int32(k),
                           impl="pallas_interpret")
    assert same(rows[:n_pad], ref) and same(rows[:n_pad], pallas)
    assert np.isinf(rows[n_pad])


def _fused_inputs(trial):
    r = np.random.default_rng(trial)
    R, W, n_local, n_out, F = 24, 4, 32, 48, 8
    dist = np.full(n_local + 1, np.inf, np.float32)
    hot = r.choice(n_local, 10, replace=False)
    dist[hot] = r.uniform(0.0, 9.0, 10).astype(np.float32)
    row_src = r.integers(0, n_local, R).astype(np.int32)
    col = r.integers(0, n_out + 1, (R, W)).astype(np.int32)
    wgt = np.where(r.random((R, W)) < 0.3, np.inf,
                   r.uniform(0.1, 5.0, (R, W))).astype(np.float32)
    k = int(r.integers(0, F + 1))
    row_idx = np.full(F, R, np.int32)  # compaction fill sentinel
    row_idx[:k] = r.choice(R, k, replace=False).astype(np.int32)
    return dist, row_idx, k, row_src, col, wgt, n_out


@pytest.mark.parametrize("trial", range(10))
def test_fused_plain_matches_pallas(trial):
    dist, row_idx, k, row_src, col, wgt, n_out = _fused_inputs(trial)
    port = fused_superstep(t(dist), t(row_idx), k, t(row_src), t(col),
                           t(wgt), n_out).numpy()
    j = [jnp.asarray(a) for a in (dist, row_idx, row_src, col, wgt)]
    pallas = ref_fused(j[0], j[1], jnp.int32(k), *j[2:], n_out,
                       interpret=True)
    oracle = ref_fused_ref(*j, n_out)
    assert same(port, pallas) and same(port, oracle)


def test_fused_plain_masks_rows_past_count():
    """Rows listed past ``count`` point at real rows yet contribute
    nothing, in the port as in the Pallas kernel."""
    dist = np.asarray([0.0, 1.0, 2.0, 3.0, np.inf], np.float32)
    row_src = np.asarray([0, 1, 2, 3], np.int32)
    col = np.asarray([[1, 2], [2, 3], [0, 4], [0, 1]], np.int32)
    wgt = np.ones((4, 2), np.float32)
    row_idx = np.asarray([0, 2, 3], np.int32)
    port = fused_superstep(t(dist), t(row_idx), torch.tensor(1, dtype=torch.int32),
                           t(row_src), t(col), t(wgt), 4).numpy()
    pallas = ref_fused(*(jnp.asarray(a) for a in (dist, row_idx)),
                       jnp.int32(1),
                       *(jnp.asarray(a) for a in (row_src, col, wgt)), 4,
                       interpret=True)
    assert same(port, pallas)
    assert port[1] == 1.0 and port[2] == 1.0 and np.isinf(port[0])


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never falls back to the plain version."""
    dist, row_idx, k, row_src, col, wgt, n_out = _fused_inputs(0)
    args = (t(dist), t(row_idx), k, t(row_src), t(col), t(wgt))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_superstep_cuda(*args, n_out)
    with pytest.raises(ValueError, match="CUDA tensor"):
        relax_push_gather_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        relax_ell_cuda(t(dist), t(col), t(wgt))
