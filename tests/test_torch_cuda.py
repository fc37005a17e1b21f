"""The port's CUDA kernels and its solve on the card, held against the
plain torch versions on the same inputs: bit-identical.  Needs an
NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs on a
machine with the card alone:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.api import Problem, SingleSource, Solver, SolverConfig
from repro_torch.core.selfstab import synchronous_sweep
from repro_torch.graph import rmat1, small_world_graph

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    K.build()
    return torch.device("cuda")


def on(dev, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in arrays]


def frontier_case(seed, n_local, n_out, R, W, F):
    r = np.random.default_rng(seed)
    dist = np.full(n_local + 1, np.inf, np.float32)
    hot = r.choice(n_local, max(1, n_local // 3), replace=False)
    dist[hot] = r.integers(0, 50, hot.shape[0]).astype(np.float32)
    row_src = r.integers(0, n_local, R).astype(np.int32)
    col = r.integers(0, n_out + 1, (R, W)).astype(np.int32)
    wgt = np.where(r.random((R, W)) < 0.3, np.inf,
                   r.integers(1, 100, (R, W))).astype(np.float32)
    k = int(r.integers(0, F + 1))
    row_idx = np.full(F, R, np.int32)
    row_idx[:k] = r.integers(0, R, k)  # repeated rows allowed
    return dist, row_idx, k, row_src, col, wgt


CASES = [(0, 32, 48, 24, 4, 8), (1, 128, 256, 96, 8, 32),
         (2, 256, 512, 300, 16, 64), (3, 1000, 1000, 1200, 64, 150),
         (4, 5000, 5000, 6000, 128, 700), (5, 64, 128, 40, 4, 64)]


@pytest.mark.parametrize("case", CASES)
def test_frontier_kernels_match_plain(dev, case):
    n_out = case[2]
    dist, row_idx, k, row_src, col, wgt = frontier_case(*case)
    d, i, rs, c, w = on(dev, dist, row_idx, row_src, col, wgt)
    cnt = torch.tensor(k, dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    fused = K.fused_superstep_cuda(d, i, cnt, rs, c, w, n_out)
    push = K.relax_push_gather_cuda(d, i, cnt, rs, c, w)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["fused_superstep"] == 1 and counts["relax_push_gather"] == 1
    assert torch.equal(fused, K.fused_superstep_ref(d, i, cnt, rs, c, w, n_out))
    assert torch.equal(push, K.relax_push_gather_ref(d, i, cnt, rs, w))
    cpu = K.fused_superstep_ref(*on("cpu", dist, row_idx), k,
                                *on("cpu", row_src, col, wgt), n_out)
    assert torch.equal(fused.cpu(), cpu)


@pytest.mark.parametrize("n_pad,R,W", [
    (256, 128, 8), (512, 300, 16), (1024, 65, 32), (128, 1, 4),
    (4096, 5000, 64), (300, 777, 128), (50, 10, 33),
])
def test_relax_ell_matches_plain(dev, n_pad, R, W):
    r = np.random.default_rng(n_pad + R + W)
    dist = np.concatenate([r.exponential(10, n_pad), [np.inf]]).astype(np.float32)
    col = r.integers(0, n_pad + 1, (R, W)).astype(np.int32)
    wgt = np.where(col == n_pad, np.inf, r.uniform(1, 100, (R, W))).astype(np.float32)
    d, c, w = on(dev, dist, col, wgt)
    out = K.relax_ell_cuda(d, c, w)
    torch.cuda.synchronize()
    assert torch.equal(out, K.relax_ell_ref(d, c, w))
    assert torch.equal(out.cpu(), K.relax_ell_ref(*on("cpu", dist, col, wgt)))


def test_wrappers_reject_bad_inputs(dev):
    dist, row_idx, k, row_src, col, wgt = frontier_case(*CASES[1])
    d, i, rs, c, w = on(dev, dist, row_idx, row_src, col, wgt)
    with pytest.raises(ValueError, match="int32"):
        K.fused_superstep_cuda(d, i.long(), k, rs, c, w, 256)
    with pytest.raises(ValueError, match="contiguous"):
        K.relax_ell_cuda(d, c.t(), w.t())
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.relax_push_gather_cuda(d.cpu(), i, k, rs, c, w)


@pytest.mark.parametrize("spec,impl", [
    ("delta:5/sparse/fused", "fused"), ("delta:5/sparse", "push"),
    ("kla:2+threadq/sparse", "ref"), ("chaotic+nodeq/pmin", "ref"),
    ("delta:3+numaq/auto", "fused"), ("dijkstra/a2a", "ref"),
])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_solve_on_card_matches_cpu(dev, spec, impl, n_parts):
    g = rmat1(10, seed=1)
    cfg = SolverConfig.from_spec(spec, relax_impl=impl)
    K.reset_launch_counts()
    card = Solver(cfg, n_parts=n_parts).solve(Problem(g, SingleSource(0)))
    launched = K.launch_counts()
    cpu = Solver(cfg, n_parts=n_parts, device="cpu").solve(
        Problem(g, SingleSource(0)))
    assert card.state.tobytes() == cpu.state.tobytes()
    assert card.metrics.as_dict() == cpu.metrics.as_dict()
    if impl == "fused" and "kla" not in spec:
        assert launched["fused_superstep"] > 0
    if impl == "push":
        assert launched["relax_push_gather"] > 0


def test_sweep_on_card_matches_cpu(dev):
    g = small_world_graph(3000, seed=2)
    d0 = np.random.default_rng(0).integers(0, 60, g.n).astype(np.float32)
    K.reset_launch_counts()
    card = synchronous_sweep(g, 0, d0, 2000)
    assert K.launch_counts()["relax_ell"] > 0
    cpu = synchronous_sweep(g, 0, d0, 2000, device="cpu")
    assert card.tobytes() == cpu.tobytes()
