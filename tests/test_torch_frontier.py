"""The owner-side combine of the sparse exchange,
``repro_torch.core.frontier.unpack_combine``, against a slot-by-slot
loop and against the JAX package's ``unpack_combine`` rank by rank, bit
for bit: segments all empty, full and partly filled, with and without
the level plane, min and max.  Empty slots carry ``worst`` and the index
sentinel n_local; the port scatters each into a spill column of its
own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.frontier import unpack_combine as ref_unpack_combine
from repro_torch.core.frontier import unpack_combine

N_LOCAL, SLOTS = 40, 16


def payload(seed, n_parts, fill, is_min, has_level):
    """(P_dst, P_src, K·S) payload: each (dst, src) segment lists
    distinct owned vertices in order, then empty slots."""
    r = np.random.default_rng(seed)
    worst = np.inf if is_min else -np.inf
    K = 3 if has_level else 2
    recv = np.zeros((n_parts, n_parts, K * SLOTS), np.float32)
    for q in range(n_parts):
        for p in range(n_parts):
            k = {"empty": 0, "full": SLOTS}.get(fill, int(r.integers(0, SLOTS + 1)))
            idx = np.full(SLOTS, N_LOCAL, np.int32)
            idx[:k] = np.sort(r.choice(N_LOCAL, k, replace=False))
            val = np.full(SLOTS, worst, np.float32)
            val[:k] = r.integers(0, 6, k)  # small integers: ties across sources
            lvl = np.full(SLOTS, np.inf, np.float32)
            lvl[:k] = r.integers(0, 4, k)
            planes = [val, idx.view(np.float32)] + ([lvl] if has_level else [])
            recv[q, p] = np.concatenate(planes)
    return recv, float(worst)


def slot_loop(recv_q, is_min, worst, has_level):
    """The combine one slot at a time, for one destination rank."""
    better = (lambda a, b: a < b) if is_min else (lambda a, b: a > b)
    mine = np.full(N_LOCAL, worst, np.float32)
    mineL = np.full(N_LOCAL, np.inf, np.float32)
    segs = recv_q.reshape(recv_q.shape[0], -1, SLOTS)
    for seg in segs:
        for s in range(SLOTS):
            i = int(seg[1, s:s + 1].view(np.int32)[0])
            if i < N_LOCAL and better(seg[0, s], mine[i]):
                mine[i] = seg[0, s]
    if has_level:
        for seg in segs:
            for s in range(SLOTS):
                i = int(seg[1, s:s + 1].view(np.int32)[0])
                if i < N_LOCAL and seg[0, s] == mine[i]:
                    mineL[i] = min(mineL[i], seg[2, s])
    return mine, mineL


@pytest.mark.parametrize("fill", ["empty", "full", "partial"])
@pytest.mark.parametrize("has_level", [False, True])
@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("n_parts", [1, 3])
def test_unpack_combine_matches_slot_loop_and_reference(fill, has_level, is_min,
                                                        n_parts):
    seed = 7 * n_parts + 2 * has_level + is_min
    recv, worst = payload(seed, n_parts, fill, is_min, has_level)
    mine, mineL = unpack_combine(torch.from_numpy(recv), N_LOCAL, SLOTS, is_min,
                                 worst, has_level)
    assert mine.shape == (n_parts, N_LOCAL)
    assert (mineL is not None) == has_level
    for q in range(n_parts):
        loop, loopL = slot_loop(recv[q], is_min, worst, has_level)
        ref, refL = ref_unpack_combine(jnp.asarray(recv[q]), N_LOCAL, SLOTS, is_min,
                                       worst, has_level)
        assert torch.equal(mine[q], torch.from_numpy(loop))
        assert torch.equal(mine[q], torch.from_numpy(np.asarray(ref)))
        if has_level:
            assert torch.equal(mineL[q], torch.from_numpy(loopL))
            assert torch.equal(mineL[q], torch.from_numpy(np.asarray(refL)))
