"""The host-side plans of two kernels, checked on the CPU.

* The f32 flash_attention's key split (``kernels/flash_attention/kernel.py``:
  ``split_plan``, ``key_tiles``, ``chunk_bounds``): every key tile a q
  tile visits lies in exactly one chunk, no tile wholly above the causal
  diagonal is listed, and the split stops once the grid fills the card.
  The same split in plain torch (``ref.attention_partials_ref`` and
  ``ref.merge_partials_ref``, the formula the CUDA merge uses) is held
  against the JAX package's attention at its f32 tolerance, 2e-5.
* The batched frontier kernels' share of the grid (``csrc/minplus.cuh``,
  ``LaneShares``): a model of it in plain torch, with the CUDA code's
  double-precision arithmetic, must visit every (lane, f < count[lane])
  exactly once, for the live rows and for the push gather's tail.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import mha as ref_mha
from repro_torch.kernels.flash_attention.kernel import (
    BLOCK_K,
    BLOCK_Q,
    chunk_bounds,
    key_tiles,
    split_plan,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_partials_ref,
    merge_partials_ref,
)

H100_SMS = 132

# B, Hq, Sq, Sk, causal
PLAN_SHAPES = [
    (1, 8, 128, 1024, True), (1, 8, 128, 1024, False), (1, 2, 128, 4096, True),
    (2, 32, 2048, 2048, True), (2, 32, 1920, 1920, True), (1, 1, 256, 256, True),
    (1, 4, 384, 384, True), (1, 1, 128, 128, False), (4, 32, 128, 2048, True),
    (1, 2, 512, 1024, True), (1, 16, 1024, 1024, True),
]


@pytest.mark.parametrize("B,Hq,Sq,Sk,causal", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 16])
def test_split_plan_covers_every_visited_tile_once(B, Hq, Sq, Sk, causal, sms):
    n_split = split_plan(B, Hq, Sq, Sk, causal, sms)
    grid = B * Hq * (Sq // BLOCK_Q)
    assert n_split >= 1
    if grid >= sms:
        assert n_split == 1
    else:  # the split fills the card, or runs out of key tiles
        assert n_split * grid >= sms or n_split == key_tiles(0, Sq, Sk, causal)
    for qt in range(Sq // BLOCK_Q):
        n_tiles = key_tiles(qt, Sq, Sk, causal)
        listed = []
        for c in range(n_split):
            lo, hi = chunk_bounds(n_tiles, n_split, c)
            assert lo < hi, "an empty chunk"
            listed += range(lo, hi)
        assert listed == list(range(n_tiles))  # each once, in order
        last_key = qt * BLOCK_Q + BLOCK_Q - 1 + Sk - Sq  # the tile's last row
        for t in listed:  # a tile some row of the q tile sees
            assert t * BLOCK_K <= last_key
        if causal:  # and every tile with a key some row sees
            assert n_tiles * BLOCK_K > min(last_key, Sk - 1)
        else:
            assert n_tiles == Sk // BLOCK_K


def test_split_plan_case_c_engages_the_split():
    """chip_smoke's case c: 8 blocks on 132 SMs split 16 ways; the fp32
    twin's prefill (case d) fills the card unsplit."""
    assert split_plan(1, 8, 128, 1024, True, H100_SMS) == 16
    assert split_plan(1, 8, 128, 1024, False, H100_SMS) == 16
    assert split_plan(2, 32, 2048, 2048, True, H100_SMS) == 1


def inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


# B, Hq, Hkv, Sq, Sk, D, impl of the reference
MERGE_CASES = [
    (1, 2, 1, 128, 512, 64, "ref"),
    (1, 4, 2, 128, 384, 96, "ref"),
    (1, 8, 2, 128, 1024, 128, "ref"),
    (1, 2, 2, 256, 256, 128, "ref"),
    (1, 2, 1, 256, 512, 96, "ref"),
    (1, 2, 1, 128, 256, 64, "pallas_interpret"),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,impl", MERGE_CASES)
def test_merged_partials_match_reference(B, Hq, Hkv, Sq, Sk, D, impl, causal):
    q, k, v = inputs(Sq * 7 + Sk + D, B, Hq, Hkv, Sq, Sk, D)
    ref = np.asarray(ref_mha(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                             impl=impl), np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    most = key_tiles(0, Sq, Sk, causal)
    for n_split in sorted({1, 2, 3, most}):
        m, l, acc = attention_partials_ref(tq, tk, tv, causal=causal, n_split=n_split)
        assert m.shape == l.shape == (n_split, B, Hq, Sq)
        assert acc.shape == (n_split, B, Hq, Sq, D)
        out = merge_partials_ref(m, l, acc)
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_partials_of_a_fully_masked_chunk_vanish_in_the_merge():
    """A causal row whose chunk holds only keys past its last one keeps
    m = -1e30 there (p = 1 on the masked keys, as the TPU kernel's
    first tile would); e^(m - m*) = 0 removes it in the merge."""
    q, k, v = inputs(5, 1, 1, 1, 128, 512, 64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    m, l, acc = attention_partials_ref(tq, tk, tv, causal=True, n_split=8)
    # chunk 7 (keys 448..511) is past the last key of rows below 448 - 384
    assert bool((m[7, 0, 0, :64] == -1e30).all())
    assert bool((l[7, 0, 0, :64] == 64).all())
    ref = np.asarray(ref_mha(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                             impl="ref"), np.float32)
    np.testing.assert_allclose(merge_partials_ref(m, l, acc).numpy(), ref,
                               rtol=2e-5, atol=2e-5)


# ---- the batched frontier kernels' share of the grid ---------------------


def lane_shares(n: torch.Tensor, warps: int):
    """``LaneShares`` of csrc/minplus.cuh for per-lane row counts ``n``
    on a grid of ``warps`` warps, at least one a lane (the grid the C
    entry launches): (V, a, a1), lane s owning warps [a[s], a1[s]).  The
    products and quotient are IEEE doubles, as on the card."""
    assert warps >= n.numel()
    total, lanes = int(n.sum()), int((n > 0).sum())
    if total == 0:
        return 0, None, None
    V = warps
    scale = float(V - lanes) / float(total)
    start = torch.cumsum(n, 0) - n
    live = (n > 0).to(torch.int64)
    lb = torch.cumsum(live, 0) - live
    a = torch.tensor([math.floor(float(x) * scale) for x in start.tolist()]) + lb
    a1 = torch.tensor([math.floor(float(x) * scale)
                       for x in (start + n).tolist()]) + lb + live
    return V, a, a1


def visited_rows(n: torch.Tensor, warps: int, rpw: int) -> list:
    """(lane, f) in the order the warps of a 1-D grid of ``warps`` warps
    (``rpw`` rows a warp) visit them, warp by warp."""
    V, a, a1 = lane_shares(n, warps)
    seen = []
    for vw in range(V):
        hit = torch.nonzero((n > 0) & (a <= vw) & (vw < a1)).flatten().tolist()
        assert len(hit) <= 1, "two lanes claim one warp"
        if not hit:
            continue
        s = hit[0]
        slot, slots = vw - int(a[s]), int(a1[s] - a[s])
        step = slots * rpw
        for base in range(slot * rpw, int(n[s]), step):
            seen += [(s, f) for f in range(base, min(base + rpw, int(n[s])))]
    return seen


def lane_counts(kind: str, S: int, F: int, seed: int) -> torch.Tensor:
    r = np.random.default_rng(seed)
    if kind == "zeros":
        c = np.zeros(S)
    elif kind == "ones":
        c = np.ones(S)
    elif kind == "full":
        c = np.full(S, F)
    elif kind == "skewed":  # one lane near F beside lanes at 0 and 1
        c = np.zeros(S)
        c[r.integers(S)] = F - 1
        c[:S // 2] = np.where(np.arange(S // 2) % 2, 1, 0)
    else:  # a mix, past F and negative too
        c = r.integers(-3, F + 5, S)
    return torch.as_tensor(c, dtype=torch.int64)


@pytest.mark.parametrize("kind", ["zeros", "ones", "full", "skewed", "mix"])
@pytest.mark.parametrize("S", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("warps,rpw", [(1, 1), (7, 2), (64, 2), (8448, 2), (3, 32)])
def test_lane_shares_visit_every_row_once(kind, S, warps, rpw):
    F = 150
    warps = max(warps, S)  # the grid holds a warp at least a lane
    count = lane_counts(kind, S, F, seed=S * 31 + warps)
    live = count.clamp(0, F)
    for n in (live, F - live):  # the walk's rows, and the push gather's tail
        seen = visited_rows(n, warps, rpw)
        want = [(s, f) for s in range(S) for f in range(int(n[s]))]
        assert sorted(seen) == want and len(seen) == len(set(seen))
        V, a, a1 = lane_shares(n, warps)
        if V:
            has_rows = n > 0
            assert bool(((a1 - a)[has_rows] >= 1).all())  # a warp at least
            assert bool(((a1 - a)[~has_rows] == 0).all())  # a lane at 0 takes none
            assert int(a1.max()) <= V


def test_lane_shares_give_a_skewed_lane_most_of_the_grid():
    """The lane near F beside lanes at 0 and 1 takes all warps but a
    few: not 1/S of the grid, as a static split would.  A lane of one
    row takes one or two (the floor of its end may round up a warp)."""
    n = torch.tensor([0, 1, 0, 0, 177_000, 0, 1, 0])
    V, a, a1 = lane_shares(n, 8448)
    assert V == 8448 and int(a1[-1]) == V
    assert int(a1[4] - a[4]) >= 8448 - 4
    assert 1 <= int(a1[1] - a[1]) <= 2 and 1 <= int(a1[6] - a[6]) <= 2
