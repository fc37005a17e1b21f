"""The port's graph layer against the JAX package's: generators,
partitions and the transpose ELL must be byte-identical, so both
packages solve the same arrays."""

import numpy as np
import pytest

import repro.graph as ref_graph
import repro_torch.graph as tg
from repro.core import selfstab as ref_selfstab
from repro_torch.core import selfstab as port_selfstab

GRAPHS = [
    ("rmat1", dict(scale=8, seed=3)),
    ("rmat2", dict(scale=8, seed=5)),
    ("grid_road_graph", dict(side=12, seed=1)),
    ("small_world_graph", dict(n=300, seed=2)),
    ("rmat1", dict(scale=10, seed=0, edge_factor=8)),
]


def _pair(kind, kw):
    return getattr(ref_graph, kind)(**kw), getattr(tg, kind)(**kw)


def _same_arrays(a, b):
    return (
        a.dtype == b.dtype and a.shape == b.shape
        and a.tobytes() == b.tobytes()
    )


@pytest.mark.parametrize("kind,kw", GRAPHS)
def test_generators_byte_identical(kind, kw):
    ref, port = _pair(kind, kw)
    assert (port.n, port.m, port.name) == (ref.n, ref.m, ref.name)
    for f in ("src", "dst", "weight"):
        assert _same_arrays(getattr(ref, f), getattr(port, f)), f
    assert tg.graph_fingerprint(port) == ref_graph.graph_fingerprint(ref)


@pytest.mark.parametrize("weights", ["float", "nan"])
def test_deduplicated_byte_identical(weights):
    """The port's one-sort deduplication against the reference's two-key
    sort, on weights the generators never draw: fractional ones with
    ties, and NaNs (a pair's minimum skips them unless it has nothing
    else), beside self loops and pairs repeated many times."""
    rng = np.random.default_rng(7)
    n, m = 50, 4000
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.choice(rng.normal(size=300).astype(np.float32), m)
    if weights == "nan":
        w[rng.random(m) < 0.3] = np.nan
        w[(src == 3) & (dst == 4)] = np.nan
        src, dst = np.append(src, 3).astype(np.int32), np.append(dst, 4).astype(np.int32)
        w = np.append(w, np.float32(np.nan))
    ref = ref_graph.Graph(n, src, dst, w, name="g").deduplicated()
    port = tg.Graph(n, src, dst, w, name="g").deduplicated()
    assert port.m == ref.m < m
    for f in ("src", "dst", "weight"):
        assert _same_arrays(getattr(ref, f), getattr(port, f)), f


@pytest.mark.parametrize("partitioner", ["block", "shuffle:7", "ebal", "degree"])
@pytest.mark.parametrize("n_parts", [1, 2, 4])
@pytest.mark.parametrize("kind,kw", GRAPHS[:4])
def test_partition_byte_identical(kind, kw, n_parts, partitioner):
    ref_g, port_g = _pair(kind, kw)
    ref = ref_graph.partition_graph(ref_g, n_parts, partitioner=partitioner)
    port = tg.partition_graph(port_g, n_parts, partitioner=partitioner)
    for f in ("n", "m", "n_parts", "n_local", "width", "partitioner", "name"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("row_src", "col", "wgt"):
        assert _same_arrays(getattr(ref, f), getattr(port, f)), f
    assert (port.perm is None) == (ref.perm is None)
    if ref.perm is not None:
        assert _same_arrays(ref.perm, port.perm)
    state = np.arange(ref.n_pad, dtype=np.float32)
    assert np.array_equal(port.unpermute(state), ref.unpermute(state))


def test_from_arrays_carries_a_reference_partition():
    ref_g, port_g = _pair(*GRAPHS[0])
    ref = ref_graph.partition_graph(ref_g, 2, partitioner="shuffle:3")
    port = tg.from_arrays(
        n=ref.n, m=ref.m, n_parts=ref.n_parts, n_local=ref.n_local,
        width=ref.width, row_src=ref.row_src, col=ref.col, wgt=ref.wgt,
        perm=ref.perm, partitioner=ref.partitioner, name=ref.name,
    )
    own = tg.partition_graph(port_g, 2, partitioner="shuffle:3")
    for f in ("row_src", "col", "wgt", "perm"):
        assert _same_arrays(getattr(own, f), getattr(port, f)), f
    assert port.owner_slot(17) == ref.owner_slot(17)
    with pytest.raises(ValueError, match="col/wgt"):
        tg.from_arrays(
            n=ref.n, m=ref.m, n_parts=ref.n_parts, n_local=ref.n_local,
            width=ref.width + 1, row_src=ref.row_src, col=ref.col,
            wgt=ref.wgt,
        )


def test_partition_to_device_copies_once():
    pg = tg.partition_graph(tg.rmat1(8, seed=3), 2)
    a = pg.to("cpu")
    assert pg.to("cpu") is a
    assert np.array_equal(a.col.numpy(), pg.col)
    assert np.array_equal(a.row_deg.numpy(), (pg.wgt < np.inf).sum(axis=2))


@pytest.mark.parametrize("kind,kw", GRAPHS[:4])
def test_in_ell_byte_identical(kind, kw):
    ref_g, port_g = _pair(kind, kw)
    ref = ref_selfstab.in_ell(ref_g, cache=False)
    port = port_selfstab.in_ell(port_g, cache=False)
    for a, b in zip(ref, port):
        assert _same_arrays(a, b)


def test_partitioner_grammar_matches():
    for spec in ("block", " Shuffle ", "shuffle:3", "ebal", "degree"):
        assert tg.canonical_partitioner(spec) == \
            ref_graph.canonical_partitioner(spec)
    for bad in ("", "blok", "shuffle:x", "shuffle:-1", "ebal:2"):
        with pytest.raises(ValueError):
            tg.canonical_partitioner(bad)
