"""The port's quantized sparse exchange (``/q:bf16``, ``/q:u16``) against
the JAX package: the round-up codes of both encoders bit for bit on
seeded random planes (+inf slots, values equal to the segment's lower
bound, deltas of one ulp), the u16 pair packing, the payload words, and
solves with the exact repair loop, whose state, ``metrics.as_dict()``
and ``repair_sweeps`` are bit-identical to the reference's.

The encoders are held against the reference's as its engine runs them,
under ``jax.jit``.  There XLA compiles ``dmax / 65534`` into a product
with the float32 reciprocal and contracts the u16 decode ``lo + q *
scale`` into a fused multiply-add; op-by-op ``jnp`` does neither, and
its codes differ from the compiled ones in the last ulp of some scales
and in the +inf verdict of some slots.  The port computes what the
compiled reference computes (``core/frontier.py``).

``/fused`` and ``relax_impl="push"`` solves are held against the
reference's plain-relax spec (its own kernels fail inside ``shard_map``
under jax 0.9.0).  At 2 and 4 stacked ranks the port's states are held
against the P=1 reference and Dijkstra.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core.frontier as ref_frontier
import repro.graph as ref_graph
import repro_torch.api as api
import repro_torch.core.frontier as frontier
import repro_torch.graph as tg
from repro_torch.core import dijkstra_reference
from repro_torch.numeric import fma_f32

QUANT = ("bf16", "u16")


@pytest.fixture(scope="module")
def mesh1():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def port_graph(g):
    return tg.Graph(g.n, g.src.copy(), g.dst.copy(), g.weight.copy(),
                    name=g.name)


def real_weights(g, seed=7):
    """``g`` with seeded non-integer weights (bf16 deltas then round)."""
    w = np.random.default_rng(seed).uniform(0.5, 60.0, g.m).astype(np.float32)
    return ref_graph.Graph(g.n, g.src.copy(), g.dst.copy(), w,
                           name=g.name + "+real")


def planes(seed, P=4):
    """Seeded (P, S) value planes with their segments' finite lower
    bounds: random values, +inf slots, slots equal to the lower bound,
    slots one ulp above it, and one all-+inf segment."""
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 300))
    v = rng.uniform(0, 1000, (P, S)).astype(np.float32)
    v[rng.random((P, S)) < 0.2] = np.inf
    lo = v.min(axis=1)
    v = np.where(rng.random((P, S)) < 0.1, lo[:, None], v)
    up = np.nextafter(lo, np.float32(np.inf))[:, None]
    v = np.where((rng.random((P, S)) < 0.1) & np.isfinite(lo)[:, None], up, v)
    v = v.astype(np.float32)
    v[0] = np.inf
    lo = v.min(axis=1)
    return v, np.where(np.isfinite(lo), lo, np.float32(0)).astype(np.float32)


_REF_ENC = {q: jax.jit(getattr(ref_frontier, f"_quantize_{q}")) for q in QUANT}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("payload", QUANT)
def test_codes_equal_the_reference_encoder(payload, seed):
    v, lo = planes(seed)
    ref = _REF_ENC[payload](jnp.asarray(v), jnp.asarray(lo))
    port = getattr(frontier, f"_quantize_{payload}")(
        torch.as_tensor(v), torch.as_tensor(lo))
    if payload == "u16":
        (ref, ref_scale), (port, scale) = ref, port
        assert np.asarray(ref_scale).tobytes() == scale.numpy().tobytes()
    assert port.dtype == torch.int64
    assert np.array_equal(np.asarray(ref).astype(np.int64), port.numpy())


@pytest.mark.parametrize("seed", range(3))
def test_u16_pairs_round_trip_and_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 65))
    q = rng.integers(0, 65536, (3, S)).astype(np.uint32)
    ref = np.asarray(ref_frontier._pack_u16_pairs(jnp.asarray(q), S))
    port = frontier._pack_u16_pairs(torch.as_tensor(q.astype(np.int64)), S)
    assert np.array_equal(ref.astype(np.int64), port.numpy())
    back = frontier._unpack_u16_pairs(port, S)
    assert np.array_equal(back.numpy(), q.astype(np.int64))


def test_fma_rounds_once():
    """``numeric.fma_f32`` (the u16 decode) equals the exactly rounded a·b + c
    near ties, where a product and a sum round differently."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    c = rng.uniform(1, 1000, 2000).astype(np.float32)
    a = rng.integers(1, 65535, 2000).astype(np.float32)
    b = (np.spacing(c) / 2 / a * (1 + rng.uniform(-1e-6, 1e-6, 2000))).astype(
        np.float32)
    got = fma_f32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    differs = 0
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        near = np.float32(float(exact))
        cands = (near, np.nextafter(near, np.float32(np.inf)),
                 np.nextafter(near, np.float32(-np.inf)))
        want = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                         int(np.float32(x).view(np.uint32)) & 1))
        assert gi == want
        differs += want != np.float32(np.float32(ai * bi) + ci)
    assert differs > 0  # the cases where two roundings differ are in the sample


@pytest.mark.parametrize("payload", QUANT)
@pytest.mark.parametrize("level", [False, True])
def test_payload_and_combine_equal_the_reference(payload, level):
    """One rank's payload words and the owner-side combine, at 2 ranks."""
    rng = np.random.default_rng(11)
    n_local, P, S = 40, 2, 12
    C = rng.uniform(0, 100, P * n_local).astype(np.float32)
    C[rng.random(P * n_local) < 0.6] = np.inf
    CL = rng.integers(0, 5, P * n_local).astype(np.float32)
    ref_pay, ref_over = jax.jit(
        lambda c, cl: ref_frontier.sparse_payload(
            c, [(cl, np.inf)] if level else [], P, S, np.inf, payload=payload)
    )(jnp.asarray(C), jnp.asarray(CL))
    pay, over = frontier.sparse_payload(
        torch.as_tensor(C)[None],
        [(torch.as_tensor(CL)[None], np.inf)] if level else [], P, S,
        float("inf"), payload)
    assert bool(ref_over) == bool(over[0])
    assert np.array_equal(np.asarray(ref_pay).view(np.int32), pay[0].numpy())
    ref_mine, ref_l = jax.jit(
        lambda r: ref_frontier.unpack_combine(r, n_local, S, True, np.inf,
                                              level, payload=payload)
    )(ref_pay)
    mine, mine_l = frontier.unpack_combine(pay, n_local, S, True, float("inf"),
                                           level, payload)
    assert np.asarray(ref_mine).tobytes() == mine[0].numpy().tobytes()
    if level:
        assert np.asarray(ref_l).tobytes() == mine_l[0].numpy().tobytes()
    else:
        assert mine_l is None and ref_l is None


def solve_both(mesh, g, spec, **kw):
    rcfg = ref_api.SolverConfig.from_spec(spec, chunk_size=64, **kw)
    pcfg = api.SolverConfig.from_spec(spec, chunk_size=64, **kw)
    ref = ref_api.Solver(rcfg, mesh=mesh).solve(
        ref_api.Problem(g, ref_api.SingleSource(0)))
    port = api.Solver(pcfg, device="cpu").solve(
        api.Problem(port_graph(g), api.SingleSource(0)))
    return ref, port


def same(ref, port):
    assert port.state.tobytes() == ref.state.tobytes()
    assert port.metrics.as_dict() == ref.metrics.as_dict()


@pytest.mark.parametrize("exchange", ["sparse", "auto"])
@pytest.mark.parametrize("payload", QUANT)
@pytest.mark.parametrize("gi", range(4))
def test_quantized_solve_equals_reference(mesh1, tiny_graphs, gi, payload,
                                          exchange):
    ref, port = solve_both(mesh1, tiny_graphs[gi],
                           f"delta:5/{exchange}/q:{payload}")
    same(ref, port)
    assert port.metrics.converged
    assert np.array_equal(port.state, dijkstra_reference(
        port_graph(tiny_graphs[gi]), 0))


@pytest.mark.parametrize("payload", QUANT)
def test_quantized_repair_runs_on_real_weights(mesh1, tiny_graphs, payload):
    """Non-integer weights: the round-up codes inflate, the repair loop
    restarts, and both packages count the same sweeps."""
    ref, port = solve_both(mesh1, real_weights(tiny_graphs[0]),
                           f"delta:5/sparse/q:{payload}", frontier_cap=16)
    same(ref, port)
    assert port.metrics.repair_sweeps == ref.metrics.repair_sweeps > 0


@pytest.mark.parametrize("impl", ["fused", "push"])
def test_quantized_kernel_routes_equal_reference(mesh1, tiny_graphs, impl):
    g = tiny_graphs[1]
    ref = ref_api.Solver(ref_api.SolverConfig.from_spec(
        "delta:5/sparse/q:u16", chunk_size=64), mesh=mesh1).solve(
            ref_api.Problem(g, ref_api.SingleSource(0)))
    port = api.Solver(api.SolverConfig.from_spec(
        "delta:5/sparse/q:u16", chunk_size=64, relax_impl=impl),
        device="cpu").solve(api.Problem(port_graph(g), api.SingleSource(0)))
    same(ref, port)


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("payload", QUANT)
def test_quantized_stacked_ranks_reach_the_fixpoint(mesh1, tiny_graphs,
                                                    n_parts, payload):
    g = tiny_graphs[0]
    ref = ref_api.Solver(f"delta:5/sparse/q:{payload}", mesh=mesh1).solve(
        ref_api.Problem(g, ref_api.SingleSource(0)))
    port = api.Solver(f"delta:5/sparse/q:{payload}", n_parts=n_parts,
                      device="cpu").solve(
        api.Problem(port_graph(g), api.SingleSource(0)))
    assert port.metrics.converged
    assert port.state.tobytes() == ref.state.tobytes()
    assert np.array_equal(port.state, dijkstra_reference(port_graph(g), 0))


def test_quantized_resolve_equals_reference(mesh1, tiny_graphs):
    g = tiny_graphs[0]
    spec = "delta:5/sparse/q:u16"
    rs = ref_api.Solver(spec, mesh=mesh1)
    ps = api.Solver(spec, device="cpu")
    pg_ = port_graph(g)
    ref0 = rs.solve(ref_api.Problem(g, ref_api.SingleSource(0)))
    port0 = ps.solve(api.Problem(pg_, api.SingleSource(0)))
    ref = rs.resolve(ref0, new_sources=[17])
    port = ps.resolve(port0, new_sources=[17])
    same(ref, port)


def test_solve_batch_refuses_quantized_specs():
    g = tg.rmat1(6, seed=0)
    with pytest.raises(ValueError, match="quantized"):
        api.Solver("delta:5/sparse/q:u16", device="cpu").solve_batch(
            [api.Problem(g, api.SingleSource(v)) for v in (0, 1)])
