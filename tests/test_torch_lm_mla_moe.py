"""The port's MLA and MoE serving against the JAX package's, at the
reduced configs of minicpm3 (MLA, tied embeddings), phi3.5-moe (GQA,
16 → 4 experts top-2) and dbrx (4 experts top-4): the reference's random
weights go through ``convert.py``, the prompt comes from ``lm_batch``.

- Prefill logits, the cache and 6 greedy decode steps in f32 at
  ``test_torch_lm.py``'s tolerance (rtol 1e-4, atol 1e-5), both
  attention routes.  MLA's q/k head dim differs from its v head dim, so
  its ``pallas*`` route takes the blockwise path on both sides.
- minicpm3 in bf16 within 2e-2 of the largest magnitude (as
  ``test_torch_lm.py``).  MoE is held in bf16 on ``moe_ffn`` alone, with
  identical inputs: a bf16 ulp of difference in a whole model's layer
  input can flip a token's route, and the token's output with it.
- ``moe_ffn`` alone against the reference's, jitted, on one device: the
  output, the aux loss, and the top-k experts and kept pairs against the
  reference's routing steps; at the reduced capacity, at one that drops
  pairs, and with two equal router columns (exact ties in the
  probabilities, which ``jax.lax.top_k`` breaks to the lower index).

The reference's LM runs on a one-device mesh whose axis is Auto: on
``single_device_topology()``'s Explicit axis its ``forward`` fails under
this jax (ROADMAP.md, Queue 3).  Every reference call is jitted.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import dbrx as ref_dbrx
from repro.configs import minicpm3 as ref_minicpm3
from repro.configs import phi35_moe as ref_phi35_moe
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.common import Topology
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.models import lm, moe
from repro_torch.models.common import param_count
from repro_torch.models.convert import lm_params_from_numpy

ARCHS = {"minicpm3-4b": ref_minicpm3, "phi3.5-moe-42b-a6.6b": ref_phi35_moe,
         "dbrx-132b": ref_dbrx}
PROMPT, MAX_LEN, STEPS = 128, 136, 6
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_SCALE_TOL = 2e-2


@functools.cache
def auto_topology() -> Topology:
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    return Topology(mesh=mesh, dp_axes=("data",), tp_axis=None)


@functools.cache
def ref_steps(ref_cfg):
    """The reference's prefill (at MAX_LEN) and decode step, jitted
    once a config."""
    topo = auto_topology()
    prefill = jax.jit(lambda p, t: ref_lm.prefill_step(p, t, ref_cfg, topo, max_len=MAX_LEN))
    decode = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, c, t, pos, ref_cfg, topo))
    return prefill, decode


def configs(arch, **over):
    ref = dataclasses.replace(ARCHS[arch].make_config(reduced=True), **over)
    port = dataclasses.replace(get_arch(arch).make_config(reduced=True), **over)
    return ref, port


def weights(ref_cfg, port_cfg):
    tree = ref_lm.init_params(jax.random.PRNGKey(7), ref_cfg)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return tree, lm_params_from_numpy(tree, port_cfg, device="cpu")


def prompt(vocab):
    return lm_batch(step=0, batch=2, seq=PROMPT, vocab=vocab, seed=3)["tokens"]


def close(port, ref, **tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **tol)


def close_to_scale(port, ref, tol=BF16_SCALE_TOL):
    a, b = port.float().numpy(), np.asarray(ref, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla_flash"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_greedy_decode_match_reference(arch, impl):
    # attn_chunk 64 < the 128-token prompt: the blockwise loop runs over
    # two chunks on both sides
    ref_cfg, cfg = configs(arch, attn_impl=impl, attn_chunk=64)
    tree, model = weights(ref_cfg, cfg)
    prefill, decode = ref_steps(ref_cfg)
    toks = prompt(cfg.vocab)

    ref_cache, ref_logits = prefill(tree, jnp.asarray(toks))
    cache, logits = lm.prefill_step(model, torch.from_numpy(toks), cfg, MAX_LEN)
    assert sorted(cache) == sorted(ref_cache)
    assert sorted(cache) == (["c", "kr"] if cfg.attn_type == "mla" else ["k", "v"])
    close(logits, ref_logits, **F32_TOL)
    for name in cache:
        assert tuple(cache[name].shape) == ref_cache[name].shape
        close(cache[name], ref_cache[name], **F32_TOL)

    for step in range(STEPS):
        nxt = logits.argmax(-1)
        ref_nxt = np.asarray(jnp.argmax(ref_logits, axis=-1))
        assert np.array_equal(nxt.numpy(), ref_nxt), step
        pos = PROMPT + step
        ref_logits, ref_cache = decode(tree, ref_cache, jnp.asarray(ref_nxt, jnp.int32), pos)
        logits, cache = lm.decode_step(model, cache, nxt.to(torch.int32), pos, cfg)
        close(logits, ref_logits, **F32_TOL)
    for name in cache:
        close(cache[name], ref_cache[name], **F32_TOL)


def test_mla_bf16_prefill_and_decode_match_reference():
    ref_cfg, cfg = configs("minicpm3-4b", param_dtype="bfloat16", attn_impl="xla_flash",
                           attn_chunk=64)
    tree, model = weights(ref_cfg, cfg)
    assert model.embed.dtype == torch.bfloat16 and model.lm_head is None
    prefill, decode = ref_steps(ref_cfg)
    toks = prompt(cfg.vocab)
    ref_cache, ref_logits = prefill(tree, jnp.asarray(toks))
    cache, logits = lm.prefill_step(model, torch.from_numpy(toks), cfg, MAX_LEN)
    assert logits.dtype == torch.float32 and cache["c"].dtype == torch.bfloat16
    close_to_scale(logits, ref_logits)
    close_to_scale(cache["c"], ref_cache["c"])
    close_to_scale(cache["kr"], ref_cache["kr"])
    # both sides decode the reference's greedy tokens (a near tie may
    # round to another argmax in bf16)
    for step in range(STEPS):
        nxt = np.asarray(jnp.argmax(ref_logits, axis=-1), np.int32)
        ref_logits, ref_cache = decode(tree, ref_cache, jnp.asarray(nxt), PROMPT + step)
        logits, cache = lm.decode_step(model, cache, torch.tensor(nxt), PROMPT + step, cfg)
        close_to_scale(logits, ref_logits)


# ----------------------------------------------------------------- #
# moe_ffn alone

MOE_B, MOE_S = 2, 32
MOE_CASES = {
    # the reduced phi3.5-moe MoE: C = max(16, 2.0 * 64 * 2 / 4) = 64, no drop
    "reduced": dict(),
    # C = max(1, int(0.5 * 64 * 2 / 4)) = 16: about half the pairs drop
    "drops": dict(capacity_factor=0.5, min_capacity=1),
    # router columns 0 and 1 equal: exact ties between experts 0 and 1
    "ties": dict(),
}


def moe_inputs(case, dtype):
    cfg = get_arch("phi3.5-moe-42b-a6.6b").make_config(reduced=True).moe
    cfg = dataclasses.replace(cfg, **MOE_CASES[case])
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    r = np.random.default_rng(11)
    arrays = [r.normal(size=(MOE_B, MOE_S, d)), r.normal(size=(d, E)) / np.sqrt(d),
              r.normal(size=(E, d, f)) / np.sqrt(d), r.normal(size=(E, d, f)) / np.sqrt(d),
              r.normal(size=(E, f, d)) / np.sqrt(f)]
    if case == "ties":
        arrays[1][:, 1] = arrays[1][:, 0]
    # the same values on both sides: rounded once, by numpy's bf16
    np_dtype = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    arrays = [a.astype(np.float32).astype(np_dtype) for a in arrays]
    tensors = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype)) for a in arrays]
    return cfg, arrays, tensors


def ref_routing(x, router_w, cfg, C):
    """The routing steps of ``repro/models/moe.py::_moe_local`` on one
    device (its lines, which return nothing of them): top-k experts and
    the kept mask, in the (token, choice) layout."""
    N = x.shape[0]
    k = cfg.top_k
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router_w.astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jax.ops.segment_sum(jnp.ones_like(se), se, num_segments=cfg.n_experts)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]])
    rank = jnp.zeros((N * k,), jnp.int32).at[order].set(
        jnp.arange(N * k, dtype=jnp.int32) - starts[se])
    return idx, (rank < C).reshape(N, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case, dtype, topo1):
    cfg, arrays, tensors = moe_inputs(case, dtype)
    N = MOE_B * MOE_S
    C = moe.capacity(cfg, N)
    ref_out, ref_aux = jax.jit(lambda *a: ref_moe.moe_ffn(*a, cfg, topo1))(
        *(jnp.asarray(a) for a in arrays))
    out, aux = moe.moe_ffn(*tensors, cfg)
    assert out.dtype == tensors[0].dtype and out.shape == tensors[0].shape
    assert aux.dtype == torch.float32

    x2 = tensors[0].reshape(N, -1)
    r = moe.route(x2, tensors[1], cfg, C)
    ref_idx, ref_keep = jax.jit(ref_routing, static_argnums=(2, 3))(
        jnp.asarray(arrays[0]).reshape(N, -1), jnp.asarray(arrays[1]), cfg, C)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(ref_keep))
    if case == "drops":
        assert C == 16 and r.dropped > 0
    else:
        assert r.dropped == 0
    if case == "ties":
        # the tie is exact in the port, and top-k breaks it to expert 0
        assert torch.equal(r.probs[:, 0], r.probs[:, 1])
        both = (r.idx == 0).any(-1) & (r.idx == 1).any(-1)
        assert bool(both.any())
        first = r.idx[both].tolist()
        assert all(row.index(0) < row.index(1) for row in first)

    if dtype == "float32":
        close(out, ref_out, **F32_TOL)
    else:
        close_to_scale(out, ref_out)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)


def test_moe_route_ties_go_to_the_lower_expert():
    """``torch.topk`` may return a higher index among equal values; the
    route takes them in index order, as ``jax.lax.top_k`` does."""
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_model=4, d_ff=8)
    logits = torch.log(torch.tensor([[0.5, 0.5, 0.2, 0.5], [0.1, 0.3, 0.3, 0.3]]))
    # x @ I = logits: the router sees these logits
    r = moe.route(logits, torch.eye(4), cfg, C=8)
    assert r.idx.tolist() == [[0, 1], [1, 2]]
    assert np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1), 2)[1]
                      ).tolist() == r.idx.tolist()


# ----------------------------------------------------------------- #
# the port against itself; parameter counts


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_greedy_decode_matches_teacher_forced_forward(arch):
    """Every decode step's logits equal the port's teacher-forced forward
    over the grown sequence (the reference test's tolerance).  The
    reduced MoE configs never drop a pair here (C >= every expert's
    pairs, counted by the route), so decode and the teacher-forced
    prefill route alike."""
    ref_cfg, cfg = configs(arch, attn_impl="pallas")
    _, model = weights(ref_cfg, cfg)
    seq = torch.from_numpy(prompt(cfg.vocab))
    cache, logits = lm.prefill_step(model, seq, cfg, MAX_LEN)
    head = lm.lm_head_weight(model, cfg)
    if cfg.moe:
        n = seq.numel() + STEPS * seq.shape[0]
        assert moe.capacity(cfg.moe, n) >= n  # an expert takes a token at most once
    for step in range(STEPS):
        nxt = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = lm.decode_step(model, cache, nxt, PROMPT + step, cfg)
        ref = (lm.forward(model, seq, cfg)[:, -1] @ head).float()
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=2e-3, atol=5e-4)


def meta_model(cfg):
    layers = [{n: torch.empty(s, device="meta") for n, (s, _) in lm.layer_shapes(cfg).items()}
              for _ in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else torch.empty((cfg.d_model, cfg.vocab), device="meta")
    return lm.LM(cfg, torch.empty((cfg.vocab, cfg.d_model), device="meta"), layers,
                 torch.empty((cfg.d_model,), device="meta"), head)


@pytest.mark.parametrize("arch,params", [("minicpm3-4b", 4_073_937_408),
                                         ("phi3.5-moe-42b-a6.6b", 41_872_527_360),
                                         ("dbrx-132b", 131_596_523_520)])
def test_full_config_parameter_counts(arch, params):
    """The full configs on the meta device: the reference's ``n_params()``
    plus the norm scales (ln1, ln2 a layer, MLA's q_norm and kv_norm, the
    final norm); a tied embedding is counted once."""
    cfg, ref = get_arch(arch).make_config(), ARCHS[arch].make_config()
    assert cfg.n_params() == ref.n_params()
    assert cfg.n_active_params() == ref.n_active_params()
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    if cfg.attn_type == "mla":
        norms += cfg.n_layers * (cfg.q_lora_rank + cfg.kv_lora_rank)
    model = meta_model(cfg)
    assert (model.lm_head is None) == cfg.tie_embeddings
    assert param_count(model) == ref.n_params() + norms == params
