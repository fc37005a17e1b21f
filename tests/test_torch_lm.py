"""The port's LM serving path against the JAX package's, at the reduced
configs of minitron (GQA, squared-ReLU MLP) and phi3-mini (MHA,
SwiGLU): the reference's random weights go through ``convert.py``, the
prompt comes from ``lm_batch``, and prefill logits, the KV cache and 6
greedy decode steps must agree.  In f32 the tolerance is rtol 1e-4 /
atol 1e-5 (the sums run in another order on each side).  In bf16 the
largest difference must stay within 2e-2 of the largest magnitude (the
reference's own bf16 attention tolerance, taken against the tensor's
scale): XLA keeps excess f32 precision inside the fused layers of its
scan where torch rounds every op to bf16, so single elements differ by
one or two bf16 ulps (2^-8 relative each) from the second layer on.
The reference's ``forward`` fails under this jax, so the teacher-forced
check uses the port's own ``forward``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import minicpm3 as ref_minicpm3
from repro.configs import minitron as ref_minitron
from repro.configs import phi3_mini as ref_phi3
from repro.models import lm as ref_lm
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.models import lm
from repro_torch.models.common import param_count
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.moe import MoEConfig

ARCHS = {"minitron-8b": ref_minitron, "phi3-mini-3.8b": ref_phi3}
PROMPT, MAX_LEN, STEPS = 128, 136, 6
F32_TOL = dict(rtol=1e-4, atol=1e-5)


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


def close_to_scale(port, ref, tol=2e-2):
    a, b = port.float().numpy(), np.asarray(ref, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla_flash"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_greedy_decode_match_reference(arch, impl, topo1):
    # attn_chunk 64 < the 128-token prompt, so xla_flash runs its
    # blockwise loop over two chunks on both sides
    ref_cfg, cfg = configs(arch, attn_impl=impl, attn_chunk=64)
    tree, model = weights(ref_cfg, cfg)
    toks = prompt(cfg.vocab)

    ref_cache, ref_logits = ref_lm.prefill_step(tree, jnp.asarray(toks), ref_cfg,
                                                topo1, max_len=MAX_LEN)
    cache, logits = lm.prefill_step(model, torch.from_numpy(toks), cfg, MAX_LEN)
    close(logits, ref_logits, **F32_TOL)
    for name in ("k", "v"):
        assert cache[name].shape == ref_cache[name].shape
        close(cache[name], ref_cache[name], **F32_TOL)

    for step in range(STEPS):
        nxt = logits.argmax(-1)
        ref_nxt = np.asarray(jnp.argmax(ref_logits, axis=-1))
        assert np.array_equal(nxt.numpy(), ref_nxt), step
        pos = PROMPT + step
        ref_logits, ref_cache = ref_lm.decode_step(
            tree, ref_cache, jnp.asarray(ref_nxt, jnp.int32), pos, ref_cfg, topo1)
        logits, cache = lm.decode_step(model, cache, nxt.to(torch.int32), pos, cfg)
        close(logits, ref_logits, **F32_TOL)
    close(cache["k"], ref_cache["k"], **F32_TOL)


def test_bf16_prefill_and_decode_match_reference(topo1):
    ref_cfg, cfg = configs("minitron-8b", param_dtype="bfloat16",
                           attn_impl="pallas_interpret")
    tree, model = weights(ref_cfg, cfg)
    assert model.embed.dtype == torch.bfloat16
    toks = prompt(cfg.vocab)
    ref_cache, ref_logits = ref_lm.prefill_step(tree, jnp.asarray(toks), ref_cfg,
                                                topo1, max_len=MAX_LEN)
    cache, logits = lm.prefill_step(model, torch.from_numpy(toks), cfg, MAX_LEN)
    assert logits.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
    close_to_scale(logits, ref_logits)
    close_to_scale(cache["k"], ref_cache["k"])
    close_to_scale(cache["v"], ref_cache["v"])
    # both sides decode the reference's greedy tokens (a near tie may
    # round to another argmax in bf16)
    for step in range(STEPS):
        nxt = np.asarray(jnp.argmax(ref_logits, axis=-1), np.int32)
        ref_logits, ref_cache = ref_lm.decode_step(
            tree, ref_cache, jnp.asarray(nxt), PROMPT + step, ref_cfg, topo1)
        logits, cache = lm.decode_step(model, cache, torch.tensor(nxt),
                                       PROMPT + step, cfg)
        close_to_scale(logits, ref_logits)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_greedy_decode_matches_teacher_forced_forward(arch):
    """Every decode step's logits equal the port's teacher-forced
    forward over the grown sequence (the reference test's tolerance)."""
    ref_cfg, cfg = configs(arch, attn_impl="pallas")
    _, model = weights(ref_cfg, cfg)
    seq = torch.from_numpy(prompt(cfg.vocab))
    cache, logits = lm.prefill_step(model, seq, cfg, MAX_LEN)
    head = lm.lm_head_weight(model, cfg)
    for step in range(STEPS):
        nxt = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = lm.decode_step(model, cache, nxt, PROMPT + step, cfg)
        ref = (lm.forward(model, seq, cfg)[:, -1] @ head).float()
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=2e-3, atol=5e-4)


def test_attention_xla_flash_raises_on_a_partial_chunk():
    """The reference's blockwise attention drops the keys past the last
    whole chunk (T=12, chunk=8 differs from full attention on rows >= 8);
    the port raises instead."""
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.normal(size=(1, 12, 4, 16)).astype(np.float32))
               for _ in range(3))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        lm.attention_xla_flash(q, k, v, causal=True, scale=0.25, chunk=8)
    cfg = dataclasses.replace(get_arch("minitron-8b").make_config(True),
                              attn_impl="xla_flash", attn_chunk=8)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        lm.run_attention(q, k, v, cfg)
    # whole chunks: the same as full-score attention
    k16, v16 = (torch.cat([x, x[:, :4]], dim=1) for x in (k, v))
    q16 = torch.cat([q, q[:, :4]], dim=1)
    np.testing.assert_allclose(
        lm.attention_xla_flash(q16, k16, v16, causal=True, scale=0.25, chunk=8).numpy(),
        lm.attention_xla(q16, k16, v16, causal=True, scale=0.25).numpy(),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("over,error", [
    (dict(attn_type="linear"), ValueError),
    # a MoE whose width is not the model's
    (dict(moe=MoEConfig(n_experts=4, top_k=2, d_model=32, d_ff=96)), ValueError),
    (dict(attn_impl="cudnn"), ValueError),
    (dict(mlp_type="gelu"), ValueError),
])
def test_config_rejects_what_is_not_ported(over, error):
    """An attention type, MoE width, attention route or MLP the JAX
    package does not have."""
    with pytest.raises(error):
        dataclasses.replace(get_arch("minitron-8b").make_config(True), **over)


def test_registry_and_full_configs():
    full = get_arch("minitron-8b").make_config()
    assert full.attn_impl == "pallas" and full.head_dim == 128
    meta = lm.LM(full, torch.empty((full.vocab, full.d_model), device="meta"),
                 [{n: torch.empty(s, device="meta") for n, (s, _) in lm.layer_shapes(full).items()}
                  for _ in range(full.n_layers)],
                 torch.empty((full.d_model,), device="meta"),
                 torch.empty((full.d_model, full.vocab), device="meta"))
    norms = (2 * full.n_layers + 1) * full.d_model
    assert param_count(meta) == 7_734_562_816
    assert param_count(meta) - norms == ref_minitron.make_config().n_params()
    assert get_arch("phi3-mini-3.8b").make_config().head_dim == 96
    assert get_arch("mind").make_config().bag_impl == "pallas"
    mla = get_arch("minicpm3-4b").make_config()
    assert (mla.attn_type, mla.tie_embeddings, mla.attn_impl, mla.attn_chunk) == \
        ("mla", True, "xla_flash", 8192)
    assert mla.n_params() == ref_minicpm3.make_config().n_params()
    with pytest.raises(KeyError, match="not yet ported"):
        get_arch("no-such-arch")
