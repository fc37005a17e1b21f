"""The port's attention op against the JAX package's: on the CPU the
port's ``mha`` runs its plain version, which must agree with the
reference's jnp oracle and with its Pallas kernel in interpret mode
over the cases of the reference's own kernel sweep.  Tolerances are the
reference's: 2e-5 in f32, 2e-2 in bf16 (both sides round the output to
bf16; the sums run in another order).  The CUDA kernel is held against
the same plain version on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import mha as ref_mha
from repro_torch.kernels import flash_attention_cuda, mha
from repro_torch.kernels.flash_attention.kernel import check_attention_args

CASES = [
    (1, 2, 1, 128, 128, 64, "float32"),
    (2, 4, 2, 256, 256, 64, "float32"),
    (1, 8, 2, 128, 256, 128, "float32"),   # cross (kv longer)
    (2, 4, 4, 128, 128, 64, "bfloat16"),   # MHA bf16
    (1, 4, 4, 128, 128, 96, "bfloat16"),   # phi3-mini head dim
]


def inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,dtype", CASES)
def test_mha_plain_matches_reference(impl, causal, B, Hq, Hkv, Sq, Sk, D, dtype):
    q, k, v = inputs(Sq + Sk + D, B, Hq, Hkv, Sq, Sk, D)
    tdt = getattr(torch, dtype)
    port = mha(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert port.dtype == tdt and port.shape == (B, Hq, Sq, D)
    ref = ref_mha(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal, impl=impl)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,causal,match", [
    ((t(1, 2, 128, 80), t(1, 1, 128, 80), t(1, 1, 128, 80)), True, "head dim"),
    ((t(1, 2, 100, 64), t(1, 1, 128, 64), t(1, 1, 128, 64)), False, "multiples of 128"),
    ((t(1, 2, 128, 64), t(1, 1, 192, 64), t(1, 1, 192, 64)), False, "multiples of 128"),
    ((t(1, 2, 256, 64), t(1, 1, 128, 64), t(1, 1, 128, 64)), True, "Sq <= Sk"),
    ((t(1, 3, 128, 64), t(1, 2, 128, 64), t(1, 2, 128, 64)), True, "multiple of Hkv"),
    ((t(1, 2, 128, 64), t(1, 1, 128, 64, dtype=torch.bfloat16),
      t(1, 1, 128, 64)), True, "one dtype"),
    ((t(1, 2, 128, 64, dtype=torch.float16), t(1, 1, 128, 64, dtype=torch.float16),
      t(1, 1, 128, 64, dtype=torch.float16)), True, "one dtype"),
    ((t(2, 128, 64), t(1, 128, 64), t(1, 128, 64)), True, "4-D"),
    ((t(1, 2, 128, 64), t(1, 1, 128, 64), t(1, 1, 256, 64)), True, "k and v"),
])
def test_kernel_contract_raises(args, causal, match):
    with pytest.raises(ValueError, match=match):
        check_attention_args(*args, causal)
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(*args, causal=causal)


def test_kernel_wrapper_refuses_cpu_tensors():
    """A well-formed call on CPU tensors: the wrapper launches or
    raises, it never computes the plain version itself."""
    q, k, v = t(1, 2, 128, 64), t(1, 1, 128, 64), t(1, 1, 128, 64)
    check_attention_args(q, k, v, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k, v, causal=True)
