"""Int8 gradient compression with error feedback.

Wired into the train step as the microbatch gradient accumulator: it
is kept in int8 + a per-tensor scale with an f32 error-feedback
buffer, cutting accumulator memory bandwidth ~4x for long accumulation
chains.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so
the codes equal the JAX package's.

The JAX package's ``compressed_psum`` (an error-feedback int8 reduce
across data-parallel devices) waits for the port's data-parallel
training (ROADMAP.md Queue 1 item 5.6).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


def quantize_int8(x, scale=None):
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    x32 = x.to(torch.float32)
    if scale is None:
        scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grad, error):
    """Error-feedback compression of one tensor.
    Returns (q, scale, new_error)."""
    corrected = grad.to(torch.float32) + error
    q, scale = quantize_int8(corrected)
    new_error = corrected - dequantize_int8(q, scale)
    return q, scale, new_error


def ef_compress_tree(grads, errors):
    """Tree error-feedback compression.
    Returns (quantized dict {q, scale}, new errors)."""
    leaves, spec = tree_flatten(grads)
    err_leaves, err_spec = tree_flatten(errors)
    if err_spec != spec:
        raise ValueError(f"error tree {err_spec} differs from the grads' {spec}")
    out = [ef_compress(g, e) for g, e in zip(leaves, err_leaves)]
    return (
        {"q": tree_unflatten([o[0] for o in out], spec),
         "scale": tree_unflatten([o[1] for o in out], spec)},
        tree_unflatten([o[2] for o in out], spec),
    )


def dequantize_tree(comp):
    return tree_map(dequantize_int8, comp["q"], comp["scale"])


def init_error_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
