"""Int8 gradient compression with error feedback.

Two uses, as in the JAX package:

1. The train step's microbatch gradient accumulator: kept in int8 + a
   per-tensor scale with an f32 error-feedback buffer, cutting
   accumulator memory bandwidth ~4x for long accumulation chains.
   Across ranks a leaf's scale is the whole leaf's (its max |value| over
   the ranks that hold its blocks), as under the JAX package's GSPMD.
2. :func:`compressed_psum`: an error-feedback int8 sum over a group of
   ranks (``dp`` by default): each rank quantizes its contribution, the
   codes are summed in int32 and dequantized with the group's mean
   scale, and the quantization residual goes to the error tree.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
equal the JAX package's.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.models.common import sharded
from repro_torch.numeric import fma_f32


def quantize_int8(x, scale=None):
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    x32 = x.to(torch.float32)
    if scale is None:
        scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8_jit(x):
    """:func:`quantize_int8` as the JAX package's jitted programs compute
    it (``compressed_psum`` runs only there, inside ``shard_map``): XLA
    rewrites the scale's division by 127 into a product with the f32
    reciprocal.  Returns (q, scale)."""
    x32 = x.to(torch.float32)
    recip = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x32.device)
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) * recip
    return quantize_int8(x32, scale)


def dequantize_int8(q, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grad, error, scale=None):
    """Error-feedback compression of one tensor (at ``scale``, else its
    own).  Returns (q, scale, new_error)."""
    corrected = grad.to(torch.float32) + error
    q, scale = quantize_int8(corrected, scale)
    new_error = corrected - dequantize_int8(q, scale)
    return q, scale, new_error


def ef_compress_tree(grads, errors, topo=None):
    """Tree error-feedback compression.  Across ranks (``topo`` of more
    than one rank; each leaf this rank's block of it or a replica) a
    leaf's scale is the whole leaf's: the max |value| over every rank
    (replicas agree), one all_reduce for the tree.
    Returns (quantized dict {q, scale}, new errors)."""
    leaves, spec = tree_flatten(grads)
    err_leaves, err_spec = tree_flatten(errors)
    if err_spec != spec:
        raise ValueError(f"error tree {err_spec} differs from the grads' {spec}")
    scales = [None] * len(leaves)
    if sharded(topo) is not None and leaves:
        amax = torch.stack([torch.max(torch.abs(g.to(torch.float32) + e))
                            for g, e in zip(leaves, err_leaves)])
        amax = topo.all_reduce(amax, "world", op="max")
        scales = list((torch.clamp(amax, min=1e-12) / 127.0).unbind(0))
    out = [ef_compress(g, e, s) for g, e, s in zip(leaves, err_leaves, scales)]
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


def compressed_psum(grads, errors, topo, scope: str = "dp"):
    """Error-feedback int8 sum over the ``scope`` group of ``topo`` (the
    JAX package's ``compressed_psum`` over a ``shard_map`` axis): each
    rank quantizes its contribution plus its error, the int8 codes are
    summed in int32, then dequantized with the group's mean scale; the
    residual goes to the error tree.  The arithmetic is the reference's
    as XLA compiles it (:func:`quantize_int8_jit`, and the residual's
    product and difference as one fused multiply-add), so the codes, the
    scales and the errors are the reference's bit for bit.  Returns (the
    sums, new errors)."""
    size = topo.dp_size if scope == "dp" else topo.tp_size if scope == "tp" else topo.n_devices

    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, scale = quantize_int8_jit(corrected)
        total = topo.all_reduce(q.to(torch.int32), scope)
        scale_mean = topo.all_reduce(scale, scope) / size
        reduced = total.to(torch.float32) * scale_mean
        return reduced, fma_f32(-q.to(torch.float32), scale, corrected)

    leaves, spec = tree_flatten(grads)
    err_leaves, err_spec = tree_flatten(errors)
    if err_spec != spec:
        raise ValueError(f"error tree {err_spec} differs from the grads' {spec}")
    out = [one(g, e) for g, e in zip(leaves, err_leaves)]
    return (tree_unflatten([o[0] for o in out], spec),
            tree_unflatten([o[1] for o in out], spec))
