"""The JAX package's parameter trees, as numpy arrays, into the port's
modules: the same weights on both sides, so a test (or a user moving a
checkpoint) compares like with like.  Arrays may be any float numpy
type the JAX package hands out (bf16 included); they are cast to the
config's dtype on ``device``."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn.gin import GINConfig
from repro_torch.models.lm import LM, LMConfig, layer_shapes
from repro_torch.models.mind import MIND, MINDConfig


def _tensor(a, dtype, device) -> torch.Tensor:
    # via f32: numpy bf16 (ml_dtypes) has no torch counterpart, and
    # every bf16 value is exact in f32
    return torch.tensor(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype)


def lm_params_from_numpy(tree: dict, cfg: LMConfig, device=None) -> LM:
    """``tree`` as the JAX package's ``models/lm.py::init_params``
    lays it out: ``embed``, ``layers`` (each array stacked over a
    leading layer axis), ``final_norm`` and ``lm_head``."""
    dev, dt = resolve_device(device), cfg.dtype
    stacked = tree["layers"]
    if set(stacked) != set(layer_shapes(cfg)):
        raise ValueError(f"layer weights {sorted(stacked)} do not match "
                         f"{sorted(layer_shapes(cfg))}")
    layers = [{name: _tensor(a[li], dt, dev) for name, a in stacked.items()}
              for li in range(cfg.n_layers)]
    return LM(cfg, _tensor(tree["embed"], dt, dev), layers,
              _tensor(tree["final_norm"], dt, dev),
              _tensor(tree["lm_head"], dt, dev))


def mind_params_from_numpy(tree: dict, cfg: MINDConfig, device=None) -> MIND:
    """``tree`` as the JAX package's ``models/mind.py::init_params``
    lays it out (f32 throughout)."""
    dev, f32 = resolve_device(device), torch.float32
    return MIND(
        cfg,
        item_table=_tensor(tree["item_table"], f32, dev),
        profile_table=_tensor(tree["profile_table"], f32, dev),
        bilinear=_tensor(tree["bilinear"], f32, dev),
        routing_init=_tensor(tree["routing_init"], f32, dev),
        interest_mlp={k: _tensor(v, f32, dev) for k, v in tree["interest_mlp"].items()},
    )


def gin_params_from_numpy(tree: dict, cfg: GINConfig, device=None) -> dict:
    """``tree`` as the JAX package's ``models/gnn/gin.py::init_params``
    lays it out: ``layers[i].mlp.{w0,b0,w1,b1}``, ``layers[i].eps`` and
    ``readout.{w0,b0}``; f32 throughout.  Shapes are checked against
    ``cfg``."""
    dev, f32 = resolve_device(device), torch.float32

    def mlp(p, dims, where):
        want = {f"w{i}": (dims[i], dims[i + 1]) for i in range(len(dims) - 1)}
        want |= {f"b{i}": (dims[i + 1],) for i in range(len(dims) - 1)}
        got = {k: tuple(np.shape(v)) for k, v in p.items()}
        if got != want:
            raise ValueError(f"{where}: shapes {got} do not match {want}")
        return {k: _tensor(v, f32, dev) for k, v in p.items()}

    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers, config has {cfg.n_layers}")
    layers = []
    for i, lp in enumerate(tree["layers"]):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        layers.append({
            "mlp": mlp(lp["mlp"], [d_in, cfg.d_hidden, cfg.d_hidden], f"layers[{i}].mlp"),
            "eps": _tensor(lp["eps"], f32, dev).reshape(()),
        })
    return {"layers": layers,
            "readout": mlp(tree["readout"], [cfg.d_hidden, cfg.n_classes], "readout")}
