"""The JAX package's parameter trees, as numpy arrays, into the port's
modules: the same weights on both sides, so a test (or a user moving a
checkpoint) compares like with like.  Arrays may be any float numpy
type the JAX package hands out (bf16 included); they are cast to the
config's dtype on ``device``."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import Topology, shard_slices
from repro_torch.models.gnn.dimenet import DimeNetConfig
from repro_torch.models.gnn.egnn import EGNNConfig
from repro_torch.models.gnn.gin import GINConfig
from repro_torch.models.gnn.mace import _BIS_COMBOS, MACEConfig
from repro_torch.models.lm import LM, LMConfig, layer_shapes
from repro_torch.models.mind import MIND, MINDConfig


def _tensor(a, dtype, device) -> torch.Tensor:
    # via f32: numpy bf16 (ml_dtypes) has no torch counterpart, and
    # every bf16 value is exact in f32
    return torch.tensor(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype)


def lm_params_from_numpy(tree: dict, cfg: LMConfig, device=None, topo=None) -> LM:
    """``tree`` as the JAX package's ``models/lm.py::init_params``
    lays it out: ``embed``, ``layers`` (each array stacked over a
    leading layer axis; GQA's or MLA's attention weights, the dense
    MLP's or the MoE's), ``final_norm`` and ``lm_head``, which a tree
    with tied embeddings lacks.  With a ``topo`` of more than one rank,
    ``tree`` holds this rank's blocks (:func:`shard_tree`)."""
    dev, dt = resolve_device(device), cfg.dtype
    stacked = tree["layers"]
    if set(stacked) != set(layer_shapes(cfg)):
        raise ValueError(f"layer weights {sorted(stacked)} do not match "
                         f"{sorted(layer_shapes(cfg))}")
    layers = [{name: _tensor(a[li], dt, dev) for name, a in stacked.items()}
              for li in range(cfg.n_layers)]
    if ("lm_head" in tree) == cfg.tie_embeddings:
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings}, but the tree "
                         f"{'has' if 'lm_head' in tree else 'lacks'} an lm_head")
    head = None if cfg.tie_embeddings else _tensor(tree["lm_head"], dt, dev)
    return LM(cfg, _tensor(tree["embed"], dt, dev), layers,
              _tensor(tree["final_norm"], dt, dev), head, topo=topo)


def shard_tree(tree, specs, topo: Topology):
    """This rank's blocks of a tree in the JAX package's layout (numpy
    arrays or tensors), each cut by its spec in ``specs`` (a tree of the
    same keys: ``lm.param_specs``, ``lm.cache_specs``, and for a train
    state ``optimizer.state_specs``, whose step is whole): new arrays of
    the leaves' type.  A split dimension must be a multiple of its
    blocks."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], topo) for k, v in tree.items()}
    block = tree[(..., *shard_slices(tree.shape, specs, topo))]
    return block.copy() if isinstance(block, np.ndarray) else block.clone()


def _placed(blocks: list, specs, topo: Topology, out):
    """``out`` (the whole leaf's shape) with every rank's block written
    at its place; where ranks hold the same block, rank order's last."""
    spec = tuple(specs) + (None,) * (len(out.shape) - len(specs))
    for r, b in enumerate(blocks):
        at = Topology(grid=topo.grid, dp_axes=topo.dp_axes, tp_axis=topo.tp_axis, rank=r)
        out[(..., *shard_slices(out.shape, spec, at))] = b
    return out


def _whole_shape(block_shape, specs, topo: Topology) -> tuple:
    spec = tuple(specs) + (None,) * (len(block_shape) - len(specs))
    return tuple(n * topo.factor(e) for n, e in zip(block_shape, spec))


def unshard_tree(blocks: list, specs, topo: Topology):
    """The whole tree from every rank's blocks (``blocks[r]`` rank r's,
    as :func:`shard_tree` cuts them or a sharded step returns them), a
    numpy array a leaf; where ranks hold the same block (a dim not split
    over their axes), rank order's last is kept, so callers compare
    replicas themselves."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: unshard_tree([b[k] for b in blocks], specs[k], topo) for k in first}
    out = np.zeros(_whole_shape(np.shape(first), specs, topo), dtype=np.float32)
    return _placed([b.detach().cpu().float().numpy() if isinstance(b, torch.Tensor) else b
                    for b in blocks], specs, topo, out)


def unshard_tensor(blocks: list, specs, topo: Topology) -> torch.Tensor:
    """One leaf whole from every rank's blocks of it (tensors on one
    device), a tensor of their dtype: :func:`unshard_tree`'s placement
    for a checkpoint, which keeps bf16 and int leaves as they are."""
    first = blocks[0]
    out = first.new_empty(_whole_shape(first.shape, specs, topo))
    return _placed(blocks, specs, topo, out)


def lm_tree_from_numpy(tree: dict, cfg: LMConfig, device=None) -> dict:
    """``tree`` as the JAX package's ``models/lm.py::init_params`` lays
    it out, as the port's training tree (``models/lm.py::params_tree``):
    the same keys and the same stacked shapes, each leaf in the config's
    dtype on ``device``; shapes are checked against ``cfg``."""
    dev, dt = resolve_device(device), cfg.dtype
    want = {"embed": (cfg.vocab, cfg.d_model),
            "layers": {name: (cfg.n_layers,) + shape
                       for name, (shape, _) in layer_shapes(cfg).items()},
            "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        want["lm_head"] = (cfg.d_model, cfg.vocab)
    return _checked(tree, want, "", dev, dt)


def tree_to_numpy(tree):
    """A tree of tensors (nested dicts and lists) as numpy arrays, each
    as f32 (bf16 included, exactly) or its own dtype for the others: what
    the JAX package's functions take back."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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


def mind_tree_from_numpy(tree: dict, cfg: MINDConfig, device=None) -> dict:
    """``tree`` as the JAX package's ``models/mind.py::init_params`` lays
    it out, as the port's training tree (``models/mind.py::params_tree``):
    the same keys and shapes, f32 on ``device``; shapes are checked
    against ``cfg``."""
    d = cfg.embed_dim
    want = {"item_table": (cfg.n_items, d), "profile_table": (cfg.n_profile, d),
            "bilinear": (d, d), "routing_init": (cfg.n_interests,),
            "interest_mlp": _mlp_shapes([2 * d, d, d])}
    return _checked(tree, want, "", resolve_device(device))


def _mlp_shapes(dims) -> dict:
    want = {f"w{i}": (dims[i], dims[i + 1]) for i in range(len(dims) - 1)}
    return want | {f"b{i}": (dims[i + 1],) for i in range(len(dims) - 1)}


def _checked(tree, want, where: str, device, dtype=torch.float32):
    """``tree`` (nested dicts and lists of arrays) as ``dtype`` tensors
    on ``device``, after checking that it has exactly ``want``'s keys,
    lengths and shapes (``want`` mirrors it, shape tuples at the
    leaves)."""
    if isinstance(want, tuple):
        if tuple(np.shape(tree)) != want:
            raise ValueError(f"{where}: shape {tuple(np.shape(tree))} does not match {want}")
        return _tensor(tree, dtype, device)
    if isinstance(want, list):
        if len(tree) != len(want):
            raise ValueError(f"{where}: {len(tree)} entries, config has {len(want)}")
        return [_checked(t, w, f"{where}[{i}]", device, dtype)
                for i, (t, w) in enumerate(zip(tree, want))]
    if set(tree) != set(want):
        raise ValueError(f"{where}: keys {sorted(tree)} do not match {sorted(want)}")
    return {k: _checked(tree[k], w, f"{where}.{k}".lstrip("."), device, dtype)
            for k, w in want.items()}


def gin_params_from_numpy(tree: dict, cfg: GINConfig, device=None) -> dict:
    """``tree`` as the JAX package's ``models/gnn/gin.py::init_params``
    lays it out: ``layers[i].mlp.{w0,b0,w1,b1}``, ``layers[i].eps`` and
    ``readout.{w0,b0}``; f32 throughout.  Shapes are checked against
    ``cfg``."""
    dev, f32 = resolve_device(device), torch.float32
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers, config has {cfg.n_layers}")
    layers = []
    for i, lp in enumerate(tree["layers"]):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        layers.append({
            "mlp": _checked(lp["mlp"], _mlp_shapes([d_in, cfg.d_hidden, cfg.d_hidden]),
                            f"layers[{i}].mlp", dev),
            "eps": _tensor(lp["eps"], f32, dev).reshape(()),
        })
    return {"layers": layers,
            "readout": _checked(tree["readout"], _mlp_shapes([cfg.d_hidden, cfg.n_classes]),
                                "readout", dev)}


def _readout(d: int, n_classes: int) -> dict:
    return _mlp_shapes([d, d, n_classes if n_classes > 0 else 1])


def egnn_params_from_numpy(tree: dict, cfg: EGNNConfig, device=None) -> dict:
    """``tree`` as the JAX package's ``models/gnn/egnn.py::init_params``
    lays it out: ``layers[i].{phi_e, phi_x, phi_h}`` and ``readout``
    (MLPs of ``w{i}``, ``b{i}``); f32, shapes checked against ``cfg``."""
    d = cfg.d_hidden
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else d
        layers.append({"phi_e": _mlp_shapes([2 * d_in + 1, d, d]),
                       "phi_x": _mlp_shapes([d, d, 1]),
                       "phi_h": _mlp_shapes([d_in + d, d, d])})
    want = {"layers": layers, "readout": _readout(d, cfg.n_classes)}
    return _checked(tree, want, "", resolve_device(device))


def mace_params_from_numpy(tree: dict, cfg: MACEConfig, device=None) -> dict:
    """``tree`` as the JAX package's ``models/gnn/mace.py::init_params``
    lays it out: ``layers[i].{w_h, radial, update}`` and ``readout``;
    f32, shapes checked against ``cfg``."""
    C, n_l = cfg.d_hidden, cfg.l_max + 1
    n_inv = 1 + n_l + len(_BIS_COMBOS)
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else C
        layers.append({"w_h": (d_in, C), "radial": _mlp_shapes([cfg.n_rbf, 32, C * n_l]),
                       "update": _mlp_shapes([C * n_inv + d_in, C, C])})
    want = {"layers": layers, "readout": _readout(C, cfg.n_classes)}
    return _checked(tree, want, "", resolve_device(device))


def dimenet_params_from_numpy(tree: dict, cfg: DimeNetConfig, device=None) -> dict:
    """``tree`` as the JAX package's ``models/gnn/dimenet.py::init_params``
    lays it out: ``blocks[i].{w_rbf, w_sbf, w_kj, bilinear, mlp_update,
    out_atom}`` (``bilinear`` (nb, d, d); ``w_kj`` and ``out_atom`` MLPs
    of one layer, ``mlp_update`` of two), ``embed_atom``, ``embed_edge``
    and ``readout``; f32, shapes checked against ``cfg``."""
    d, nb = cfg.d_hidden, cfg.n_bilinear
    block = {"w_rbf": (cfg.n_radial, d), "w_sbf": (cfg.n_radial * cfg.n_spherical, nb),
             "w_kj": _mlp_shapes([d, d]), "bilinear": (nb, d, d),
             "mlp_update": _mlp_shapes([d, d, d]), "out_atom": _mlp_shapes([d, d])}
    want = {"blocks": [block] * cfg.n_blocks,
            "embed_atom": _mlp_shapes([cfg.d_in, d]),
            "embed_edge": _mlp_shapes([2 * d + cfg.n_radial, d]),
            "readout": _readout(d, cfg.n_classes)}
    return _checked(tree, want, "", resolve_device(device))
